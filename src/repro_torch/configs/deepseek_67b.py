"""deepseek-67b — assigned architecture config (see configs/__init__ for fields)."""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=102400,
    fsdp=True,
    sharding_profile="fsdp",
    notes="llama-arch dense 67B [arXiv:2401.02954; hf].",
)
SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=0, fsdp=False)
