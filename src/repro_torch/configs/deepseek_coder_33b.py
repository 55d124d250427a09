"""deepseek-coder-33b — assigned architecture config (see configs/__init__ for fields)."""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=19200, vocab_size=32256,
    fsdp=True,
    ctx_parallel_attn=True,
    notes="llama-arch dense 33B [arXiv:2401.14196; hf]",
)
SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=0, fsdp=False)
