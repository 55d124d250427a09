"""qwen3-14b — assigned architecture config (see configs/__init__ for fields)."""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=17408, vocab_size=151936, head_dim=128,
    qk_norm=True,
    fsdp=True,
    ctx_parallel_attn=True,
    notes="qk-norm + GQA [hf:Qwen/Qwen3-8B; hf].",
)
SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16)
