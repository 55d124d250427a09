"""recurrentgemma-2b: the hybrid arch (RG-LRU + local MQA attention), the
port's copy of ``repro.configs.recurrentgemma_2b``."""

import dataclasses

from repro_torch.configs import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    attn_window=2048,                      # local attention
    block_pattern=("rec", "rec", "attn"),  # Griffin 2:1 pattern
    rglru=RGLRUConfig(d_rnn=2560),
    ctx_parallel_attn=True,
    sub_quadratic=True,
    notes="RG-LRU + local attn 1:2 [arXiv:2402.19427; hf].",
)
SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=2, num_kv_heads=1,
    d_ff=128, vocab_size=256, head_dim=32, attn_window=32,
    rglru=RGLRUConfig(d_rnn=64))
