"""llava-next-34b — assigned architecture config (see configs/__init__ for
fields)."""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    frontend="vision",   # anyres patch embeddings provided by the stub frontend
    fsdp=True,
    ctx_parallel_attn=True,
    notes="decoder LM backbone of LLaVA-NeXT-34B "
          "[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
)
SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=0, fsdp=False)
