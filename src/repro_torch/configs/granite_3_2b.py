"""granite-3-2b — assigned architecture config (see configs/__init__ for fields)."""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=49155,
    sharding_profile="fsdp",   # annotation only: without fsdp=True the rules keep TP
    notes="GQA dense decoder [hf:ibm-granite/granite-3.0-2b-base; hf].",
)
SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=251, head_dim=0)
