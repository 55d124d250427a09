"""hubert-xlarge — assigned architecture config (see configs/__init__ for
fields)."""

import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False,                 # encoder-only: no decode shapes
    frontend="audio",             # frame embeddings provided by the stub
    mlp_type="gelu",
    sharding_profile="fsdp",   # annotation only: without fsdp=True the rules keep TP
    notes="encoder-only audio backbone, w2v2 arch [arXiv:2106.07447; "
          "unverified]. head_dim=80. Loss = masked-unit CE over 504 units.",
)
SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=63, head_dim=0)
