"""falcon-mamba-7b — assigned architecture config (see configs/__init__ for
fields): 64 mixer-only Mamba-1 blocks (``models/mamba.py``), attention-free;
dt_rank resolves to ceil(4096 / 16) = 256. 7.27 B parameters."""

import dataclasses

from repro_torch.configs import ArchConfig, MambaConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024, head_dim=0,
    block_pattern=("ssm",),
    mamba=MambaConfig(d_inner=8192, ssm_state=16, conv_kernel=4),
    sub_quadratic=True,
    notes="mamba1 arch, attention-free [arXiv:2410.05355; unverified].",
)
SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, vocab_size=256,
    mamba=MambaConfig(d_inner=128, ssm_state=4, conv_kernel=4))
