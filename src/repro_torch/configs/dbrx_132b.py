"""dbrx-132b: the port's copy of ``repro.configs.dbrx_132b`` (16 experts,
top 4, no shared expert)."""

import dataclasses

from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752,
                  capacity_factor=1.25, group_size=512),
    fsdp=True,
    notes="16 experts top-4 fine-grained [hf:databricks/dbrx-base; "
          "unverified]. Experts shard 1/device on the 16-way model axis.",
)
SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=0, fsdp=False,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32, group_size=64))
