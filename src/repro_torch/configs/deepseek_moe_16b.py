"""deepseek-moe-16b: the port's copy of ``repro.configs.deepseek_moe_16b``
(2 shared and 64 routed top-6 experts a layer, every layer routed, as the
repo's config has it)."""

import dataclasses

from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, capacity_factor=1.25, group_size=256),
    notes="2 shared + 64 routed top-6 fine-grained [arXiv:2401.06066; hf]. "
          "Small dispatch groups (256) keep the GShard dispatch-einsum "
          "overhead <8% of expert FLOPs at d_ff_expert=1408.",
)
SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=64, vocab_size=256, head_dim=0,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                  num_shared_experts=2, group_size=64))
