"""Architecture configs of the port (counterpart of ``repro.configs``).

``get_config(id)`` returns an arch's full config and ``smoke_config(id)`` its
reduced same-family variant for CPU tests. This slice carries the four dense
attention-only archs; the other families of ``ARCHS`` come with their models
and are named in ``UNPORTED_FAMILIES`` until then.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN settings."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    group_size: int = 512


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """Real-gated linear recurrent unit settings."""
    d_rnn: int


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Mamba selective-SSM settings."""
    d_inner: int
    ssm_state: int = 16
    conv_kernel: int = 4
    dt_rank: int = 0  # 0 → ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture; fields as in ``repro.configs.ArchConfig``.

    The sharding fields of the JAX config (fsdp, sharding profile, context
    parallelism, scan) have no counterpart on one device and are left out;
    ``remat`` checkpoints each layer in training; ``dtype`` is a torch dtype.
    """
    name: str
    family: str                      # dense | moe | hybrid | ssm | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads
    qk_norm: bool = False
    causal: bool = True
    attn_window: Optional[int] = None
    block_pattern: Tuple[str, ...] = ("attn",)   # cycled over layers
    moe: Optional[MoEConfig] = None
    rglru: Optional[RGLRUConfig] = None
    mamba: Optional[MambaConfig] = None
    frontend: Optional[str] = None
    mlp_type: str = "gated_silu"
    dropout_rate: float = 0.0
    remat: bool = True               # checkpoint each layer in training
    dtype: Any = torch.bfloat16
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.mamba is not None and self.mamba.dt_rank == 0:
            object.__setattr__(self, "mamba", dataclasses.replace(
                self.mamba, dt_rank=-(-self.d_model // 16)))

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs have no autoregressive step."""
        return self.causal


ARCHS = [
    "llava_next_34b", "granite_3_2b", "qwen3_14b", "deepseek_67b",
    "deepseek_coder_33b", "hubert_xlarge", "dbrx_132b", "deepseek_moe_16b",
    "recurrentgemma_2b", "falcon_mamba_7b",
]

#: archs of ``ARCHS`` whose family the port does not run yet → that family
UNPORTED_FAMILIES = {
    "llava_next_34b": "vlm", "hubert_xlarge": "encoder", "dbrx_132b": "moe",
    "deepseek_moe_16b": "moe", "recurrentgemma_2b": "hybrid",
    "falcon_mamba_7b": "ssm",
}


def _module(name: str):
    name = name.replace("-", "_")
    if name in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"{name}: the {UNPORTED_FAMILIES[name]} family is not yet ported "
            f"to repro_torch (dense attention-only archs only)")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ArchConfig:
    """The full config of arch ``name``."""
    return _module(name).CONFIG


def smoke_config(name: str) -> ArchConfig:
    """The reduced same-family config of arch ``name`` (CPU tests)."""
    return _module(name).SMOKE
