"""Architecture configs of the port (counterpart of ``repro.configs``).

``get_config(id)`` returns an arch's full config and ``smoke_config(id)`` its
reduced same-family variant for CPU tests. The port carries every arch of
``ARCHS``: the four dense attention-only archs, the hybrid
recurrentgemma-2b, the two MoE archs, the ssm falcon-mamba-7b, the vlm
llava-next-34b and the encoder hubert-xlarge (both fed precomputed
``FRONTEND_DIM``-wide embeddings by their stub frontends).
``arch_config(id)`` reads an arch's full config for the arithmetic on it
(``param_count``, the roofline of ``perf/roofline.py``).
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

    The JAX config's three sharding fields are kept with its values and
    read by ``distributed/sharding.py`` on a training mesh: ``fsdp`` (shard
    every parameter's embed dim over the data axis too, ZeRO-3),
    ``sharding_profile`` ("tp_sp", or "fsdp": no tensor parallelism, batch
    and params over (data, model), taken only with ``fsdp`` as well) and
    ``ctx_parallel_attn`` (shard attention's query rows over the model axis
    where the heads do not divide it: the rules' ``seq_full``, which
    ``distributed/parallel.ShardPlan`` carries out in training and in the
    serving prefill, each rank computing every head for its ``S / model``
    query rows against the whole sequence's K/V). JAX's ``scan_layers`` has no
    counterpart (the port loops over its layers); ``remat`` checkpoints each
    layer in training; ``dtype`` is a torch dtype.
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
    fsdp: bool = False               # shard params over the data axis too (ZeRO-3)
    sharding_profile: str = "tp_sp"  # "tp_sp" or "fsdp" (no TP; with fsdp only)
    ctx_parallel_attn: bool = False  # shard attention queries over model where
                                     # the heads do not divide it (seq_full)
    sub_quadratic: bool = False      # eligible for the dry run's long_500k
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

    def param_count(self) -> int:
        """Approximate N for MODEL_FLOPS (embedding included once)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d * 2  # embed + head (untied)
        att = d * self.num_heads * self.head_dim * 2 \
            + d * self.num_kv_heads * self.head_dim * 2
        mlp = 3 * d * self.d_ff if self.mlp_type == "gated_silu" \
            else 2 * d * self.d_ff
        if self.moe:
            m = self.moe
            mlp = m.num_experts * 3 * d * m.d_ff_expert + d * m.num_experts \
                + m.num_shared_experts * 3 * d * m.d_ff_expert
        rec = 0
        if self.rglru:
            dr = self.rglru.d_rnn
            rec = 3 * d * dr + 2 * dr * dr + 4 * dr
        if self.mamba:
            mc = self.mamba
            rec = 3 * d * mc.d_inner + mc.d_inner * (
                2 * mc.ssm_state + 2 * mc.dt_rank + mc.ssm_state)
        total = 0
        for i in range(L):
            kind = self.block_pattern[i % len(self.block_pattern)]
            total += {"attn": att + mlp, "rec": rec + mlp,
                      "ssm": rec}[kind] + 2 * d
        return n + total

    def active_param_count(self) -> int:
        """N_active for MoE MODEL_FLOPS."""
        if not self.moe:
            return self.param_count()
        m = self.moe
        d, L = self.d_model, self.num_layers
        att = d * self.num_heads * self.head_dim * 2 \
            + d * self.num_kv_heads * self.head_dim * 2
        mlp_active = (m.top_k + m.num_shared_experts) * 3 * d * m.d_ff_expert
        return (self.vocab_size * d * 2
                + L * (att + mlp_active + d * m.num_experts + 2 * d))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the dry run (JAX's ``ShapeConfig``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCHS = [
    "llava_next_34b", "granite_3_2b", "qwen3_14b", "deepseek_67b",
    "deepseek_coder_33b", "hubert_xlarge", "dbrx_132b", "deepseek_moe_16b",
    "recurrentgemma_2b", "falcon_mamba_7b",
]


def _module(name: str):
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_')}")


def arch_config(name: str) -> ArchConfig:
    """The full config of any arch of ``ARCHS`` (parameter counts and
    rooflines need no model)."""
    return _module(name).CONFIG


def get_config(name: str) -> ArchConfig:
    """The full config of arch ``name``."""
    return _module(name).CONFIG


def smoke_config(name: str) -> ArchConfig:
    """The reduced same-family config of arch ``name`` (CPU tests)."""
    return _module(name).SMOKE


def cells(arch: ArchConfig):
    """The (shape → (runnable, skip reason)) map for one arch (JAX's)."""
    out = {}
    for sname, sh in SHAPES.items():
        if sh.kind == "decode" and not arch.has_decode:
            out[sname] = (False, "encoder-only: no autoregressive decode step")
        elif sname == "long_500k" and not arch.sub_quadratic:
            out[sname] = (False, "pure full-attention arch: 500k decode "
                                 "assigned to SSM/hybrid archs only")
        else:
            out[sname] = (True, "")
    return out
