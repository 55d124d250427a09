"""Logical-axis sharding rules with divisibility fallback (counterpart of
``repro.distributed.sharding``).

Parameters and activations carry *logical* axis names
(``models.lm.param_specs``); the rules map them onto the axes of a mesh
(``pod``, ``data``, ``model``, any of them) per architecture and record
every fallback they take. The rule sets are JAX's:

  batch        → (pod, data)  [data parallel]
  seq          → model        [sequence parallelism between layers]
  heads/mlp/vocab/experts/rnn → model  [tensor parallel], iff divisible
  embed (param dim) → data when cfg.fsdp  [FSDP / ZeRO-3]

and the full ZeRO-3 profile (:func:`_fsdp_rules`: no tensor parallelism,
params and batch jointly over (data, model)) replaces them only when the
config opts in with ``fsdp=True`` *and* selects ``sharding_profile="fsdp"``
(:func:`uses_fsdp_profile`).

The rules read nothing of a mesh but its axis sizes: ``mesh`` is any object
with a ``shape`` mapping (axis name → size), such as
``distributed.mesh.TrainMesh``. A spec is a tuple with one entry a dim:
``None`` (replicated), an axis name, or a tuple of axis names (the dim
split over their product, the first the slowest).

JAX's ``constrain`` (an activation sharding constraint that GSPMD turns
into collectives) has no eager counterpart: the port's training step
carries the specs out itself (``distributed.parallel.ShardPlan``: the
collectives around the tensor-parallel layers, the gathers of
FSDP-sharded weights and the reduction of gradients).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class ShardingRules:
    """A logical name → mesh axis (or None) mapping on ``mesh``, and the
    fallbacks :meth:`spec_for` took."""
    mesh: Any
    rules: Dict[str, Any]
    fallbacks: Dict[str, str] = dataclasses.field(default_factory=dict)

    def spec_for(self, logical_axes: Tuple[Optional[str], ...],
                 shape: Optional[Tuple[int, ...]] = None) -> tuple:
        """Map logical axes to a spec, replicating a dim that its axis does
        not divide (recorded in ``fallbacks``); a mesh axis appears at most
        once in a spec (the later dims that would reuse it replicate)."""
        parts = []
        for i, name in enumerate(logical_axes):
            axis = self.rules.get(name) if name else None
            if axis is None:
                parts.append(None)
                continue
            size = axis_size(self.mesh, axis)
            if shape is not None and shape[i] % size != 0:
                self.fallbacks[f"{name}[{shape[i]}]"] = (
                    f"not divisible by {axis}={size} → replicated")
                parts.append(None)
            else:
                parts.append(axis)
        seen = set()
        clean = []
        for p_ in parts:
            names = p_ if isinstance(p_, tuple) else (p_,)
            if p_ is not None and any(n in seen for n in names):
                clean.append(None)
            else:
                clean.append(p_)
                seen.update(n for n in names if n)
        return tuple(clean)

    def tree_specs(self, shapes: Dict[str, Tuple[int, ...]],
                   logical: Dict[str, Tuple[Optional[str], ...]]) -> Dict[str, tuple]:
        """``{name: spec}`` for ``{name: shape}`` and ``{name: logical axes}``."""
        return {n: self.spec_for(tuple(logical[n]), tuple(s))
                for n, s in shapes.items()}


def axis_size(mesh, axis) -> int:
    """The size of a mesh axis, or the product over a tuple of them."""
    if isinstance(axis, tuple):
        size = 1
        for a in axis:
            size *= mesh.shape[a]
        return size
    return mesh.shape[axis]


def default_rules(mesh, cfg, *, serve: bool = False,
                  decode: bool = False) -> ShardingRules:
    """Per-arch logical → mesh mapping (JAX's, entry for entry).

    One rule set covers training and serving: non-divisible dims fall back
    to replication, and the spec builder never assigns one mesh axis twice.
    ``decode`` keeps FSDP out of the decode step and, where the kv heads do
    not divide the model axis, replicates the q activations and shards the
    projections on their fused (heads · head_dim) dim instead."""
    dp: Any = tuple(a for a in ("pod", "data") if a in mesh.shape) or None
    if dp is not None and len(dp) == 1:
        dp = dp[0]
    tp = "model" if "model" in mesh.shape else None

    if not serve and uses_fsdp_profile(cfg):
        return _fsdp_rules(mesh, cfg)

    rules: Dict[str, Any] = {
        # activations
        "batch": dp,
        "seq": tp,            # sequence-parallel residuals between layers
        "seq_full": None,     # inside attention: the full sequence a device
        "heads": tp,
        "kv_heads": tp,
        "head_dim": None,
        "moe_groups": dp,
        # params
        "vocab": tp,
        "embed": None,
        "mlp": tp,
        "expert_mlp": None,   # an expert's FFN dim stays local (E is sharded)
        "q_proj": tp,
        "kv_proj": tp,
        "experts": tp,
        "rnn": tp,
        "state": None,
        "layers": None,       # JAX's stacked-scan leading dim
        "kv_cache_seq": tp,   # long-KV decode: the cache's sequence sharded
                              # where the kv heads cannot be
    }
    if (cfg is not None and getattr(cfg, "fsdp", False) and not decode
            and "data" in mesh.shape):
        # FSDP: weights gathered a layer at a time; training and prefill only
        rules["embed"] = "data"
    if decode and tp is not None and cfg is not None and cfg.num_kv_heads \
            and cfg.num_kv_heads % axis_size(mesh, tp) != 0:
        # distributed flash-decode: the cache is sequence-sharded; q stays
        # replicated, the projections shard on their fused dim
        rules["heads"] = None
        rules["q_proj"] = tp
        rules["kv_proj"] = tp
    tp_size = axis_size(mesh, tp) if tp else 1
    if cfg is not None and cfg.num_heads:
        if cfg.num_heads % tp_size != 0:
            # heads not divisible: replicate the head projections
            rules["heads"] = None
            rules["q_proj"] = None
            if getattr(cfg, "ctx_parallel_attn", False):
                # context parallelism: attention's query rows over model
                rules["seq_full"] = tp
        if cfg.num_kv_heads % tp_size != 0:
            rules["kv_heads"] = None
            rules["kv_proj"] = None
    return ShardingRules(mesh=mesh, rules=rules)


def _fsdp_rules(mesh, cfg) -> ShardingRules:
    """The FSDP / ZeRO-3 profile: no tensor parallelism. The batch shards
    over (data, model) jointly, and so does every parameter's embed dim
    (weights gathered a layer at a time, gradients reduce-scattered); pod
    stays a pure gradient replica."""
    fs: Any = tuple(a for a in ("data", "model") if a in mesh.shape) or None
    if fs is not None and len(fs) == 1:
        fs = fs[0]
    rules: Dict[str, Any] = {
        "batch": fs,
        "seq": None, "seq_full": None,
        "heads": None, "kv_heads": None, "head_dim": None,
        "moe_groups": fs,
        "vocab": None, "embed": fs,
        "mlp": None, "expert_mlp": None,
        "q_proj": None, "kv_proj": None,
        "experts": None, "rnn": None, "state": None,
        "layers": None,
        "kv_cache_seq": None,
    }
    return ShardingRules(mesh=mesh, rules=rules)


def uses_fsdp_profile(cfg) -> bool:
    """Whether ``cfg`` takes the ZeRO-3 profile from :func:`default_rules`:
    both ``sharding_profile="fsdp"`` and ``fsdp=True`` are required."""
    return (cfg is not None
            and getattr(cfg, "sharding_profile", "tp_sp") == "fsdp"
            and getattr(cfg, "fsdp", False))


def vocab_pad_for(mesh) -> int:
    """The vocab is padded to a multiple of the model axis."""
    return mesh.shape.get("model", 1)
