"""AdamW with f32 master state over (possibly bf16) params (counterpart of
``repro.optim.adamw``).

The state mirrors the parameters by name (``LM.named_parameters()``): f32
first and second moments ``m``/``v`` and, with ``keep_master``, an f32
master copy from which the parameters are cast after every update. Global-
norm clipping, bias correction and decoupled weight decay on every leaf are
as in JAX. Unlike JAX, which returns new trees, :func:`adamw_update` works
**in place**, leaf by leaf: the gradients are scaled in place and each
leaf's temporaries are freed before the next, so an update at full width
(granite-3-2b: 10.5 GB a tree in f32) adds no second tree of state.

On a training mesh every tensor is the rank's shard and the update is
elementwise, so it runs on the shard as it is; only the global norm of the
clipping needs the mesh: ``plan`` (a ``distributed.parallel.ShardPlan``)
sums each leaf's squares over the axes the leaf is sharded over and counts
a replicated leaf once, so clipping sees the single-device norm.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch
from torch import nn

from repro_torch.distributed.collectives import all_reduce_


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """Hyper-parameters, as ``repro.optim.AdamWConfig``."""
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    keep_master: bool = True  # f32 master copy of the params


@dataclasses.dataclass
class AdamWState:
    """``step`` (updates taken), and per-parameter-name f32 tensors ``m``,
    ``v`` and ``master`` (None without ``keep_master``)."""
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    master: Optional[Dict[str, torch.Tensor]]


@torch.no_grad()
def adamw_init(params: nn.Module, cfg: AdamWConfig) -> AdamWState:
    """Zero moments and (with ``keep_master``) an f32 copy of every param."""
    named = dict(params.named_parameters())
    zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()}
    master = ({n: p.detach().to(torch.float32, copy=True) for n, p in named.items()}
              if cfg.keep_master else None)
    return AdamWState(step=0, m=zeros,
                      v={n: torch.zeros_like(z) for n, z in zeros.items()},
                      master=master)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(torch.stack([t.float().square().sum() for t in tensors]).sum())


def mesh_global_norm(grads: Dict[str, torch.Tensor], plan) -> torch.Tensor:
    """:func:`global_norm` of the full tree whose shards ``grads`` are on
    ``plan``'s mesh: each leaf's sum of squares summed over the axes it is
    sharded over (one all-reduce a set of axes), every replicated leaf
    counted once. Equal on every rank."""
    sums: Dict[tuple, list] = {}
    for n, g in grads.items():
        sums.setdefault(plan.norm_entry(n), []).append(g.float().square().sum())
    total = 0.0
    for entry, parts in sums.items():
        total = total + all_reduce_(torch.stack(parts).sum(), plan.mesh, entry)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        plan=None):
    """Scale every gradient (in place, as f32) by ``min(1, max_norm / (norm
    + 1e-9))``; returns (grads, norm before clipping). ``plan``: the
    gradients are shards on its mesh (:func:`mesh_global_norm`)."""
    norm = (global_norm(grads.values()) if plan is None
            else mesh_global_norm(grads, plan))
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for n, g in grads.items():
        grads[n] = g.float().mul_(scale)
    return grads, norm


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: nn.Module, cfg: AdamWConfig, lr=None, plan=None):
    """One AdamW step in place. ``grads`` maps parameter names to gradients
    (consumed: scaled in place). Returns (params, state, {"grad_norm"}).
    ``plan``: params, grads and state are shards on its mesh."""
    lr = cfg.lr if lr is None else lr
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, plan)
    state.step += 1
    b1c = 1.0 - cfg.b1 ** state.step
    b2c = 1.0 - cfg.b2 ** state.step
    for name, p in params.named_parameters():
        g = grads.pop(name)
        m, v = state.m[name], state.v[name]
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        if cfg.keep_master:
            base = state.master[name]
        else:
            base = p.data if p.dtype == torch.float32 else p.detach().float()
        u = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        u.add_(base, alpha=cfg.weight_decay)
        base.add_(u, alpha=-lr)
        del u
        if base.data_ptr() != p.data_ptr():
            p.copy_(base)                     # new params cast from the master
    return params, state, {"grad_norm": gnorm}
