"""Online-softmax state algebra (paper Eq. 2/3, after FA/FA2) in torch.

The state of a partially-computed softmax-weighted sum over a row is the
triple ``(m, l, acc)``:

    m   : running row max of the scores seen so far            (f32)
    l   : running sum of exp(score - m)                        (f32)
    acc : running sum of exp(score - m) @ V                    (f32)

Two states over disjoint score blocks merge associatively (paper Eq. 3) and
the finished row is ``acc / l`` with log-sum-exp ``lse = m + log l``. The
plain-torch kernel versions, the chunked attention path and the split-KV
decode merge all use these functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# sparklint: disable=shared-mask-constant -- the port's one definition site, twin of repro.core.online_softmax.NEG_INF (the port imports nothing of repro); finite on purpose so exp() stays NaN-free
NEG_INF = -1e30


class SoftmaxState(NamedTuple):
    """``(m [..., rows], l [..., rows], acc [..., rows, d])``, all f32."""
    m: torch.Tensor
    l: torch.Tensor
    acc: torch.Tensor


def init_state(rows_shape, d: int, *, device,
               dtype=torch.float32) -> SoftmaxState:
    """The empty state: ``m = NEG_INF``, ``l = 0``, ``acc = 0``."""
    return SoftmaxState(
        m=torch.full(rows_shape, NEG_INF, dtype=dtype, device=device),
        l=torch.zeros(rows_shape, dtype=dtype, device=device),
        acc=torch.zeros((*rows_shape, d), dtype=dtype, device=device),
    )


def update(state: SoftmaxState, s: torch.Tensor,
           v: torch.Tensor) -> SoftmaxState:
    """Fold one block of scores ``s [..., rows, cols]`` and values ``v``."""
    m_new = torch.maximum(state.m, s.amax(dim=-1))
    alpha = torch.exp(state.m - m_new)
    # rows whose scores are all masked keep m == NEG_INF; exp(s - m) would be
    # exp(0) = 1 there. Shift by 0 instead so p == 0 and l stays 0.
    m_safe = torch.where(m_new == NEG_INF, torch.zeros_like(m_new), m_new)
    p = torch.exp(s - m_safe[..., None])
    l_new = state.l * alpha + p.sum(dim=-1)
    acc_new = state.acc * alpha[..., None] + p @ v.to(p.dtype)
    return SoftmaxState(m_new, l_new, acc_new)


def merge(s1: SoftmaxState, s2: SoftmaxState) -> SoftmaxState:
    """Associative merge of two disjoint-block states (paper Eq. 3)."""
    m = torch.maximum(s1.m, s2.m)
    a1 = torch.exp(s1.m - m)
    a2 = torch.exp(s2.m - m)
    return SoftmaxState(m=m, l=s1.l * a1 + s2.l * a2,
                        acc=s1.acc * a1[..., None] + s2.acc * a2[..., None])


def merge_many(state: SoftmaxState, axis: int = 0) -> SoftmaxState:
    """Merge N disjoint-block states stacked along ``axis`` in one shot.

    ``axis`` indexes ``m``/``l``; ``acc`` carries one extra trailing feature
    dim. All-empty stacks (every ``m == NEG_INF``) come out as the empty
    state, NaN-free, because NEG_INF is finite.
    """
    if axis < 0:
        axis += state.m.dim()
    m = state.m.amax(dim=axis)
    a = torch.exp(state.m - m.unsqueeze(axis))
    return SoftmaxState(m=m, l=(state.l * a).sum(dim=axis),
                        acc=(state.acc * a[..., None]).sum(dim=axis))


def finalize(state: SoftmaxState, out_dtype=None):
    """Return ``(o, lse)``. Rows that saw only masked scores produce zeros."""
    l_safe = torch.where(state.l == 0.0, torch.ones_like(state.l), state.l)
    o = state.acc / l_safe[..., None]
    lse = state.m + torch.log(l_safe)
    if out_dtype is not None:
        o = o.to(out_dtype)
    return o, lse
