"""The kernels' per-block online-softmax fold, in plain torch.

Counterpart of ``repro.kernels.common.online_fold``: the plain versions of
both CUDA kernels fold their score tiles through this one function, and the
kernels' ``fold`` device code (``csrc/*.cu``) is its twin. It differs from
``core.online_softmax.update`` in two places the kernels need: ``l`` is
updated *before* the ``p_transform`` hook (dropout), and P is cast to the
value dtype before the P·V product.

``round_acc`` is the plain form of bf16-ACC (JAX's ``preferred_element_type``
= ``acc_dtype``): a product computed in f32 is rounded to ``acc_dtype`` and
back before it is used or added into an f32 sum.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.online_softmax import NEG_INF, SoftmaxState


def round_acc(x: torch.Tensor, acc_dtype) -> torch.Tensor:
    """``x`` (f32) rounded to ``acc_dtype`` and back to f32; f32 is a no-op."""
    if acc_dtype == torch.float32:
        return x
    return x.to(acc_dtype).float()


def online_fold(state: SoftmaxState, s: torch.Tensor, v: torch.Tensor,
                p_transform: Optional[Callable] = None,
                acc_dtype=torch.float32) -> SoftmaxState:
    """Fold one masked score tile ``s [..., rows, cols]`` (f32, masked
    positions already ``NEG_INF``) and values ``v [..., cols, D]``.

    Rows that have only seen masked scores keep ``m == NEG_INF``; ``m_safe``
    shifts them by 0 so their probabilities are 0, ``l`` stays 0, and the
    finalize guard emits exact zeros. With bf16 ``acc_dtype`` the tile's
    P·V is rounded to bf16 before it is added into the f32 ``acc``.
    """
    m_new = torch.maximum(state.m, s.amax(dim=-1))
    alpha = torch.exp(state.m - m_new)
    m_safe = torch.where(m_new == NEG_INF, torch.zeros_like(m_new), m_new)
    p = torch.exp(s - m_safe[..., None])
    l_new = state.l * alpha + p.sum(dim=-1)
    if p_transform is not None:
        p = p_transform(p)
    pv = round_acc(p.to(v.dtype).float() @ v.float(), acc_dtype)
    return SoftmaxState(m_new, l_new, state.acc * alpha[..., None] + pv)
