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

``split_tf32`` and ``tf32_matmul`` are the plain form of the backward
kernel's f32 products on tensor cores (3xTF32): each operand split into two
TF32 values, three TF32 products summed, small terms first.
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


def _tf32(x: torch.Tensor, rounding: int) -> torch.Tensor:
    """f32 ``x`` cut to TF32 (10 mantissa bits) by int32 bit masking:
    ``rounding=0x1000`` rounds to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` does; ``rounding=0`` truncates, as a tensor core
    reads an f32 register as a TF32 operand."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + rounding) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """``(hi, lo)`` as the backward kernel splits an f32 operand: ``hi =
    tf32(x)`` rounded to nearest, ``lo = x - hi`` (exact in f32) truncated
    to TF32. ``hi + lo`` keeps about 21 bits of ``x``."""
    hi = _tf32(x, 0x1000)
    return hi, _tf32(x.float() - hi, 0)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` as the tensor cores compute it from TF32 operands, summed in
    f32: ``passes=3`` is 3xTF32 (lo·hi + hi·lo + hi·hi), ``passes=1`` one
    TF32 product. A product of two TF32 values is exact in f32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    if passes != 3:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


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
