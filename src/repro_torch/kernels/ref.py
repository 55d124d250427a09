"""Plain-torch oracles for the attention kernels (counterpart of ``repro.kernels.ref``).

* :func:`naive_mha` — the unfused computation (materialises S and P); the
  numerical oracle every kernel is held against.
* :func:`online_mha` — the fused *algorithm* as a chunked loop over KV
  (O(chunk) memory, online softmax, GQA folded into rows): the ``impl="torch"``
  path. It is a ``torch.autograd.Function`` whose backward recomputes S and P
  per chunk from the saved ``(o, lse)``, as ``repro.kernels.ref._online_bwd``
  does: autograd through the chunk loop would keep every chunk's f32 state.

Both take ``acc_dtype``: with bfloat16 every product (S, P·V and, in the
backward, dV, dP, dQ, dK) is rounded to bf16 before it is used or summed in
f32 (``common.round_acc``), JAX's ``preferred_element_type``.

Conventions (shared by every implementation in this package):
  q: [B, Hq, Sq, D]   k/v: [B, Hkv, Skv, D]   with Hq % Hkv == 0 (GQA)
  q tokens are the *suffix* of the kv sequence: global q position =
  (Skv - Sq) + i. ``causal`` masks kv_pos > q_pos; ``window=w`` additionally
  masks kv_pos <= q_pos - w. ``segment_ids [B, Skv]`` masks cross-segment
  pairs; negative ids are padding — those rows emit zeros and lse == NEG_INF.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.online_softmax import NEG_INF, SoftmaxState, finalize
from repro_torch.kernels import rng
from repro_torch.kernels.common import round_acc


def _expand_kv(x: torch.Tensor, hq: int) -> torch.Tensor:
    """[B, Hkv, S, D] -> [B, Hq, S, D] by repeating each kv head over its group."""
    hkv = x.shape[1]
    if hkv == hq:
        return x
    if hq % hkv:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {hq} % {hkv}")
    return x.repeat_interleave(hq // hkv, dim=1)


def mask_bias(sq: int, skv: int, *, causal: bool, window: Optional[int],
              device=None) -> Optional[torch.Tensor]:
    """[Sq, Skv] f32 additive bias (0 where allowed, NEG_INF where masked)."""
    if not causal and window is None:
        return None
    qp = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kp = torch.arange(skv, device=device)[None, :]
    allowed = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        allowed &= kp <= qp
    if window is not None:
        allowed &= kp > qp - window
    return torch.where(allowed, 0.0, NEG_INF).float()


def naive_mha(q, k, v, *, causal: bool = False, window: Optional[int] = None,
              scale: Optional[float] = None, dropout_rate: float = 0.0,
              dropout_seed: int = 0, segment_ids=None,
              acc_dtype=torch.float32, return_residuals: bool = False,
              batch_offset: int = 0, head_offset: int = 0):
    """Unfused attention oracle; softmax math in f32, products in f32
    rounded to ``acc_dtype``. Differentiable by plain autograd. The dropout
    mask hashes batch row ``batch_offset + b`` and q head ``head_offset +
    h`` (a shard's global coordinates).

    Fully-masked rows produce o == 0 and lse == NEG_INF (matching the fused
    kernels' l == 0 finalize path), never NaN or a uniform average.
    """
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    s = round_acc(torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()),
                  acc_dtype) * scale
    bias = mask_bias(sq, skv, causal=causal, window=window, device=q.device)
    if bias is not None:
        s = s + bias
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        q_seg = seg[:, skv - sq:]
        seg_ok = ((q_seg[:, :, None] == seg[:, None, :])
                  & (q_seg[:, :, None] >= 0))[:, None]       # [B, 1, Sq, Skv]
        s = torch.where(seg_ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == NEG_INF, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = (m + torch.log(l_safe))[..., 0]
    p = p / l_safe
    if dropout_rate > 0.0:
        dev = q.device
        bi = torch.arange(b, device=dev)[:, None, None, None] + batch_offset
        hi = torch.arange(hq, device=dev)[None, :, None, None] + head_offset
        qp = (torch.arange(sq, device=dev) + (skv - sq))[None, None, :, None]
        kp = torch.arange(skv, device=dev)[None, None, None, :]
        keep = rng.dropout_keep_mask(dropout_rate, dropout_seed, bi, hi, qp, kp)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    o = round_acc(torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(),
                               v.float()), acc_dtype).to(q.dtype)
    if return_residuals:
        return o, lse
    return o


def _fold_gqa(q, hkv):
    """[B,Hq,Sq,D] → [B,Hkv,Sq·G,D] with sq-major row order: row =
    sq_idx·G + group_idx, so K/V are used per kv-head with no G× expansion."""
    b, hq, sq, d = q.shape
    g = hq // hkv
    q = q.reshape(b, hkv, g, sq, d).transpose(2, 3)            # [b,hkv,sq,g,d]
    return q.reshape(b, hkv, sq * g, d), g


def _unfold_gqa(x, hq, sq):
    """[B,Hkv,Sq·G,(D)] → [B,Hq,Sq,(D)], inverse of _fold_gqa."""
    b, hkv = x.shape[:2]
    g = hq // hkv
    tail = x.shape[3:]
    x = x.reshape(b, hkv, sq, g, *tail).movedim(3, 2)         # [b,hkv,g,sq,..]
    return x.reshape(b, hq, sq, *tail)


def _block_masks(b, hkv, g, sq, lo, hi, *, q_offset, causal, window,
                 dropout_rate, dropout_seed, q_seg_rows=None, seg_blk=None,
                 device=None, batch_offset=0, head_offset=0):
    """(allowed, keep) for folded-GQA score blocks over kv positions
    ``[lo, hi)``; row order is sq-major: qp = row // g, group = row % g."""
    row = torch.arange(sq * g, device=device)
    qp = (row // g + q_offset)[:, None]                    # [rows, 1]
    kp = torch.arange(lo, hi, device=device)[None, :]
    allowed = None
    if causal:
        allowed = kp <= qp
    if window is not None:
        w_ok = kp > qp - window
        allowed = w_ok if allowed is None else (allowed & w_ok)
    if q_seg_rows is not None:
        seg_ok = ((q_seg_rows[:, :, None] == seg_blk[:, None, :])
                  & (q_seg_rows[:, :, None] >= 0))[:, None]  # [b,1,rows,chunk]
        allowed = seg_ok if allowed is None else (allowed & seg_ok)
    keep = None
    if dropout_rate > 0.0:
        bi = torch.arange(b, device=device)[:, None, None, None] + batch_offset
        hk = torch.arange(hkv, device=device)[None, :, None, None]
        hq_row = (hk * g + (row % g)[None, None, :, None]
                  + head_offset)                         # global q head
        keep = rng.dropout_keep_mask(dropout_rate, dropout_seed, bi, hq_row,
                                     qp[None, None], kp[None, None])
    return allowed, keep


def _seg_rows(segment_ids, q_offset, g):
    """(kv ids [B, Skv] int32, q ids repeated over the group [B, Sq·G]) in
    the sq-major row order of :func:`_fold_gqa`; (None, None) without ids."""
    if segment_ids is None:
        return None, None
    seg = segment_ids.to(torch.int32)
    return seg, seg[:, q_offset:].repeat_interleave(g, dim=1)


def _online_fwd(q, k, v, segment_ids, *, causal, window, scale, dropout_rate,
                dropout_seed, chunk, acc_dtype, batch_offset=0, head_offset=0):
    """The chunked forward: returns (o [B,Hq,Sq,D] in q.dtype, lse f32)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    q_offset = skv - sq
    qf, g = _fold_gqa(q.float(), hkv)
    seg, q_seg_rows = _seg_rows(segment_ids, q_offset, g)
    rows = g * sq
    dev = q.device
    state = SoftmaxState(
        m=torch.full((b, hkv, rows), NEG_INF, dtype=torch.float32, device=dev),
        l=torch.zeros((b, hkv, rows), dtype=torch.float32, device=dev),
        acc=torch.zeros((b, hkv, rows, d), dtype=torch.float32, device=dev))
    for lo in range(0, skv, chunk):
        hi = min(lo + chunk, skv)
        s = round_acc(torch.einsum("bhqd,bhkd->bhqk", qf,
                                   k[:, :, lo:hi].float()), acc_dtype) * scale
        allowed, keep = _block_masks(
            b, hkv, g, sq, lo, hi, q_offset=q_offset, causal=causal,
            window=window, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, q_seg_rows=q_seg_rows,
            seg_blk=None if seg is None else seg[:, lo:hi], device=dev,
            batch_offset=batch_offset, head_offset=head_offset)
        if allowed is not None:
            s = torch.where(allowed, s, NEG_INF)
        m_new = torch.maximum(state.m, s.amax(dim=-1))
        alpha = torch.exp(state.m - m_new)
        m_safe = torch.where(m_new == NEG_INF, torch.zeros_like(m_new), m_new)
        p = torch.exp(s - m_safe[..., None])
        l_new = state.l * alpha + p.sum(dim=-1)
        if keep is not None:
            p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
        acc = state.acc * alpha[..., None] + round_acc(
            p @ v[:, :, lo:hi].float(), acc_dtype)
        state = SoftmaxState(m_new, l_new, acc)
    o, lse = finalize(state, out_dtype=q.dtype)
    return _unfold_gqa(o, hq, sq), _unfold_gqa(lse, hq, sq)


def _online_bwd(q, k, v, o, lse, do, segment_ids, *, causal, window, scale,
                dropout_rate, dropout_seed, chunk, acc_dtype, batch_offset=0,
                head_offset=0):
    """Chunked recompute backward (``repro.kernels.ref._online_bwd``): S and
    P are recomputed per KV chunk from the saved lse, so memory stays
    O(chunk). Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    q_offset = skv - sq
    qf, g = _fold_gqa(q.float(), hkv)
    dof = _fold_gqa(do.float(), hkv)[0]
    lsef = _fold_gqa(lse[..., None], hkv)[0][..., 0]
    delta = (do.float() * o.float()).sum(dim=-1)
    deltaf = _fold_gqa(delta[..., None], hkv)[0][..., 0]
    # fully-masked rows store lse == NEG_INF; shift so recomputed p == 0 there
    lsef_safe = torch.where(lsef == NEG_INF, torch.zeros_like(lsef), lsef)
    seg, q_seg_rows = _seg_rows(segment_ids, q_offset, g)
    dev = q.device
    dq_acc = torch.zeros((b, hkv, g * sq, d), dtype=torch.float32, device=dev)
    dk = torch.empty((b, hkv, skv, d), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    for lo in range(0, skv, chunk):
        hi = min(lo + chunk, skv)
        kc, vc = k[:, :, lo:hi].float(), v[:, :, lo:hi].float()
        s = round_acc(torch.einsum("bhqd,bhkd->bhqk", qf, kc), acc_dtype) * scale
        allowed, keep = _block_masks(
            b, hkv, g, sq, lo, hi, q_offset=q_offset, causal=causal,
            window=window, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, q_seg_rows=q_seg_rows,
            seg_blk=None if seg is None else seg[:, lo:hi], device=dev,
            batch_offset=batch_offset, head_offset=head_offset)
        if allowed is not None:
            s = torch.where(allowed, s, NEG_INF)
        p = torch.exp(s - lsef_safe[..., None])           # recomputed probs
        p_kept = p if keep is None else \
            torch.where(keep, p / (1.0 - dropout_rate), 0.0)
        dv[:, :, lo:hi] = round_acc(
            torch.einsum("bhqk,bhqd->bhkd", p_kept, dof), acc_dtype)
        dp = round_acc(torch.einsum("bhqd,bhkd->bhqk", dof, vc), acc_dtype)
        if keep is not None:
            dp = torch.where(keep, dp / (1.0 - dropout_rate), 0.0)
        ds = p * (dp - deltaf[..., None]) * scale
        dq_acc += round_acc(ds @ kc, acc_dtype)
        dk[:, :, lo:hi] = round_acc(
            torch.einsum("bhqk,bhqd->bhkd", ds, qf), acc_dtype)
    dq = _unfold_gqa(dq_acc, hq, sq).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _OnlineMHA(torch.autograd.Function):
    """online_mha with the chunked recompute backward (saves q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, statics):
        o, lse = _online_fwd(q, k, v, segment_ids, **statics)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.statics = statics
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = _online_bwd(q, k, v, o, lse, do, segment_ids,
                                 **ctx.statics)
        return dq, dk, dv, None, None


def online_mha(q, k, v, *, causal: bool = False, window: Optional[int] = None,
               scale: Optional[float] = None, dropout_rate: float = 0.0,
               dropout_seed: int = 0, segment_ids=None, chunk: int = 1024,
               acc_dtype=torch.float32, return_residuals: bool = False,
               batch_offset: int = 0, head_offset: int = 0):
    """Chunked online-softmax attention in plain torch (the kernel's algorithm).

    Scans KV chunks carrying (m, l, acc) in f32; GQA folds the q-head group
    into rows instead of expanding K/V. A ragged last chunk is folded as it
    is. Returns o (and lse with ``return_residuals``, which bypasses the
    custom backward). O(chunk) memory in both directions.
    """
    d = q.shape[-1]
    statics = dict(causal=causal, window=window,
                   scale=(d ** -0.5) if scale is None else scale,
                   dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                   chunk=chunk, acc_dtype=acc_dtype, batch_offset=batch_offset,
                   head_offset=head_offset)
    if return_residuals:
        return _online_fwd(q, k, v, segment_ids, **statics)
    return _OnlineMHA.apply(q, k, v, segment_ids, statics)
