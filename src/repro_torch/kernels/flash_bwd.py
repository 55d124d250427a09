"""Fused attention backward: the CUDA kernels' wrapper and their plain version.

Counterpart of ``repro.kernels.flash_bwd``. ``flash_bwd`` returns
``(dq, dk, dv)`` for ``o = flash_fwd(q, k, v)`` given ``lse`` and ``do``,
recomputing the probabilities from ``lse`` (the paper's memory-saving
choice, §3.3). ``delta = rowsum(dO ∘ O)`` (:func:`row_delta`) is a plain f32
torch op, as JAX computes it outside Pallas. On a CUDA tensor it launches
the two kernels of ``csrc/flash_bwd.cu``: :func:`launch_dkv` (one block per
(kv tile, kv head, batch), looping over the GQA group's q heads and the q
tiles, dK/dV summed on chip) and :func:`launch_dq` (one block per (q tile,
q head, batch), looping over kv tiles). On a CPU tensor it runs their plain
versions, :func:`flash_bwd_dkv_torch` and :func:`flash_bwd_dq_torch`, which
walk the same 64-wide tiles in the kernels' order.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.online_softmax import NEG_INF
from repro_torch.kernels import _build, rng
from repro_torch.kernels.common import round_acc
from repro_torch.kernels.flash_fwd import (DTYPES, HEAD_DIMS, TILE, _check_inputs,
                                           segment_tiles)
from repro_torch.kernels.ref import _expand_kv

#: kernel launches since the last reset (the plain version does not count)
launches_dkv = 0
launches_dq = 0

_P = ctypes.c_void_p
_ARGTYPES = ([_P] * 15 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
             ctypes.c_float, _P])


def flash_bwd(q, k, v, o, lse, do, *, causal: bool = False,
              window: Optional[int] = None, scale: Optional[float] = None,
              dropout_rate: float = 0.0, dropout_seed: int = 0,
              segment_ids=None, acc_dtype=torch.float32):
    """Returns ``(dq, dk, dv)`` with the shapes and dtypes of q, k, v.

    q/o/do [B,Hq,Sq,D], k/v [B,Hkv,Skv,D], lse [B,Hq,Sq] f32 from
    ``flash_fwd`` with the same options (dropout replays its keep mask).
    ``acc_dtype=bfloat16`` rounds every tile product to bf16 (bf16-ACC). A
    CPU tensor runs the plain version; a CUDA tensor launches the kernels
    (f32 or bf16, contiguous, D in ``HEAD_DIMS``) or raises.
    """
    _check_inputs(q, k, v, segment_ids, window, acc_dtype)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be shaped like q {tuple(q.shape)}, got "
                         f"{tuple(o.shape)} and {tuple(do.shape)}")
    if tuple(lse.shape) != tuple(q.shape[:3]) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if q.device.type == "cpu":
        dkv_fn, dq_fn = flash_bwd_dkv_torch, flash_bwd_dq_torch
    elif q.device.type == "cuda":
        dkv_fn, dq_fn = launch_dkv, launch_dq
    else:
        raise ValueError(f"flash_bwd runs on cuda or cpu, not {q.device}")
    do = do.to(q.dtype)
    delta = row_delta(o, do)
    kw = dict(causal=causal, window=window,
              scale=(q.shape[-1] ** -0.5) if scale is None else float(scale),
              dropout_rate=dropout_rate, dropout_seed=dropout_seed,
              segment_ids=segment_ids, acc_dtype=acc_dtype)
    dk, dv = dkv_fn(q, k, v, lse, do, delta, **kw)
    return dq_fn(q, k, v, lse, do, delta, **kw), dk, dv


def row_delta(o, do):
    """``delta = rowsum(dO ∘ O)`` [B,Hq,Sq] in f32 (the paper's dPsum), the
    input both backward kernels share."""
    return (do.float() * o.float()).sum(dim=-1)


def launch_dkv(q, k, v, lse, do, delta, **opts):
    """Launch the dK/dV kernel; returns ``(dk, dv)``. ``opts`` are
    :func:`flash_bwd`'s keywords."""
    global launches_dkv
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv_launch", q, k, v, lse, do, delta, None, dk, dv, **opts)
    launches_dkv += 1
    return dk, dv


def launch_dq(q, k, v, lse, do, delta, **opts):
    """Launch the dQ kernel; returns ``dq``. ``opts`` are :func:`flash_bwd`'s
    keywords."""
    global launches_dq
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq_launch", q, k, v, lse, do, delta, dq, None, None, **opts)
    launches_dq += 1
    return dq


def _launch(entry, q, k, v, lse, do, delta, dq, dk, dv, *, causal=False,
            window=None, scale=None, dropout_rate=0.0, dropout_seed=0,
            segment_ids=None, acc_dtype=torch.float32):
    """One kernel of ``csrc/flash_bwd.cu`` on CUDA tensors, writing the
    outputs it is given (None for the others)."""
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_bwd kernels take float32 or bfloat16, got {q.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, do, lse)):
        raise ValueError("flash_bwd kernels need contiguous q, k, v, do, lse")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_bwd kernel head_dim must be in {HEAD_DIMS}, got {d}")
    scale = (d ** -0.5) if scale is None else scale
    delta = delta.contiguous()
    seg_ptrs = [None] * 6
    keep = []                   # hold the id tensors until the launch returns
    if segment_ids is not None:
        keep = segment_tiles(segment_ids, sq, skv, q.device)
        seg_ptrs = [t.data_ptr() for t in keep]
    fn = _build.kernel_fn("flash_bwd", entry, _ARGTYPES)
    _build.check("flash_bwd", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (dq, dk, dv)),
        *seg_ptrs, b, hq, hkv, sq, skv, d, DTYPES[q.dtype],
        int(acc_dtype == torch.bfloat16), scale, int(causal), window or 0,
        int(dropout_rate > 0.0), rng.int32(dropout_seed),
        rng.keep_threshold(dropout_rate), 1.0 - dropout_rate,
        torch.cuda.current_stream(q.device).cuda_stream))
    del keep


def _tile_needed(lo_q, lo_k, q_offset, causal, window) -> bool:
    """The kernels' causal / window tile skip (segment skips only drop tiles
    whose every pair is masked, which contribute exact zeros here)."""
    q_start = lo_q + q_offset
    if causal and lo_k > q_start + TILE - 1:
        return False
    if window is not None and lo_k + TILE - 1 <= q_start - window:
        return False
    return True


def flash_bwd_torch(q, k, v, lse, do, delta, **opts):
    """The kernels' plain-torch version: ``(dq, dk, dv)`` given ``delta =
    row_delta(o, do)``; ``opts`` are :func:`flash_bwd`'s keywords."""
    dk, dv = flash_bwd_dkv_torch(q, k, v, lse, do, delta, **opts)
    return flash_bwd_dq_torch(q, k, v, lse, do, delta, **opts), dk, dv


def _plain_tiles(q, k, v, lse, do, delta, *, causal=False, window=None,
                 scale=None, dropout_rate=0.0, dropout_seed=0,
                 segment_ids=None, acc_dtype=torch.float32):
    """``(tile, qf, dof, kf)``: ``tile(lq, hq_, lk, hk)`` gives ``(P~, dS)`` of
    one (q tile, kv tile), recomputing P from lse as the kernels do and
    rounding both to the input dtype before their products; q, dO and k
    (expanded to the Hq heads) come back in f32 for those products."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    q_offset = skv - sq
    dev = q.device
    qf, dof = q.float(), do.float()
    kf, vf = _expand_kv(k, hq).float(), _expand_kv(v, hq).float()
    lse_safe = torch.where(lse == NEG_INF, torch.zeros_like(lse), lse)
    seg = None if segment_ids is None else segment_ids.to(torch.int32)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    hi_ = torch.arange(hq, device=dev)[None, :, None, None]

    def tile(lq, hq_, lk, hk):
        qp = (torch.arange(lq, hq_, device=dev) + q_offset)[:, None]
        kp = torch.arange(lk, hk, device=dev)[None, :]
        s = round_acc(torch.einsum("bhqd,bhkd->bhqk", qf[:, :, lq:hq_],
                                   kf[:, :, lk:hk]), acc_dtype) * scale
        allowed = torch.ones((hq_ - lq, hk - lk), dtype=torch.bool, device=dev)
        if causal:
            allowed &= kp <= qp
        if window is not None:
            allowed &= kp > qp - window
        allowed = allowed[None, None]
        if seg is not None:
            qs, ks = seg[:, q_offset + lq:q_offset + hq_], seg[:, lk:hk]
            allowed = allowed & ((qs[:, :, None] == ks[:, None, :])
                                 & (qs[:, :, None] >= 0))[:, None]
        s = torch.where(allowed, s, NEG_INF)
        p = torch.exp(s - lse_safe[:, :, lq:hq_, None])
        dp = round_acc(torch.einsum("bhqd,bhkd->bhqk", dof[:, :, lq:hq_],
                                    vf[:, :, lk:hk]), acc_dtype)
        p_kept = p
        if dropout_rate > 0.0:
            keep = rng.dropout_keep_mask(dropout_rate, dropout_seed, bi, hi_,
                                         qp[None, None], kp[None, None])
            p_kept = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
            dp = torch.where(keep, dp / (1.0 - dropout_rate), 0.0)
        ds = p * (dp - delta[:, :, lq:hq_, None]) * scale
        return p_kept.to(q.dtype).float(), ds.to(q.dtype).float()

    return tile, qf, dof, kf


def flash_bwd_dkv_torch(q, k, v, lse, do, delta, **opts):
    """The dK/dV kernel in plain torch: per 64-row kv tile over the q tiles,
    per q head, then summed over the GQA group; returns ``(dk, dv)``."""
    tile, qf, dof, _ = _plain_tiles(q, k, v, lse, do, delta, **opts)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    causal, window = opts.get("causal", False), opts.get("window")
    acc_dtype = opts.get("acc_dtype", torch.float32)
    g = hq // hkv
    dk = torch.empty((b, hkv, skv, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for lk in range(0, skv, TILE):
        hk = min(lk + TILE, skv)
        dk_acc = torch.zeros((b, hq, hk - lk, d), dtype=torch.float32,
                             device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for lq in range(0, sq, TILE):
            if not _tile_needed(lq, lk, skv - sq, causal, window):
                continue
            hq_ = min(lq + TILE, sq)
            p_kept, ds = tile(lq, hq_, lk, hk)
            dv_acc += round_acc(p_kept.transpose(-1, -2) @ dof[:, :, lq:hq_],
                                acc_dtype)
            dk_acc += round_acc(ds.transpose(-1, -2) @ qf[:, :, lq:hq_],
                                acc_dtype)
        dk[:, :, lk:hk] = dk_acc.view(b, hkv, g, hk - lk, d).sum(dim=2)
        dv[:, :, lk:hk] = dv_acc.view(b, hkv, g, hk - lk, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_torch(q, k, v, lse, do, delta, **opts):
    """The dQ kernel in plain torch: per q tile over the kv tiles."""
    tile, _, _, kf = _plain_tiles(q, k, v, lse, do, delta, **opts)
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    causal, window = opts.get("causal", False), opts.get("window")
    acc_dtype = opts.get("acc_dtype", torch.float32)
    dq = torch.empty((b, hq, sq, d), dtype=torch.float32, device=q.device)
    for lq in range(0, sq, TILE):
        hq_ = min(lq + TILE, sq)
        dq_acc = torch.zeros((b, hq, hq_ - lq, d), dtype=torch.float32,
                             device=q.device)
        for lk in range(0, skv, TILE):
            if not _tile_needed(lq, lk, skv - sq, causal, window):
                continue
            hk = min(lk + TILE, skv)
            _, ds = tile(lq, hq_, lk, hk)
            dq_acc += round_acc(ds @ kf[:, :, lk:hk], acc_dtype)
        dq[:, :, lq:hq_] = dq_acc
    return dq.to(q.dtype)
