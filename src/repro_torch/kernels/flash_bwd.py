"""Fused attention backward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.flash_bwd``. ``flash_bwd`` returns
``(dq, dk, dv)`` for ``o = flash_fwd(q, k, v)`` given ``lse`` and ``do``,
recomputing the probabilities from ``lse`` (the paper's memory-saving
choice, §3.3). ``delta = rowsum(dO ∘ O)`` (:func:`row_delta`) is a plain f32
torch op, as JAX computes it outside Pallas. On a CUDA tensor it launches
the one kernel of ``csrc/flash_bwd.cu`` (:func:`launch_bwd`): a block per
(kv tile, kv head, batch) loops over the GQA group's q heads and the q
tiles, keeps dK/dV on chip and adds each tile's dQ into an f32 buffer with
atomics, its products on tensor cores (3xTF32 for f32, bf16 mma for bf16).
dK and dV are bit-reproducible; dQ's sum order changes from run to run, so
it is reproducible to f32 rounding only. On a CPU tensor it runs the plain
version, :func:`flash_bwd_torch`, which walks the same 64-wide tiles in the
kernel's order.
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
launches_bwd = 0

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
    CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (f32 or bf16, contiguous, D in ``HEAD_DIMS``) or raises. On the card dQ
    is summed with atomic adds in an order that changes from run to run:
    equal across runs to f32 rounding, not bit for bit (dK, dV are).
    """
    _check_inputs(q, k, v, segment_ids, window, acc_dtype)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be shaped like q {tuple(q.shape)}, got "
                         f"{tuple(o.shape)} and {tuple(do.shape)}")
    if tuple(lse.shape) != tuple(q.shape[:3]) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if q.device.type == "cpu":
        fn = flash_bwd_torch
    elif q.device.type == "cuda":
        fn = launch_bwd
    else:
        raise ValueError(f"flash_bwd runs on cuda or cpu, not {q.device}")
    do = do.to(q.dtype)
    return fn(q, k, v, lse, do, row_delta(o, do), causal=causal, window=window,
              scale=(q.shape[-1] ** -0.5) if scale is None else float(scale),
              dropout_rate=dropout_rate, dropout_seed=dropout_seed,
              segment_ids=segment_ids, acc_dtype=acc_dtype)


def row_delta(o, do):
    """``delta = rowsum(dO ∘ O)`` [B,Hq,Sq] in f32 (the paper's dPsum), an
    input of the backward kernel."""
    return (do.float() * o.float()).sum(dim=-1)


def launch_bwd(q, k, v, lse, do, delta, *, causal=False, window=None,
               scale=None, dropout_rate=0.0, dropout_seed=0, segment_ids=None,
               acc_dtype=torch.float32):
    """Launch the fused kernel on CUDA tensors; returns ``(dq, dk, dv)``.
    The keywords are :func:`flash_bwd`'s. dQ is added into a zeroed f32
    buffer (``dq`` itself for f32 inputs, cast to bf16 afterwards else)."""
    global launches_bwd
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_bwd kernel takes float32 or bfloat16, got {q.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, do, lse)):
        raise ValueError("flash_bwd kernel needs contiguous q, k, v, do, lse")
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash_bwd kernel needs q, k, v, do aligned to 16 bytes")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_bwd kernel head_dim must be in {HEAD_DIMS}, got {d}")
    scale = (d ** -0.5) if scale is None else scale
    delta = delta.contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    seg_ptrs = [None] * 6
    keep = []                   # hold the id tensors until the launch returns
    if segment_ids is not None:
        keep = segment_tiles(segment_ids, sq, skv, q.device)
        seg_ptrs = [t.data_ptr() for t in keep]
    fn = _build.kernel_fn("flash_bwd", "flash_bwd_launch", _ARGTYPES)
    _build.check("flash_bwd", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *seg_ptrs, b, hq, hkv, sq, skv, d, DTYPES[q.dtype],
        int(acc_dtype == torch.bfloat16), scale, int(causal), window or 0,
        int(dropout_rate > 0.0), rng.int32(dropout_seed),
        rng.keep_threshold(dropout_rate), 1.0 - dropout_rate,
        torch.cuda.current_stream(q.device).cuda_stream))
    del keep
    launches_bwd += 1
    return dq.to(q.dtype), dk, dv


def _tile_needed(lo_q, lo_k, q_offset, causal, window) -> bool:
    """The kernel's causal / window tile skip (segment skips only drop tiles
    whose every pair is masked, which contribute exact zeros here)."""
    q_start = lo_q + q_offset
    if causal and lo_k > q_start + TILE - 1:
        return False
    if window is not None and lo_k + TILE - 1 <= q_start - window:
        return False
    return True


def flash_bwd_torch(q, k, v, lse, do, delta, *, causal=False, window=None,
                    scale=None, dropout_rate=0.0, dropout_seed=0,
                    segment_ids=None, acc_dtype=torch.float32,
                    matmul=torch.matmul):
    """The kernel in plain torch: ``(dq, dk, dv)`` given ``delta =
    row_delta(o, do)``; the keywords are :func:`flash_bwd`'s.

    Per 64-row kv tile it walks the q tiles the kernel visits, for every q
    head at once: dV and dK of the tile accumulate over them and are summed
    over the GQA group at the end, and each (q tile, kv tile)'s dQ update is
    added into an f32 dQ. P~ and dS are rounded to the input dtype before
    their products, and with bf16 ``acc_dtype`` each 64-wide tile product is
    rounded to bf16. ``matmul`` computes every tile product (S, dP, dV, dK,
    dQ); the tests pass ``common.tf32_matmul`` to copy the kernel's 3xTF32.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
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
        """(P~, dS) of one (q tile, kv tile), rounded to the input dtype."""
        qp = (torch.arange(lq, hq_, device=dev) + q_offset)[:, None]
        kp = torch.arange(lk, hk, device=dev)[None, :]
        kt = kf[:, :, lk:hk].transpose(-1, -2)
        s = round_acc(matmul(qf[:, :, lq:hq_], kt), acc_dtype) * scale
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
        dp = round_acc(matmul(dof[:, :, lq:hq_],
                              vf[:, :, lk:hk].transpose(-1, -2)), acc_dtype)
        p_kept = p
        if dropout_rate > 0.0:
            keep = rng.dropout_keep_mask(dropout_rate, dropout_seed, bi, hi_,
                                         qp[None, None], kp[None, None])
            p_kept = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
            dp = torch.where(keep, dp / (1.0 - dropout_rate), 0.0)
        ds = p * (dp - delta[:, :, lq:hq_, None]) * scale
        return p_kept.to(q.dtype).float(), ds.to(q.dtype).float()

    dq = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
    dk = torch.empty((b, hkv, skv, d), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    for lk in range(0, skv, TILE):
        hk = min(lk + TILE, skv)
        dk_acc = torch.zeros((b, hq, hk - lk, d), dtype=torch.float32, device=dev)
        dv_acc = torch.zeros_like(dk_acc)
        for lq in range(0, sq, TILE):
            if not _tile_needed(lq, lk, q_offset, causal, window):
                continue
            hq_ = min(lq + TILE, sq)
            p_kept, ds = tile(lq, hq_, lk, hk)
            dv_acc += round_acc(matmul(p_kept.transpose(-1, -2), dof[:, :, lq:hq_]),
                                acc_dtype)
            dk_acc += round_acc(matmul(ds.transpose(-1, -2), qf[:, :, lq:hq_]),
                                acc_dtype)
            dq[:, :, lq:hq_] += round_acc(matmul(ds, kf[:, :, lk:hk]), acc_dtype)
        dk[:, :, lk:hk] = dk_acc.view(b, hkv, g, hk - lk, d).sum(dim=2)
        dv[:, :, lk:hk] = dv_acc.view(b, hkv, g, hk - lk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
