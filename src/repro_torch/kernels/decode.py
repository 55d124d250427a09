"""Flash-decode: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.decode.flash_decode`` (contiguous cache). One
query token per row attends to a cache ``k/v [B, Hkv, S, D]`` over its first
``kv_len[b]`` positions, optionally gated by a sliding window. The GQA group
``G = Hq // Hkv`` shares every K/V tile. ``num_splits > 1`` cuts the 128-wide
KV tiles into that many contiguous slices, each folded into raw f32
``(acc, m, l)`` partials; :func:`_split_states` + ``merge_many`` +
``finalize`` combine them in plain torch (plain XLA in JAX).

On a CUDA tensor :func:`flash_decode` launches ``csrc/flash_decode.cu`` (one
block per (split, kv head, batch)); on a CPU tensor it runs
:func:`flash_decode_torch`, the same tiles and splits in plain torch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import online_softmax as osm
from repro_torch.core.online_softmax import NEG_INF
from repro_torch.kernels import _build
from repro_torch.kernels.common import online_fold
from repro_torch.kernels.flash_fwd import DTYPES, HEAD_DIMS

TILE = 128       # BKV in csrc/flash_decode.cu
MAX_GROUP = 8    # MAXG in csrc/flash_decode.cu

#: kernel launches since the last reset (the plain version does not count)
launches = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_int, _P]


def split_layout(skv: int, num_splits: int):
    """``(n_tiles, num_splits, tiles_per_split)`` for a cache of ``skv``
    rows: splits never outnumber tiles; trailing splits may be empty."""
    nk = -(-skv // TILE)
    ns = max(1, min(num_splits, nk))
    return nk, ns, -(-nk // ns)


def _split_states(acc, m, l, b, hq):
    """Partials acc [B,Hkv,ns,G,D], m/l [B,Hkv,ns,G] → a SoftmaxState with
    m/l [B,ns,Hq] and acc [B,ns,Hq,D] (splits on axis 1, for merge_many)."""
    ns, d = acc.shape[2], acc.shape[-1]
    acc = acc.transpose(1, 2).reshape(b, ns, hq, d)
    m = m.transpose(1, 2).reshape(b, ns, hq)
    l = l.transpose(1, 2).reshape(b, ns, hq)
    return osm.SoftmaxState(m=m, l=l, acc=acc)


def _merge_partials(acc, m, l, b, hq, out_dtype):
    state = osm.merge_many(_split_states(acc, m, l, b, hq), axis=1)
    o, _ = osm.finalize(state, out_dtype=out_dtype)
    return o


def _check_inputs(q, k, v, kv_len, window, num_splits):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B,Hq,D], k/v [B,Hkv,S,D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} (need equal B, D and Hq % Hkv == 0)")
    if not (q.device == k.device == v.device == kv_len.device):
        raise ValueError("q, k, v, kv_len must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be [B] = ({b},), got {tuple(kv_len.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if num_splits < 1:
        raise ValueError(f"num_splits must be >= 1, got {num_splits}")


def flash_decode(q, k, v, *, kv_len=None, window: Optional[int] = None,
                 scale: Optional[float] = None, num_splits: int = 1):
    """q [B, Hq, D]; k/v [B, Hkv, S, D]; kv_len [B] int32 (default: full S).

    Returns o [B, Hq, D] in q.dtype; rows with kv_len == 0 are exact zeros.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (f32 or bf16, contiguous, int32 kv_len, D in ``HEAD_DIMS``,
    Hq / Hkv <= ``MAX_GROUP``) or raises.
    """
    b, skv = q.shape[0], k.shape[2]
    if kv_len is None:
        kv_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    _check_inputs(q, k, v, kv_len, window, num_splits)
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_decode_torch(q, k, v, kv_len=kv_len, window=window,
                                  scale=scale, num_splits=num_splits)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    return _launch(q, k, v, kv_len, window, scale, num_splits)


def _launch(q, k, v, kv_len, window, scale, num_splits):
    global launches
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_decode kernel takes float32 or bfloat16, got {q.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"kv_len must be int32, got {kv_len.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, kv_len)):
        raise ValueError("flash_decode kernel needs contiguous q, k, v, kv_len")
    b, hq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode kernel head_dim must be in {HEAD_DIMS}, got {d}")
    if g > MAX_GROUP:
        raise ValueError(f"flash_decode kernel GQA group must be <= {MAX_GROUP}, got {g}")
    _, ns, _ = split_layout(skv, num_splits)
    f32 = dict(dtype=torch.float32, device=q.device)
    if ns == 1:
        o = torch.empty_like(q)
        outs = (o.data_ptr(), None, None, None)
    else:
        acc = torch.empty((b, hkv, ns, g, d), **f32)
        m = torch.empty((b, hkv, ns, g), **f32)
        l = torch.empty((b, hkv, ns, g), **f32)
        outs = (None, acc.data_ptr(), m.data_ptr(), l.data_ptr())
    fn = _build.kernel_fn("flash_decode", "flash_decode_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), *outs,
             b, hq, hkv, skv, d, DTYPES[q.dtype], scale, window or 0, ns,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_decode", err)
    launches += 1
    if ns == 1:
        return o
    return _merge_partials(acc, m, l, b, hq, q.dtype)


def flash_decode_torch(q, k, v, *, kv_len, window: Optional[int] = None,
                       scale: Optional[float] = None, num_splits: int = 1):
    """The kernel's plain-torch version: the same 128-wide tiles and the same
    split layout, folded through ``common.online_fold`` per split, then the
    f32 partial merge when there is more than one split."""
    b, hq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    nk, ns, nj = split_layout(skv, num_splits)
    qg = q.float().reshape(b, hkv, g, d)
    kv_len = kv_len.clamp(max=skv).to(torch.int64)[:, None, None, None]
    q_pos = kv_len - 1
    parts = []
    for split in range(ns):
        state = osm.init_state((b, hkv, g), d, device=q.device)
        for ik in range(split * nj, min((split + 1) * nj, nk)):
            lo, hi = ik * TILE, min((ik + 1) * TILE, skv)
            kp = torch.arange(lo, hi, device=q.device)
            s = torch.einsum("bhgd,bhkd->bhgk", qg, k[:, :, lo:hi].float()) * scale
            allowed = kp < kv_len
            if window is not None:
                allowed = allowed & (kp > q_pos - window)
            s = torch.where(allowed, s, NEG_INF)
            state = online_fold(state, s, v[:, :, lo:hi])
        parts.append(state)
    if ns == 1:
        o, _ = osm.finalize(parts[0], out_dtype=q.dtype)
        return o.reshape(b, hq, d)
    acc = torch.stack([s.acc for s in parts], dim=2)       # [B,Hkv,ns,G,D]
    m = torch.stack([s.m for s in parts], dim=2)
    l = torch.stack([s.l for s in parts], dim=2)
    return _merge_partials(acc, m, l, b, hq, q.dtype)
