"""Fused attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.flash_fwd``. ``flash_fwd`` computes
``O = dropout(softmax(QKᵀ·scale))·V`` and ``lse`` with causal masking (q as
the kv suffix), a sliding window, ``segment_ids`` and coordinate-hash
dropout. On a CUDA tensor it launches ``csrc/flash_fwd.cu`` (one block per
64-row q tile, q head and batch, each warp 16 q rows on tensor cores, two
warps a row group at D 256, the 64-row KV tiles, 32 at D 256, looped inside
the block through a ``cp.async`` ring); on a CPU tensor it runs
:func:`flash_fwd_torch`, which folds the same KV tiles through the same
online-softmax fold in plain torch.
``acc_dtype=bfloat16`` (bf16-ACC) rounds each score tile and each tile's P·V
to bf16 on both.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.online_softmax import NEG_INF, finalize, init_state
from repro_torch.kernels import _build, rng
from repro_torch.kernels.common import online_fold, round_acc
from repro_torch.kernels.ref import _expand_kv

TILE = 64                      # KV tile of the segment bounds (and of the fold to D 128)
#: head dims the kernel is instantiated for (80: hubert-xlarge)
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACC_DTYPES = (torch.float32, torch.bfloat16)   # accumulate types of a product

#: kernel launches since the last reset (the plain version does not count)
launches = 0

_P = ctypes.c_void_p
_ARGTYPES = ([_P] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
             ctypes.c_float, ctypes.c_int, ctypes.c_int, _P])


def kv_tile(d: int) -> int:
    """KV rows a fold step takes at head dim ``d`` (``Cfg::BKV`` in
    ``csrc/flash_fwd.cu``): 64, and 32 at D 256, where a 64-row f32 ring
    stage would not leave room for a second one in shared memory."""
    return 32 if d > 128 else TILE


def _check_inputs(q, k, v, segment_ids, window, acc_dtype=torch.float32):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} (need equal B, D and Hq % Hkv == 0)")
    if k.shape[2] < q.shape[2]:
        raise ValueError("q must be a suffix of kv (Sq <= Skv)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if segment_ids is not None and tuple(segment_ids.shape) != (b, k.shape[2]):
        raise ValueError(f"segment_ids must be [B, Skv] = {(b, k.shape[2])}, "
                         f"got {tuple(segment_ids.shape)}")
    if acc_dtype not in ACC_DTYPES:
        raise ValueError(f"acc_dtype must be one of {ACC_DTYPES}, got {acc_dtype}")


def flash_fwd(q, k, v, *, causal: bool = False, window: Optional[int] = None,
              scale: Optional[float] = None, dropout_rate: float = 0.0,
              dropout_seed: int = 0, segment_ids=None,
              acc_dtype=torch.float32, batch_offset: int = 0,
              head_offset: int = 0):
    """Returns ``(o [B,Hq,Sq,D] in q.dtype, lse [B,Hq,Sq] f32)``.

    q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] (Hq % Hkv == 0, q the suffix of kv).
    segment_ids: optional [B, Skv] int per-token segment ids; attention never
    crosses a segment and negative ids mark padding that attends to nothing.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (f32 or bf16, contiguous, D in ``HEAD_DIMS``) or raises.
    acc_dtype: float32, or bfloat16 to round every tile product to bf16.
    batch_offset, head_offset: the global batch row and q head of
    ``q[0, 0]``, the coordinates the dropout mask hashes: a rank holding
    rows ``[b0, ...)`` and q heads ``[h0, ...)`` of a sharded batch passes
    ``b0`` and ``h0`` and draws the single-device run's masks.
    """
    _check_inputs(q, k, v, segment_ids, window, acc_dtype)
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_fwd_torch(q, k, v, causal=causal, window=window,
                               scale=scale, dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed,
                               segment_ids=segment_ids, acc_dtype=acc_dtype,
                               batch_offset=batch_offset,
                               head_offset=head_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    return _launch(q, k, v, causal, window, scale, dropout_rate,
                   rng.int32(dropout_seed), segment_ids, acc_dtype,
                   batch_offset, head_offset)


def _tile_minmax(seg: torch.Tensor):
    """[B, S] ids → per-64-tile (min, max) [B, n_tiles] int32, tail padded
    with -1 (negative ids never match, so the skip stays conservative)."""
    b, s = seg.shape
    n = -(-s // TILE)
    padded = torch.full((b, n * TILE), -1, dtype=torch.int32, device=seg.device)
    padded[:, :s] = seg
    tiles = padded.view(b, n, TILE)
    return tiles.amin(-1).contiguous(), tiles.amax(-1).contiguous()


def segment_tiles(segment_ids, sq: int, skv: int, device):
    """The int32 id tensors a kernel reads for ``segment_ids [B, Skv]``:
    ``[q_seg, kv_seg, q min, q max, kv min, kv max]`` (the per-tile bounds
    of the segment skip), all contiguous on ``device``."""
    if segment_ids.device != device or segment_ids.dtype != torch.int32:
        raise TypeError("segment_ids must be int32 on q's device")
    kv_seg = segment_ids.contiguous()
    q_seg = kv_seg[:, skv - sq:].contiguous()
    return [q_seg, kv_seg, *_tile_minmax(q_seg), *_tile_minmax(kv_seg)]


def _launch(q, k, v, causal, window, scale, dropout_rate, seed, segment_ids,
            acc_dtype, batch_offset=0, head_offset=0):
    global launches
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_fwd kernel takes float32 or bfloat16, got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd kernel needs contiguous q, k, v")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel head_dim must be in {HEAD_DIMS}, got {d}")
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    seg_ptrs = [None] * 6
    keep = []                   # hold the id tensors until the launch returns
    if segment_ids is not None:
        keep = segment_tiles(segment_ids, sq, skv, q.device)
        seg_ptrs = [t.data_ptr() for t in keep]
    fn = _build.kernel_fn("flash_fwd", "flash_fwd_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), *seg_ptrs, b, hq, hkv, sq, skv, d, DTYPES[q.dtype],
             int(acc_dtype == torch.bfloat16), scale, int(causal), window or 0, int(dropout_rate > 0.0), seed,
             rng.keep_threshold(dropout_rate), 1.0 - dropout_rate,
             int(batch_offset), int(head_offset),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_fwd", err)
    launches += 1
    del keep
    return o, lse


def flash_fwd_torch(q, k, v, *, causal: bool = False,
                    window: Optional[int] = None, scale: Optional[float] = None,
                    dropout_rate: float = 0.0, dropout_seed: int = 0,
                    segment_ids=None, acc_dtype=torch.float32,
                    batch_offset: int = 0, head_offset: int = 0):
    """The kernel's plain-torch version: the same KV tiles (:func:`kv_tile`)
    folded in the same order through ``common.online_fold``, every q row at once.
    bf16 ``acc_dtype`` rounds each score tile (before the scale) and each
    tile's P·V to bf16, as the kernel does. The offsets are
    :func:`flash_fwd`'s."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    q_offset = skv - sq
    dev = q.device
    qf = q.float()
    qp = (torch.arange(sq, device=dev) + q_offset)[:, None]      # [Sq, 1]
    q_seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        q_seg = seg[:, q_offset:]
    state = init_state((b, hq, sq), d, device=dev)
    tile = kv_tile(d)
    for lo in range(0, skv, tile):
        hi = min(lo + tile, skv)
        if causal and lo > q_offset + sq - 1:
            break                     # every later tile is above the diagonal
        if window is not None and hi - 1 <= q_offset - window:
            continue                  # the whole tile is behind every row's window
        kp = torch.arange(lo, hi, device=dev)[None, :]           # [1, T]
        s = round_acc(torch.einsum("bhqd,bhkd->bhqk", qf,
                                   _expand_kv(k[:, :, lo:hi], hq).float()),
                      acc_dtype) * scale
        allowed = torch.ones((sq, hi - lo), dtype=torch.bool, device=dev)
        if causal:
            allowed &= kp <= qp
        if window is not None:
            allowed &= kp > qp - window
        allowed = allowed[None, None]
        if q_seg is not None:
            kv_seg = seg[:, lo:hi]
            allowed = allowed & ((q_seg[:, :, None] == kv_seg[:, None, :])
                                 & (q_seg[:, :, None] >= 0))[:, None]
        s = torch.where(allowed, s, NEG_INF)
        p_transform = None
        if dropout_rate > 0.0:
            def p_transform(p, kp=kp):
                keep = rng.dropout_keep_mask(
                    dropout_rate, dropout_seed,
                    torch.arange(b, device=dev)[:, None, None, None] + batch_offset,
                    torch.arange(hq, device=dev)[None, :, None, None] + head_offset,
                    qp[None, None], kp[None, None])
                return torch.where(keep, p / (1.0 - dropout_rate), 0.0)
        state = online_fold(state, s, _expand_kv(v[:, :, lo:hi], hq),
                            p_transform, acc_dtype)
    return finalize(state, out_dtype=q.dtype)
