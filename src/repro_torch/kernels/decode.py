"""Flash-decode: the CUDA kernel's wrappers and their plain versions.

Counterpart of ``repro.kernels.decode.flash_decode`` (contiguous cache) and
``flash_paged_decode`` (page pool). One query token per row attends to its
cache over the first ``kv_len[b]`` positions, optionally gated by a sliding
window. The GQA group ``G = Hq // Hkv`` shares every K/V tile.
``num_splits > 1`` cuts the 128-wide KV tiles into that many contiguous
slices, each folded into raw f32 ``(acc, m, l)`` partials;
:func:`_split_states` + ``merge_many`` + ``finalize`` combine them in plain
torch (plain XLA in JAX).

The cache is contiguous, ``k/v [B, Hkv, S, D]``, or paged: a pool
``k_pages/v_pages [Hkv, P, page_size, D]`` shared by all rows and read
through ``block_tables [B, T]`` (row b's logical block j lives in page
``block_tables[b, j]``; entries past a row's allocation name the trash page
0). The paged kernel walks the same 128-row tiles as the contiguous one and
resolves each row through the table, so on gathered pages the two agree
bit for bit. JAX folds page-sized blocks and splits the table width; the
port splits the tiles: equal within the f32 tolerance.

On a CUDA tensor :func:`flash_decode` / :func:`flash_paged_decode` launch
``csrc/flash_decode.cu`` (one block per (row, kv head, split)); on a CPU
tensor they run :func:`flash_decode_torch` / :func:`flash_paged_decode_torch`,
the same tiles and splits in plain torch.
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

#: kernel launches since the last reset (the plain versions do not count):
#: contiguous cache, paged cache
launches = 0
launches_paged = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_int, _P]
_PAGED_ARGTYPES = [_P] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
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


def _check_inputs(q, k, v, kv_len, window, num_splits, *, paged=False):
    """Shapes of a decode call: q [B, Hq, D]; k/v [B, Hkv, S, D] or, paged,
    the pool [Hkv, P, page_size, D]; kv_len [B]."""
    what = "k/v pages [Hkv,P,ps,D]" if paged else "k/v [B,Hkv,S,D]"
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B,Hq,D], {what} expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    hkv = k.shape[0] if paged else k.shape[1]
    if (not paged and k.shape[0] != b) or k.shape[3] != d or hq % hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and {what} "
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


def _check_kernel_inputs(name, q, k, v, hkv, kv_len, *tables):
    """What the CUDA kernel takes, beyond :func:`_check_inputs`. Its tile
    loader reads k/v rows ``VEC`` elements a load (csrc/flash_decode.cu),
    so they must be aligned to that."""
    if q.dtype not in DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {q.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"kv_len must be int32, got {kv_len.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, kv_len, *tables)):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    d, g = q.shape[2], q.shape[1] // hkv
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} kernel head_dim must be in {HEAD_DIMS}, got {d}")
    if g > MAX_GROUP:
        raise ValueError(f"{name} kernel GQA group must be <= {MAX_GROUP}, got {g}")
    align = (4 if d >= 128 else 2 if d >= 64 else 1) * q.element_size()
    if k.data_ptr() % align or v.data_ptr() % align:
        raise ValueError(f"{name} kernel needs k/v aligned to {align} bytes")


def _kernel_outputs(q, hkv, ns):
    """``(result, output pointers)``: o for one split, else the f32
    partials ``(acc [B,Hkv,ns,G,D], m, l [B,Hkv,ns,G])``."""
    b, hq, d = q.shape
    if ns == 1:
        o = torch.empty_like(q)
        return o, (o.data_ptr(), None, None, None)
    f32 = dict(dtype=torch.float32, device=q.device)
    parts = (torch.empty((b, hkv, ns, hq // hkv, d), **f32),
             torch.empty((b, hkv, ns, hq // hkv), **f32),
             torch.empty((b, hkv, ns, hq // hkv), **f32))
    return parts, (None, *(t.data_ptr() for t in parts))


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
    _check_kernel_inputs("flash_decode", q, k, v, k.shape[1], kv_len)
    b, hq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _, ns, _ = split_layout(skv, num_splits)
    out, ptrs = _kernel_outputs(q, hkv, ns)
    fn = _build.kernel_fn("flash_decode", "flash_decode_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), *ptrs,
             b, hq, hkv, skv, d, DTYPES[q.dtype], scale, window or 0, ns,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_decode", err)
    launches += 1
    return out if ns == 1 else _merge_partials(*out, b, hq, q.dtype)


def flash_decode_torch(q, k, v, *, kv_len, window: Optional[int] = None,
                       scale: Optional[float] = None, num_splits: int = 1):
    """The kernel's plain-torch version: the same 128-wide tiles and the same
    split layout, folded through ``common.online_fold`` per split, then the
    f32 partial merge when there is more than one split."""
    return _fold_tiles(q, lambda lo, hi: (k[:, :, lo:hi], v[:, :, lo:hi]),
                       k.shape[1], k.shape[2], kv_len=kv_len, window=window,
                       scale=scale, num_splits=num_splits)


def _fold_tiles(q, read_tile, hkv, skv, *, kv_len, window, scale, num_splits):
    """The plain versions' loop: ``read_tile(lo, hi)`` gives the K/V rows
    ``[lo, hi)`` of every row as ``[B, Hkv, hi - lo, D]``. Rows the query may
    not read are zeroed before the fold, as the kernel never loads them
    (a trash or reclaimed page may hold anything)."""
    b, hq, d = q.shape
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
            allowed = kp < kv_len                              # [B,1,1,n]
            if window is not None:
                allowed = allowed & (kp > q_pos - window)
            kt, vt = read_tile(lo, hi)
            unread = ~allowed[:, :, 0, :, None]                # [B,1,n,1]
            kt, vt = kt.masked_fill(unread, 0), vt.masked_fill(unread, 0)
            s = torch.einsum("bhgd,bhkd->bhgk", qg, kt.float()) * scale
            s = torch.where(allowed, s, NEG_INF)
            state = online_fold(state, s, vt)
        parts.append(state)
    if ns == 1:
        o, _ = osm.finalize(parts[0], out_dtype=q.dtype)
        return o.reshape(b, hq, d)
    acc = torch.stack([s.acc for s in parts], dim=2)       # [B,Hkv,ns,G,D]
    m = torch.stack([s.m for s in parts], dim=2)
    l = torch.stack([s.l for s in parts], dim=2)
    return _merge_partials(acc, m, l, b, hq, q.dtype)


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------

def gather_pages(pages, block_tables):
    """A page pool as a contiguous cache: pages [Hkv, P, page_size, D],
    block_tables [B, T] → [B, Hkv, T·page_size, D] (counterpart of JAX
    ``ops.gather_pages``)."""
    hkv, _, ps, d = pages.shape
    b, t = block_tables.shape
    g = pages[:, block_tables.long()]                      # [Hkv, B, T, ps, D]
    return g.transpose(0, 1).contiguous().view(b, hkv, t * ps, d)


def flash_paged_decode(q, k_pages, v_pages, block_tables, kv_len, *,
                       window: Optional[int] = None,
                       scale: Optional[float] = None, num_splits: int = 1):
    """q [B, Hq, D]; k_pages/v_pages [Hkv, P, page_size, D]; block_tables
    [B, T] int32 (every entry a valid page id: the trash page 0 past a row's
    allocation); kv_len [B] int32.

    Returns o [B, Hq, D] in q.dtype; rows with kv_len == 0 are exact zeros.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (f32 or bf16, contiguous, int32 tables and kv_len, D in ``HEAD_DIMS``,
    Hq / Hkv <= ``MAX_GROUP``) or raises.
    """
    _check_inputs(q, k_pages, v_pages, kv_len, window, num_splits, paged=True)
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0] \
            or block_tables.device != q.device:
        raise ValueError(f"block_tables must be [B, T] on {q.device}, got "
                         f"{tuple(block_tables.shape)} on {block_tables.device}")
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_paged_decode_torch(q, k_pages, v_pages, block_tables,
                                        kv_len=kv_len, window=window,
                                        scale=scale, num_splits=num_splits)
    if q.device.type != "cuda":
        raise ValueError(f"flash_paged_decode runs on cuda or cpu, not {q.device}")
    return _launch_paged(q, k_pages, v_pages, block_tables, kv_len, window,
                         scale, num_splits)


def _launch_paged(q, k_pages, v_pages, block_tables, kv_len, window, scale,
                  num_splits):
    global launches_paged
    hkv, n_pages, ps, d = k_pages.shape
    _check_kernel_inputs("flash_paged_decode", q, k_pages, v_pages, hkv, kv_len,
                         block_tables)
    if block_tables.dtype != torch.int32:
        raise TypeError(f"block_tables must be int32, got {block_tables.dtype}")
    b, hq, _ = q.shape
    t = block_tables.shape[1]
    _, ns, _ = split_layout(t * ps, num_splits)
    out, ptrs = _kernel_outputs(q, hkv, ns)
    fn = _build.kernel_fn("flash_decode", "flash_paged_decode_launch",
                          _PAGED_ARGTYPES)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), kv_len.data_ptr(), *ptrs,
             b, hq, hkv, n_pages, ps, t, d, DTYPES[q.dtype], scale, window or 0,
             ns, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_decode", err)
    launches_paged += 1
    return out if ns == 1 else _merge_partials(*out, b, hq, q.dtype)


def flash_paged_decode_torch(q, k_pages, v_pages, block_tables, *, kv_len,
                             window: Optional[int] = None,
                             scale: Optional[float] = None,
                             num_splits: int = 1):
    """The paged kernel's plain-torch version: the contiguous version's tiles
    and splits, each tile's rows read through the block table (position
    ``pos`` of row b is row ``pos % ps`` of page ``block_tables[b, pos // ps]``)."""
    hkv, _, ps, _ = k_pages.shape
    bt = block_tables.long()

    def read_tile(lo, hi):
        pos = torch.arange(lo, hi, device=q.device)
        page = bt[:, pos // ps]                                # [B, n]
        off = (pos % ps)[None, :]
        return (k_pages[:, page, off].transpose(0, 1),         # [B, Hkv, n, D]
                v_pages[:, page, off].transpose(0, 1))

    return _fold_tiles(q, read_tile, hkv, bt.shape[1] * ps, kv_len=kv_len,
                       window=window, scale=scale, num_splits=num_splits)
