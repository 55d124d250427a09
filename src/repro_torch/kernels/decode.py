"""Flash-decode: the CUDA kernel's wrappers and their plain versions.

Counterpart of ``repro.kernels.decode.flash_decode`` (contiguous cache) and
``flash_paged_decode`` (page pool). One query token per row attends to its
cache over the first ``kv_len[b]`` positions, optionally gated by a sliding
window. The GQA group ``G = Hq // Hkv`` shares every K/V tile.
``num_splits > 1`` cuts the 64-wide KV tiles into that many contiguous
slices, each folded into raw f32 ``(acc, m, l)`` partials;
:func:`_split_states` + ``merge_many`` + ``finalize`` combine them in plain
torch (plain XLA in JAX).

The cache is contiguous, ``k/v [B, Hkv, S, D]``, or paged: a pool
``k_pages/v_pages [Hkv, P, page_size, D]`` shared by all rows and read
through ``block_tables [B, T]`` (row b's logical block j lives in page
``block_tables[b, j]``; entries past a row's allocation name the trash page
0). The paged kernel walks the same 64-row tiles as the contiguous one and
resolves each row through the table, so on gathered pages the two agree
bit for bit (at head dim 256 both fold each tile as two 32-row halves,
the plain versions whole tiles: f32 sums in another order). JAX folds page-sized blocks and splits the table width; the
port splits the tiles: equal within the f32 tolerance.

:func:`flash_paged_decode_partials` is the gated variant for one shard of
a page-sharded pool (counterpart of JAX ``flash_paged_decode_partials``):
``block_valid [B, T]`` marks the table entries the shard owns (the others
name its local trash page), a row is read only if its page is owned, and
the result is the un-finalised f32 state ``(acc, m, l)`` with the local
splits already merged, for the cross-shard merge of
``distributed/paged.py``.

:func:`flash_decode_partials` is the contiguous kernel's raw-partials
mode for one shard of a cache whose sequence is split over ranks
(``kv_cache_seq`` decode, ``models/layers.py``): the same launch writing
``(acc, m, l)`` in place of o, merged across ranks by
``distributed/paged.merge_partials``.

On a CUDA tensor :func:`flash_decode` / :func:`flash_decode_partials` /
:func:`flash_paged_decode` / :func:`flash_paged_decode_partials` launch
``csrc/flash_decode.cu``: a
cluster of blocks per (rows, kv head, split) deals the split's tiles over
its blocks and merges their states on chip. ``row_tokens`` is a launch
hint that changes no result beyond rounding: a chunked-prefill or verify
call, whose rows are S token rows of each batch row flattened, passes S,
and the kernel folds each tile once for every run of consecutive rows that
read one table (on tensor cores); decode passes 1 (the default), one row a
block (:func:`launch_geometry` gives the shape of a launch). On a CPU
tensor they run :func:`flash_decode_torch` /
:func:`flash_decode_partials_torch` / :func:`flash_paged_decode_torch` /
:func:`flash_paged_decode_partials_torch`,
the same tiles and splits in plain torch, one row at a time; the kernel's
cluster merge orders the f32 sums of a split differently.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import online_softmax as osm
from repro_torch.core.online_softmax import NEG_INF
from repro_torch.kernels import _build
from repro_torch.kernels.common import online_fold
from repro_torch.kernels.flash_fwd import DTYPES

TILE = 64        # BKV in csrc/flash_decode.cu: the split layout's tile
#: head dims ``csrc/flash_decode.cu`` is instantiated for: the forward's but
#: 80, whose one arch (hubert-xlarge, an encoder) has no decode step
HEAD_DIMS = (16, 32, 64, 128, 256)


def max_group(head_dim: int) -> int:
    """The largest GQA group the kernel takes at ``head_dim``
    (``max_group`` in ``csrc/flash_decode.cu``: the query rows of a
    one-row block): 8, and 16 at D 256, whose one-row block has 8 warps."""
    return 16 if head_dim > 128 else 8


#: kernel launches since the last reset (the plain versions do not count):
#: contiguous cache, its shard partials, paged cache, gated paged cache
#: (partials)
launches = 0
launches_partials = 0
launches_paged = 0
launches_paged_valid = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3 + [_P]
_PAGED_ARGTYPES = [_P] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 3 + [_P]
_GEOMETRY_ARGTYPES = [ctypes.c_int] * 9 + [_P]


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


def _merge_states(acc, m, l, b, hq) -> osm.SoftmaxState:
    """The splits' partials merged into one un-finalised state, m/l
    [B, Hq] and acc [B, Hq, D]. One split is already that state (the merge
    would scale it by exp(0) = 1): it is only reshaped."""
    state = _split_states(acc, m, l, b, hq)
    if acc.shape[2] == 1:
        return osm.SoftmaxState(m=state.m[:, 0], l=state.l[:, 0],
                                acc=state.acc[:, 0])
    return osm.merge_many(state, axis=1)


def _merge_partials(acc, m, l, b, hq, out_dtype):
    o, _ = osm.finalize(_merge_states(acc, m, l, b, hq), out_dtype=out_dtype)
    return o


def _check_inputs(q, k, v, kv_len, window, num_splits, *, paged=False,
                  row_tokens=1):
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
    if row_tokens < 1:
        raise ValueError(f"row_tokens must be >= 1, got {row_tokens}")


def _check_kernel_inputs(name, q, k, v, hkv, kv_len, *tables):
    """What the CUDA kernel takes, beyond :func:`_check_inputs`. Its tile
    loader copies k/v rows and reads q 16 bytes a lane, so they must be
    aligned to 16 bytes."""
    if q.dtype not in DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {q.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"kv_len must be int32, got {kv_len.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, kv_len, *tables)):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    d, g = q.shape[2], q.shape[1] // hkv
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} kernel head_dim must be in {HEAD_DIMS}, got {d}")
    if g > max_group(d):
        raise ValueError(f"{name} kernel GQA group must be <= {max_group(d)} at "
                         f"head_dim {d}, got {g}")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs q, k, v aligned to 16 bytes")


def _kernel_outputs(q, hkv, ns, partials=False):
    """``(result, output pointers)``: o for one split (unless ``partials``),
    else the f32 partials ``(acc [B,Hkv,ns,G,D], m, l [B,Hkv,ns,G])``; with
    one split those are already the merged state, ``acc [B,Hq,D]`` and
    ``m, l [B,Hq]`` (the same memory layout)."""
    b, hq, d = q.shape
    if ns == 1 and not partials:
        o = torch.empty_like(q)
        return o, (o.data_ptr(), None, None, None)
    f32 = dict(dtype=torch.float32, device=q.device)
    lead = (b, hq) if ns == 1 else (b, hkv, ns, hq // hkv)
    parts = (torch.empty((*lead, d), **f32), torch.empty(lead, **f32),
             torch.empty(lead, **f32))
    return parts, (None, *(t.data_ptr() for t in parts))


def launch_geometry(rows: int, hq: int, hkv: int, skv: int,
                    num_splits: int = 1, *, row_tokens: int = 1,
                    head_dim: int = 64, dtype=torch.float32,
                    paged: bool = True) -> dict:
    """The shape of a kernel launch of ``rows`` rows over ``skv`` cache rows
    each on the current card: ``{"rows_per_block", "cluster", "blocks",
    "resident_clusters"}``, the last the clusters of that launch's kernel
    (``dtype``, ``head_dim``, paged or contiguous cache, query tiles or not)
    the card holds at once (``csrc/flash_decode.cu`` ``geometry``,
    ``cudaOccupancyMaxActiveClusters``). Needs a card."""
    _, ns, _ = split_layout(skv, num_splits)
    out = (ctypes.c_int * 4)()
    fn = _build.kernel_fn("flash_decode", "flash_decode_geometry",
                          _GEOMETRY_ARGTYPES)
    _build.check("flash_decode", fn(rows, hq, hkv, skv, head_dim, DTYPES[dtype],
                                    int(paged), ns, row_tokens,
                                    ctypes.addressof(out)))
    return {"rows_per_block": out[0], "cluster": out[1], "blocks": out[2],
            "resident_clusters": out[3]}


def flash_decode(q, k, v, *, kv_len=None, window: Optional[int] = None,
                 scale: Optional[float] = None, num_splits: int = 1,
                 row_tokens: int = 1):
    """q [B, Hq, D]; k/v [B, Hkv, S, D]; kv_len [B] int32 (default: full S).

    Returns o [B, Hq, D] in q.dtype; rows with kv_len == 0 are exact zeros.
    ``row_tokens``: the launch hint of the module docstring (no two rows of
    a contiguous cache share one, so it only slows this kernel; it takes
    the hint so that it can be held bit for bit against the paged one).
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (f32 or bf16, contiguous, int32 kv_len, D in ``HEAD_DIMS``,
    Hq / Hkv <= ``max_group(D)``) or raises.
    """
    b, skv = q.shape[0], k.shape[2]
    if kv_len is None:
        kv_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    _check_inputs(q, k, v, kv_len, window, num_splits, row_tokens=row_tokens)
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_decode_torch(q, k, v, kv_len=kv_len, window=window,
                                  scale=scale, num_splits=num_splits)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    return _launch(q, k, v, kv_len, window, scale, num_splits, row_tokens)


def _launch(q, k, v, kv_len, window, scale, num_splits, row_tokens):
    global launches
    _check_kernel_inputs("flash_decode", q, k, v, k.shape[1], kv_len)
    b, hq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _, ns, _ = split_layout(skv, num_splits)
    out, ptrs = _kernel_outputs(q, hkv, ns)
    fn = _build.kernel_fn("flash_decode", "flash_decode_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), *ptrs,
             b, hq, hkv, skv, d, DTYPES[q.dtype], scale, window or 0, ns,
             row_tokens, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_decode", err)
    launches += 1
    return out if ns == 1 else _merge_partials(*out, b, hq, q.dtype)


def flash_decode_partials(q, k, v, *, kv_len=None,
                          window: Optional[int] = None,
                          scale: Optional[float] = None, num_splits: int = 1):
    """:func:`flash_decode` stopping at the online-softmax state, for one
    shard of a cache whose sequence is split over ranks (the contiguous
    cache under ``kv_cache_seq``): ``k/v [B, Hkv, S_shard, D]`` are the
    shard's slots and ``kv_len [B]`` the count of its valid ones (the ring
    fills slots in order, so they are its first ``kv_len``). Returns the f32
    state ``(acc [B,Hq,D], m [B,Hq], l [B,Hq])``, the local splits merged
    by ``merge_many``; a row with ``kv_len`` 0 keeps m == NEG_INF, l == 0,
    acc == 0, so the cross-shard merge (``distributed/paged.py``
    ``merge_partials``) gives exact zeros only for rows empty on every
    shard. A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (as :func:`flash_decode`) or raises."""
    b, skv = q.shape[0], k.shape[2]
    if kv_len is None:
        kv_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    _check_inputs(q, k, v, kv_len, window, num_splits)
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_decode_partials_torch(q, k, v, kv_len=kv_len,
                                           window=window, scale=scale,
                                           num_splits=num_splits)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_partials runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch_partials(q, k, v, kv_len, window, scale, num_splits)


def _launch_partials(q, k, v, kv_len, window, scale, num_splits):
    global launches_partials
    _check_kernel_inputs("flash_decode_partials", q, k, v, k.shape[1], kv_len)
    b, hq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _, ns, _ = split_layout(skv, num_splits)
    parts, ptrs = _kernel_outputs(q, hkv, ns, partials=True)
    fn = _build.kernel_fn("flash_decode", "flash_decode_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), *ptrs,
             b, hq, hkv, skv, d, DTYPES[q.dtype], scale, window or 0, ns, 1,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_decode", err)
    launches_partials += 1
    if ns == 1:
        return parts
    state = _merge_states(*parts, b, hq)
    return state.acc, state.m, state.l


def flash_decode_partials_torch(q, k, v, *, kv_len,
                                window: Optional[int] = None,
                                scale: Optional[float] = None,
                                num_splits: int = 1):
    """The shard-partials mode's plain-torch version: :func:`flash_decode_torch`'s
    tiles and splits, stopping at the merged f32 state ``(acc [B,Hq,D],
    m [B,Hq], l [B,Hq])``."""
    b, hq = q.shape[:2]
    parts = _fold_tile_states(q, lambda lo, hi: (k[:, :, lo:hi], v[:, :, lo:hi]),
                              k.shape[1], k.shape[2], kv_len=kv_len,
                              window=window, scale=scale, num_splits=num_splits)
    state = _merge_states(*_stack_states(parts), b, hq)
    return state.acc, state.m, state.l


def flash_decode_torch(q, k, v, *, kv_len, window: Optional[int] = None,
                       scale: Optional[float] = None, num_splits: int = 1):
    """The kernel's plain-torch version: the same 64-wide tiles and the same
    split layout, folded through ``common.online_fold`` per split, then the
    f32 partial merge when there is more than one split."""
    return _fold_tiles(q, lambda lo, hi: (k[:, :, lo:hi], v[:, :, lo:hi]),
                       k.shape[1], k.shape[2], kv_len=kv_len, window=window,
                       scale=scale, num_splits=num_splits)


def _fold_tiles(q, read_tile, hkv, skv, *, kv_len, window, scale, num_splits):
    """The plain versions' loop, finalised: o [B, Hq, D] in q.dtype."""
    b, hq, d = q.shape
    parts = _fold_tile_states(q, read_tile, hkv, skv, kv_len=kv_len,
                              window=window, scale=scale, num_splits=num_splits)
    if len(parts) == 1:
        o, _ = osm.finalize(parts[0], out_dtype=q.dtype)
        return o.reshape(b, hq, d)
    return _merge_partials(*_stack_states(parts), b, hq, q.dtype)


def _stack_states(parts):
    """Per-split states ``[B, Hkv, G(, D)]`` → the kernel's partials
    ``(acc [B,Hkv,ns,G,D], m, l [B,Hkv,ns,G])``."""
    return (torch.stack([s.acc for s in parts], dim=2),
            torch.stack([s.m for s in parts], dim=2),
            torch.stack([s.l for s in parts], dim=2))


def _fold_tile_states(q, read_tile, hkv, skv, *, kv_len, window, scale,
                      num_splits, row_owned=None):
    """The plain versions' loop: ``read_tile(lo, hi)`` gives the K/V rows
    ``[lo, hi)`` of every row as ``[B, Hkv, hi - lo, D]``. Rows the query may
    not read are zeroed before the fold, as the kernel never loads them
    (a trash or reclaimed page may hold anything). ``row_owned(lo, hi)``
    (optional, ``[B, hi - lo]`` bool) gates rows further, as the kernel's
    ownership gate does. Returns one ``SoftmaxState`` per split, m/l
    ``[B, Hkv, G]`` and acc ``[B, Hkv, G, D]``."""
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
            if row_owned is not None:
                allowed = allowed & row_owned(lo, hi)[:, None, None, :]
            kt, vt = read_tile(lo, hi)
            unread = ~allowed[:, :, 0, :, None]                # [B,1,n,1]
            kt, vt = kt.masked_fill(unread, 0), vt.masked_fill(unread, 0)
            s = torch.einsum("bhgd,bhkd->bhgk", qg, kt.float()) * scale
            s = torch.where(allowed, s, NEG_INF)
            state = online_fold(state, s, vt)
        parts.append(state)
    return parts


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
                       scale: Optional[float] = None, num_splits: int = 1,
                       row_tokens: int = 1):
    """q [B, Hq, D]; k_pages/v_pages [Hkv, P, page_size, D]; block_tables
    [B, T] int32 (every entry a valid page id: the trash page 0 past a row's
    allocation); kv_len [B] int32; ``row_tokens`` the launch hint of the
    module docstring (S for B·S flattened token rows, 1 for decode).

    Returns o [B, Hq, D] in q.dtype; rows with kv_len == 0 are exact zeros.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (f32 or bf16, contiguous, int32 tables and kv_len, D in ``HEAD_DIMS``,
    Hq / Hkv <= ``max_group(D)``) or raises.
    """
    _check_inputs(q, k_pages, v_pages, kv_len, window, num_splits, paged=True,
                  row_tokens=row_tokens)
    _check_tables(q, block_tables)
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_paged_decode_torch(q, k_pages, v_pages, block_tables,
                                        kv_len=kv_len, window=window,
                                        scale=scale, num_splits=num_splits)
    if q.device.type != "cuda":
        raise ValueError(f"flash_paged_decode runs on cuda or cpu, not {q.device}")
    return _launch_paged(q, k_pages, v_pages, block_tables, kv_len, window,
                         scale, num_splits, row_tokens)


def _check_tables(q, block_tables, block_valid=None):
    """block_tables [B, T] (and block_valid [B, T]) on q's device."""
    for name, t in (("block_tables", block_tables), ("block_valid", block_valid)):
        if t is None:
            continue
        if t.dim() != 2 or t.shape[0] != q.shape[0] or t.device != q.device \
                or t.shape != block_tables.shape:
            raise ValueError(f"{name} must be [B, T] on {q.device}, got "
                             f"{tuple(t.shape)} on {t.device}")


def _launch_paged(q, k_pages, v_pages, block_tables, kv_len, window, scale,
                  num_splits, row_tokens):
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
             ns, row_tokens, torch.cuda.current_stream(q.device).cuda_stream)
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
    return _fold_tiles(q, _page_reader(k_pages, v_pages, block_tables), hkv,
                       block_tables.shape[1] * ps, kv_len=kv_len,
                       window=window, scale=scale, num_splits=num_splits)


def _page_reader(k_pages, v_pages, block_tables):
    """``read_tile`` of the paged plain versions: position ``pos`` of row b
    is row ``pos % ps`` of page ``block_tables[b, pos // ps]``."""
    ps = k_pages.shape[2]
    bt = block_tables.long()

    def read_tile(lo, hi):
        pos = torch.arange(lo, hi, device=bt.device)
        page = bt[:, pos // ps]                                # [B, n]
        off = (pos % ps)[None, :]
        return (k_pages[:, page, off].transpose(0, 1),         # [B, Hkv, n, D]
                v_pages[:, page, off].transpose(0, 1))

    return read_tile


# ---------------------------------------------------------------------------
# gated paged cache: one shard of a page-sharded pool, raw partials
# ---------------------------------------------------------------------------

def flash_paged_decode_partials(q, k_pages, v_pages, block_tables, kv_len, *,
                                block_valid=None, window: Optional[int] = None,
                                scale: Optional[float] = None,
                                num_splits: int = 1, row_tokens: int = 1):
    """Paged flash-decode stopping at the online-softmax state, for one
    shard of a page-sharded pool (counterpart of JAX
    ``flash_paged_decode_partials``).

    Arguments as :func:`flash_paged_decode`, plus ``block_valid [B, T]``
    int32 (0: a table entry this shard does not own, remapped to its local
    trash page; None: every entry is owned). A position is read only if it
    lies inside kv_len and the window and its page is owned. Returns the
    f32 state ``(acc [B,Hq,D], m [B,Hq], l [B,Hq])``, the local splits
    merged by ``merge_many``; a row that reads nothing keeps m == NEG_INF,
    l == 0, acc == 0. A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (as :func:`flash_paged_decode`, int32 block_valid)
    or raises.
    """
    _check_inputs(q, k_pages, v_pages, kv_len, window, num_splits, paged=True,
                  row_tokens=row_tokens)
    _check_tables(q, block_tables, block_valid)
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_paged_decode_partials_torch(
            q, k_pages, v_pages, block_tables, kv_len=kv_len,
            block_valid=block_valid, window=window, scale=scale,
            num_splits=num_splits)
    if q.device.type != "cuda":
        raise ValueError(f"flash_paged_decode_partials runs on cuda or cpu, "
                         f"not {q.device}")
    return _launch_paged_valid(q, k_pages, v_pages, block_tables, block_valid,
                               kv_len, window, scale, num_splits, row_tokens)


def _launch_paged_valid(q, k_pages, v_pages, block_tables, block_valid, kv_len,
                        window, scale, num_splits, row_tokens):
    global launches_paged_valid
    hkv, n_pages, ps, d = k_pages.shape
    tables = (block_tables,) if block_valid is None else (block_tables, block_valid)
    _check_kernel_inputs("flash_paged_decode_partials", q, k_pages, v_pages,
                         hkv, kv_len, *tables)
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError(f"block_tables and block_valid must be int32, got "
                        f"{[t.dtype for t in tables]}")
    b, hq, _ = q.shape
    t = block_tables.shape[1]
    _, ns, _ = split_layout(t * ps, num_splits)
    parts, ptrs = _kernel_outputs(q, hkv, ns, partials=True)
    fn = _build.kernel_fn("flash_decode", "flash_paged_decode_partials_launch",
                          _PAGED_ARGTYPES)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(),
             None if block_valid is None else block_valid.data_ptr(),
             kv_len.data_ptr(), *ptrs[1:], b, hq, hkv, n_pages, ps, t, d,
             DTYPES[q.dtype], scale, window or 0, ns, row_tokens,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_decode", err)
    launches_paged_valid += 1
    if ns == 1:
        return parts
    state = _merge_states(*parts, b, hq)
    return state.acc, state.m, state.l


def flash_paged_decode_partials_torch(q, k_pages, v_pages, block_tables, *,
                                      kv_len, block_valid=None,
                                      window: Optional[int] = None,
                                      scale: Optional[float] = None,
                                      num_splits: int = 1):
    """The gated kernel's plain-torch version: the paged version's tiles and
    splits with the same per-row gate (position ``pos`` of row b is read
    only if ``block_valid[b, pos // ps] != 0``), stopping at the merged f32
    state ``(acc [B,Hq,D], m [B,Hq], l [B,Hq])``."""
    hkv, _, ps, _ = k_pages.shape
    b, hq, _ = q.shape
    row_owned = None
    if block_valid is not None:
        def row_owned(lo, hi):
            return block_valid[:, torch.arange(lo, hi, device=q.device) // ps] != 0

    parts = _fold_tile_states(q, _page_reader(k_pages, v_pages, block_tables),
                              hkv, block_tables.shape[1] * ps,
                              kv_len=kv_len, window=window, scale=scale,
                              num_splits=num_splits, row_owned=row_owned)
    state = _merge_states(*_stack_states(parts), b, hq)
    return state.acc, state.m, state.l
