"""SparkAttention public API of the port (counterpart of ``repro.core.attention``).

One entry point, three interchangeable execution paths:

* ``impl="kernel"`` — the hand-written CUDA kernels on a CUDA tensor (their
  plain-torch versions on a CPU tensor).
* ``impl="torch"``  — the same online-softmax algorithm as a chunked loop in
  plain torch; O(chunk) memory (the counterpart of ``impl="xla"``).
* ``impl="naive"``  — the unfused baseline; O(N²) memory.

All paths are numerically interchangeable and differentiable (the tests
assert it).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import online_softmax as osm
from repro_torch.core.online_softmax import NEG_INF
from repro_torch.kernels import ops
from repro_torch.kernels.ops import AttnConfig
from repro_torch.kernels.ref import _expand_kv

IMPLS = ("kernel", "torch", "naive")


def spark_attention(q, k, v, *, impl: str = "kernel", seed=0,
                    causal: bool = False, window: Optional[int] = None,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    segment_ids=None, acc_dtype=torch.float32,
                    bwd_acc_dtype=torch.float32, torch_chunk: int = 1024,
                    batch_offset: int = 0, head_offset: int = 0):
    """Fused MHA. q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] → [B,Hq,Sq,D].

    segment_ids: optional [B, Skv] int32 per-token segment ids for packed
    batches — attention never crosses a segment boundary, negative ids mark
    padding tokens that attend to nothing. ``acc_dtype`` / ``bwd_acc_dtype``
    (bf16-ACC) reach the kernels' forward and backward; the plain paths
    compute in f32, as JAX's. ``batch_offset`` / ``head_offset``: the
    global batch row and q head of ``q[0, 0]`` that the dropout mask hashes
    (a rank's shard of the batch and the heads draws the single-device
    masks), on every impl.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    off = dict(batch_offset=batch_offset, head_offset=head_offset)
    cfg = AttnConfig(causal=causal, window=window, scale=scale,
                     dropout_rate=dropout_rate, acc_dtype=acc_dtype,
                     bwd_acc_dtype=bwd_acc_dtype)
    if impl == "kernel":
        return ops.mha(q, k, v, seed=seed, segment_ids=segment_ids, config=cfg,
                       **off)
    if impl == "torch":
        return ops.mha_torch(q, k, v, seed=seed, segment_ids=segment_ids,
                             config=cfg, chunk=torch_chunk, **off)
    return ops.mha_reference(q, k, v, seed=seed, segment_ids=segment_ids,
                             config=cfg, **off)


def spark_decode(q, k, v, *, impl: str = "kernel", kv_len=None,
                 window: Optional[int] = None, scale: Optional[float] = None,
                 num_splits: int = 1):
    """Single-token decode against a KV cache. q [B,Hq,D] → [B,Hq,D].

    ``num_splits > 1`` runs the split-KV scheme on every impl: the KV axis is
    cut into that many slices whose un-normalised (acc, m, l) states merge in
    f32 (``online_softmax.merge_many``).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel":
        return ops.decode(q, k, v, kv_len=kv_len, window=window, scale=scale,
                          num_splits=num_splits)
    # plain path: one query row, so the direct masked form is already
    # O(S) memory; splits mirror the kernel's partial-state algebra
    if num_splits > 1:
        acc, m, l = _torch_split_decode_partials(
            q, k, v, kv_len=kv_len, window=window, scale=scale,
            num_splits=num_splits)
        o, _ = osm.finalize(osm.SoftmaxState(m=m, l=l, acc=acc),
                            out_dtype=q.dtype)
        return o
    return _torch_masked_decode(q, k, v, kv_len=kv_len, window=window,
                                scale=scale)


def spark_decode_partials(q, k, v, *, impl: str = "kernel", kv_len=None,
                          window: Optional[int] = None,
                          scale: Optional[float] = None, num_splits: int = 1):
    """Single-token decode against one shard of a contiguous cache whose
    sequence is split over ranks, stopping at the un-finalised
    online-softmax state: the building block of the distributed
    flash-decode of ``kv_cache_seq`` (``models/layers.py``). q [B,Hq,D];
    k/v [B,Hkv,S_shard,D] the shard's slots; kv_len [B] the count of its
    valid slots (its first ones; 0 where it holds none yet). Returns f32
    ``(acc [B,Hq,D], m [B,Hq], l [B,Hq])``; a row with kv_len 0 keeps
    m == NEG_INF, l == 0, acc == 0. Shards merge with the online-softmax
    algebra and finalise once (``distributed/paged.merge_partials``);
    ``num_splits > 1`` merges split-KV partials within the shard first."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel":
        return ops.decode_partials(q, k, v, kv_len=kv_len, window=window,
                                   scale=scale, num_splits=num_splits)
    if num_splits > 1:
        return _torch_split_decode_partials(q, k, v, kv_len=kv_len,
                                            window=window, scale=scale,
                                            num_splits=num_splits)
    return _torch_masked_decode_partials(q, k, v, kv_len=kv_len, window=window,
                                         scale=scale)


def spark_paged_decode(q, k_pages, v_pages, block_tables, kv_len, *,
                       impl: str = "kernel", window: Optional[int] = None,
                       scale: Optional[float] = None, num_splits: int = 1,
                       row_tokens: int = 1):
    """Single-token decode against a paged KV cache (the serving engine's
    attention). q [B,Hq,D]; k_pages/v_pages [Hkv,P,page_size,D], a pool
    shared by all rows; block_tables [B,T] int32, the physical page of each
    logical block (entries past a row's allocation hold the trash page 0);
    kv_len [B] int32. → [B,Hq,D].

    ``impl="kernel"`` reads the pages through the table inside the CUDA
    kernel; the plain impls gather the pages into a contiguous cache and run
    :func:`spark_decode`'s masked decode (JAX's XLA path), split-KV over the
    gathered length when ``num_splits > 1``. ``row_tokens`` is the kernel's
    launch hint (``kernels/decode.py``): S when the rows are S token rows of
    each batch row flattened (chunked prefill, verify); the plain impls
    ignore it.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel":
        return ops.paged_decode(q, k_pages, v_pages, block_tables, kv_len,
                                window=window, scale=scale,
                                num_splits=num_splits, row_tokens=row_tokens)
    return spark_decode(q, ops.gather_pages(k_pages, block_tables),
                        ops.gather_pages(v_pages, block_tables), impl=impl,
                        kv_len=kv_len, window=window, scale=scale,
                        num_splits=num_splits)


def spark_paged_decode_partials(q, k_pages, v_pages, block_tables, kv_len, *,
                                block_valid=None, impl: str = "kernel",
                                window: Optional[int] = None,
                                scale: Optional[float] = None,
                                num_splits: int = 1, row_tokens: int = 1):
    """Paged decode stopping at the un-finalised online-softmax state: the
    building block of distributed paged serving.

    Each shard of a page-sharded pool calls it with its local pages, a
    block table remapped to local ids and ``block_valid [B, T]`` marking the
    entries it owns (the others name the local trash page and are never
    read). Returns f32 ``(acc [B,Hq,D], m [B,Hq], l [B,Hq])``; shards merge
    with the online-softmax algebra and finalise once
    (``distributed/paged.py``). ``num_splits > 1`` merges split-KV partials
    within the shard first, which composes with the cross-shard merge.

    ``impl="kernel"`` gates per row inside the CUDA kernel (``row_tokens``
    as in :func:`spark_paged_decode`); the plain impls gather the pages and
    gate per position with ``block_valid`` repeated over each page's rows,
    as JAX's XLA path does.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel":
        return ops.paged_decode_partials(
            q, k_pages, v_pages, block_tables, kv_len, block_valid=block_valid,
            window=window, scale=scale, num_splits=num_splits,
            row_tokens=row_tokens)
    ps = k_pages.shape[2]
    pos_valid = None
    if block_valid is not None:
        pos_valid = block_valid.bool().repeat_interleave(ps, dim=1)
    k = ops.gather_pages(k_pages, block_tables)
    v = ops.gather_pages(v_pages, block_tables)
    if num_splits > 1:
        return _torch_split_decode_partials(
            q, k, v, kv_len=kv_len, window=window, scale=scale,
            pos_valid=pos_valid, num_splits=num_splits)
    return _torch_masked_decode_partials(q, k, v, kv_len=kv_len, window=window,
                                         scale=scale, pos_valid=pos_valid)


def _torch_masked_decode(q, k, v, *, kv_len=None, window=None, scale=None):
    acc, m, l = _torch_masked_decode_partials(q, k, v, kv_len=kv_len,
                                              window=window, scale=scale)
    o, _ = osm.finalize(osm.SoftmaxState(m=m, l=l, acc=acc), out_dtype=q.dtype)
    return o


def _torch_masked_decode_partials(q, k, v, *, kv_len=None, window=None,
                                  scale=None, pos_valid=None, kv_start=0):
    """Masked single-query decode, stopping at the un-normalised state
    (acc, m, l) over this slice's positions (``pos_valid [B, Skv]``, if
    given, gates the positions a pool shard owns). ``kv_start`` offsets the
    slice's global positions (``kv_len``/``window`` stay global).
    Fully-masked rows keep ``m == NEG_INF, l == 0, acc == 0``."""
    b, hq, d = q.shape
    skv = k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bhd,bhkd->bhk", q.float(),
                     _expand_kv(k, hq).float()) * scale
    kp = kv_start + torch.arange(skv, device=q.device)[None, None, :]
    if kv_len is None:
        kv_len = torch.full((b,), kv_start + skv, dtype=torch.int32,
                            device=q.device)
    L = kv_len.to(torch.int64)[:, None, None]
    allowed = kp < L
    if window is not None:
        allowed &= kp > (L - 1) - window
    if pos_valid is not None:
        allowed &= pos_valid[:, None, :]
    s = torch.where(allowed, s, NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.where(m == NEG_INF, torch.zeros_like(m), m)
    p = torch.where(allowed, torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhk,bhkd->bhd", p, _expand_kv(v, hq).float())
    return acc, m, l


def _torch_split_decode_partials(q, k, v, *, kv_len=None, window=None,
                                 scale=None, pos_valid=None, num_splits=2):
    """Split-KV decode in plain torch: the KV axis is cut into ``num_splits``
    contiguous slices, each slice's state comes from
    :func:`_torch_masked_decode_partials` at its global offset, and the
    stacked states merge with ``online_softmax.merge_many``."""
    b = q.shape[0]
    skv = k.shape[2]
    num_splits = max(1, min(num_splits, skv))
    chunk = -(-skv // num_splits)
    if kv_len is None:
        kv_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    parts = []
    for lo in range(0, skv, chunk):
        hi = min(lo + chunk, skv)
        pv = None if pos_valid is None else pos_valid[:, lo:hi]
        acc, m, l = _torch_masked_decode_partials(
            q, k[:, :, lo:hi], v[:, :, lo:hi], kv_len=kv_len, window=window,
            scale=scale, pos_valid=pv, kv_start=lo)
        parts.append(osm.SoftmaxState(m=m, l=l, acc=acc))
    state = osm.merge_many(osm.SoftmaxState(
        m=torch.stack([p.m for p in parts]), l=torch.stack([p.l for p in parts]),
        acc=torch.stack([p.acc for p in parts])), axis=0)
    return state.acc, state.m, state.l
