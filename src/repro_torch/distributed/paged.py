"""Distributed paged-KV serving: a page-aligned pool sharded over the ranks
of a :class:`~repro_torch.distributed.mesh.PoolMesh` (counterpart of
``repro.distributed.paged``).

Each rank holds ``P = num_pages / N`` pages of every layer's pool,
``[Hkv, P, page_size, D]``: rank ``s`` owns global pages ``[s·P, (s+1)·P)``.
Block tables keep *global* page ids, so the numpy host layer (allocator,
scheduler) runs unchanged and identically on every rank. Two invariants:

* **Page alignment**: ``num_pages`` divides by the shard count
  (:func:`pages_per_shard` validates); pages never straddle shards.
* **A trash page per shard**: global page ``s·P`` (local page 0 of shard
  ``s``) is reserved (``PagedCacheConfig(num_shards=N)``). A shard remaps
  every table entry it does not own to its local page 0 and sends writes of
  tokens it does not own there, so every local id stays valid.

Decode is local attention per shard plus a collective online-softmax merge:
each rank computes the un-finalised ``(acc, m, l)`` over its own pages
(``spark_paged_decode_partials``), then an ``all_reduce(MAX)`` of ``m`` and
one ``all_reduce(SUM)`` of ``l·a`` and ``acc·a`` packed into one f32
buffer merge the states (two collectives a layer; JAX's ``shard_map`` uses
three). Never the pool itself crosses ranks.

Unlike JAX, which returns new arrays, these functions take this rank's
*local* pools and update them in place. The engine's two in-place pool ops,
which JAX gets from GSPMD, are here too: :func:`copy_pages_sharded`
(copy-on-write, whose source and destination may live on different shards)
and :func:`poison_pages_sharded`.

Each merge is a ``dist.merge`` span (``runtime/tracing.py``) around its
two collectives: the host seconds spent in them, which include waiting for
the stream to reach them. The collectives go through
``collectives.all_reduce_`` over the pool axis, so ``collectives.stats``
and ``collectives.log`` hold them too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import online_softmax as osm
from repro_torch.core.attention import spark_paged_decode_partials
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh import PoolMesh, as_train_mesh
from repro_torch.runtime import tracing


def pages_per_shard(num_pages: int, n_shards: int) -> int:
    """Pages owned by each shard; validates the page-aligned-split invariant."""
    if num_pages % n_shards != 0:
        raise ValueError(
            f"num_pages={num_pages} must divide by the pool shard count "
            f"{n_shards}: sharding is at page granularity (pages never "
            f"straddle shards)")
    per = num_pages // n_shards
    if per < 2:
        raise ValueError(
            f"{per} page(s) per shard leaves no usable page beside the "
            f"per-shard trash page — grow num_pages or shrink the mesh")
    return per


def _local_ids(bt, n_local: int, shard: int):
    """Global table → (local table, ownership mask int32) for one shard."""
    local = bt // n_local == shard
    # non-local entries → local trash page 0 (a valid local id by invariant)
    return (torch.where(local, bt % n_local, torch.zeros_like(bt)),
            local.to(torch.int32))


def merge_partials(acc, m, l, mesh: PoolMesh, out_dtype=None):
    """Cross-shard online-softmax merge and finalize (paper Eq. 3 over
    shards).

    acc [B,H,D], m/l [B,H]: this rank's f32 state. ``all_reduce(MAX)`` of m,
    then one ``all_reduce(SUM)`` of ``[acc·a | l·a]`` with ``a = exp(m -
    m_g)``, then ``online_softmax.finalize``, so rows with no valid position
    on any shard (inactive decode slots) come out as exact zeros. NEG_INF is
    a large *finite* negative, so ``a`` stays NaN-free on empty shards.
    Returns o [B,H,D], identical on every rank; spanned as ``dist.merge``.
    """
    d = acc.shape[-1]
    axis = as_train_mesh(mesh)
    m_g = m.clone()
    with tracing.span("dist.merge"):
        C.all_reduce_(m_g, axis, "model", "max")
        a = torch.exp(m - m_g)   # empty shards: a -> 0 (or l == 0 makes it inert)
        buf = torch.cat([acc * a[..., None], (l * a)[..., None]], dim=-1)
        C.all_reduce_(buf, axis, "model")
    state = osm.SoftmaxState(m=m_g, l=buf[..., d], acc=buf[..., :d])
    o, _ = osm.finalize(state, out_dtype=out_dtype)
    return o


def scatter_pages_sharded(pages, dest, vals, *, mesh: PoolMesh) -> None:
    """Sharded counterpart of ``layers._scatter_pages`` (packed-prefill and
    decode writes), in place.

    pages [Hkv, P_local, ps, D] (this rank's slice); dest [N] *global* flat
    token slots (page·page_size + offset); vals [Hkv, N, D] (replicated).
    Each shard keeps only the writes that land in its pages; the rest go to
    its trash page.
    """
    hkv, p_local, ps, d = pages.shape
    n_local_slots = p_local * ps
    dest = dest.long()
    local_dest = torch.where(dest // n_local_slots == mesh.rank,
                             dest % n_local_slots, torch.zeros_like(dest))
    pages.view(hkv, n_local_slots, d)[:, local_dest] = vals.to(pages.dtype)


def paged_decode_sharded(q, k_pages, v_pages, block_tables, kv_len, *,
                         mesh: PoolMesh, impl: str = "kernel",
                         window: Optional[int] = None,
                         scale: Optional[float] = None, num_splits: int = 1,
                         row_tokens: int = 1):
    """Sharded paged decode, no append: the distributed counterpart of
    ``spark_paged_decode`` (chunked prefill and verify, one decode row per
    token). q [B, Hq, D] replicated; k_pages/v_pages this rank's
    [Hkv, P_local, ps, D]; block_tables [B, T] global ids; kv_len [B].
    ``num_splits`` applies split-KV *within* each shard: the shard-local
    splits merge locally, then across shards; ``row_tokens`` is the
    kernel's launch hint (S for B·S flattened token rows). Returns o
    [B, Hq, D] in q.dtype, identical on every rank."""
    n_local = k_pages.shape[1]
    pages_per_shard(n_local * mesh.size, mesh.size)
    bt_local, valid = _local_ids(block_tables, n_local, mesh.rank)
    acc, m, l = spark_paged_decode_partials(
        q, k_pages, v_pages, bt_local, kv_len, block_valid=valid, impl=impl,
        window=window, scale=scale, num_splits=num_splits,
        row_tokens=row_tokens)
    return merge_partials(acc, m, l, mesh, out_dtype=q.dtype)


def paged_append_decode_sharded(q, k_new, v_new, k_pages, v_pages,
                                block_tables, kv_len, *, mesh: PoolMesh,
                                impl: str = "kernel",
                                window: Optional[int] = None,
                                scale: Optional[float] = None,
                                num_splits: int = 1):
    """One sharded paged-decode step: append this token's K/V, then attend.

    q/k_new/v_new [B, H(kv), D] (replicated); k_pages/v_pages this rank's
    [Hkv, P_local, ps, D], updated in place (JAX returns new pools);
    block_tables [B, T] global ids; kv_len [B] pre-append lengths. Returns
    o [B, Hq, D], identical on every rank.
    """
    ps = k_pages.shape[2]
    page = block_tables.gather(1, (kv_len // ps)[:, None].long())[:, 0]
    dest = page.long() * ps + kv_len % ps                     # [B] global slots
    scatter_pages_sharded(k_pages, dest, k_new.transpose(0, 1), mesh=mesh)
    scatter_pages_sharded(v_pages, dest, v_new.transpose(0, 1), mesh=mesh)
    return paged_decode_sharded(q, k_pages, v_pages, block_tables, kv_len + 1,
                                mesh=mesh, impl=impl, window=window,
                                scale=scale, num_splits=num_splits)


def copy_pages_sharded(pools: Sequence[torch.Tensor], src, dst,
                       mesh: PoolMesh) -> None:
    """Copy global pages ``src[i] → dst[i]`` in every pool of ``pools``
    (this rank's [Hkv, P_local, ps, D] slices), in place: the engine's
    copy-on-write, whose source and destination may live on different
    shards. Each rank fills one buffer with the source pages it owns and
    zeros elsewhere, one ``all_reduce(SUM)`` gives every rank every source
    page (exact: ``x + 0 = x``), and the owner of each destination writes
    it."""
    n_local = pools[0].shape[1]
    src = torch.as_tensor(src, device=pools[0].device).long()
    dst = torch.as_tensor(dst, device=pools[0].device).long()
    have = src // n_local == mesh.rank
    buf = torch.zeros((len(pools), *pools[0].shape[:1], src.numel(),
                       *pools[0].shape[2:]), dtype=pools[0].dtype,
                      device=pools[0].device)
    for i, pool in enumerate(pools):
        buf[i][:, have] = pool[:, src[have] % n_local]
    C.all_reduce_(buf, as_train_mesh(mesh), "model")
    mine = dst // n_local == mesh.rank
    for i, pool in enumerate(pools):
        pool[:, dst[mine] % n_local] = buf[i][:, mine]


def poison_pages_sharded(pools: Sequence[torch.Tensor], pages,
                         mesh: PoolMesh, value: float = 1e6) -> None:
    """Write ``value`` into the global ``pages`` this rank owns, at their
    local ids, in every pool of ``pools`` (global page 0 is shard 0's local
    page 0). No collective: each shard poisons its own pages."""
    n_local = pools[0].shape[1]
    pages = torch.as_tensor(pages, device=pools[0].device).long()
    local = pages[pages // n_local == mesh.rank] % n_local
    for pool in pools:
        pool[:, local] = value
