"""Paged KV cache bookkeeping: page allocator + per-sequence block tables.

The device side of the paged cache is a *global page pool* per attention layer
(``k_pages``/``v_pages`` of shape ``[Hkv, num_pages, page_size, D]``, built by
``lm.init_paged_cache``).  This module owns everything host-side:

* :class:`PageAllocator` — a refcounted free list over physical page ids.
  Page 0 is reserved as the **trash page**: freed/unassigned block-table
  entries and padding-token writes all point there, so every table entry the
  kernel's BlockSpec index map reads is a valid page id even for skipped
  blocks.  Every live page carries a refcount (1 for a private page, >1 when
  prefix sharing aliases it into several block tables); double frees and
  trash frees raise instead of silently aliasing two sequences' KV.  A page
  whose refcount hits zero can be *retained* — parked in a cached LRU ring
  because the prefix index still knows its content — and is revived on the
  next prefix hit or evicted when the free list runs dry.
* :class:`PrefixIndex` — a content-addressed index over page-aligned token
  blocks.  Each block's digest chains over its parent's digest plus its
  tokens, so a hit on block ``k`` certifies the *entire* prefix through block
  ``k`` matches — tokens and absolute positions both, which (causal attention
  + global RoPE positions) certifies the cached K/V bytes match too.
* :class:`BlockTables` — per-slot (concurrent-sequence) block tables and
  ``kv_len``, numpy-backed.  Ownership is tracked per *logical block*
  (``slot → {block index → page id}``), which supports both admission
  policies: **eager** reserves a sequence's full page budget up front
  (prompt + generation, so a running batch can never run dry), while
  **lazy** reserves only the prompt pages and grows the decode pages
  (:meth:`grow`) one at a time as ``kv_len`` crosses page boundaries (higher
  pool utilization; the scheduler preempts when growth fails).  With
  ``share_prefix=True`` admission consults the prefix index and points
  matched blocks at the existing physical pages (refcount + 1, no prefill
  compute needed for those tokens), and :meth:`prepare_write` performs
  **copy-on-write**: the first write into a page with refcount > 1 moves the
  writer onto a fresh page (the device copy is queued for the engine to
  apply).  Sliding-window sequences additionally
  :meth:`reclaim_out_of_window` blocks that have slid fully out of the
  attention window — their table entries return to the trash page, which the
  kernels' window gate never reads.  Also computes the flat scatter
  destinations used by packed prefill and reports pool utilization.

Everything here is plain numpy — the jitted steps receive the tables as fresh
(tiny) device arrays each step, which is what lets the scheduler admit/evict
between steps without recompiling anything.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from repro_torch.serving.state_cache import StateCache

TRASH_PAGE = 0  # page 0 absorbs padding writes and backs unassigned entries


def trash_pages_for(num_pages: int, num_shards: int) -> frozenset:
    """Global ids of the per-shard trash pages (page 0 of every shard) —
    the single source for the config's and the allocator's reserved set."""
    per = num_pages // num_shards
    return frozenset(s * per for s in range(num_shards))


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Static geometry of the paged cache (hashable → usable inside jit)."""
    page_size: int = 16          # tokens per KV page
    num_pages: int = 64          # physical pages per layer, incl. trash page(s)
    max_batch: int = 4           # concurrent decode slots
    max_pages_per_seq: int = 16  # block-table width T
    num_shards: int = 1          # page-pool shards (mesh "model" axis size);
                                 # shard s owns pages [s·P, (s+1)·P) and its
                                 # local page 0 (global s·P) is a trash page

    def __post_init__(self):
        if self.num_pages % self.num_shards != 0:
            raise ValueError(
                f"num_pages={self.num_pages} must divide by "
                f"num_shards={self.num_shards}: pool sharding is page-aligned "
                f"(pages never straddle shards)")
        if self.num_pages // self.num_shards < 2:
            raise ValueError("each pool shard needs its trash page plus at "
                             "least one usable page")

    @property
    def max_seq_len(self) -> int:
        """Token capacity of one block-table row (table width × page size)."""
        return self.max_pages_per_seq * self.page_size

    @property
    def trash_pages(self) -> frozenset:
        """Global ids of the per-shard trash pages (page 0 of every shard)."""
        return trash_pages_for(self.num_pages, self.num_shards)

    @property
    def usable_pages(self) -> int:
        """Allocatable pages: the pool minus one trash page per shard."""
        return self.num_pages - self.num_shards

    def pages_for(self, n_tokens: int) -> int:
        """Pages covering ``n_tokens`` (ceiling division by page_size)."""
        return -(-n_tokens // self.page_size)


class PageAllocator:
    """Refcounted free-list allocator over the non-trash physical page ids.

    Single shard: pages ``1..num_pages-1`` (page 0 is the trash page).
    ``num_shards > 1`` (distributed pool): the first page of every shard —
    global ids ``s · num_pages/num_shards`` — is reserved as that shard's
    trash page (non-local table entries and writes are remapped there), so
    none of them is ever handed out.

    A page is in exactly one of three states:

    * **free** — on the free list, ready for :meth:`alloc`;
    * **allocated** — refcount ≥ 1 (one per block-table entry aliasing it;
      prefix sharing is the only source of refcounts > 1);
    * **cached** — refcount 0 but *retained* because the prefix index still
      maps its content; revivable by :meth:`share` on a prefix hit, or
      evicted LRU-first by :meth:`alloc` when the free list runs dry
      (``on_evict`` fires so the index can forget it).

    Conservation (the fuzz test's invariant):
    ``num_free + num_cached + num_allocated == usable pages``.
    """

    def __init__(self, num_pages: int, num_shards: int = 1):
        assert num_pages >= 2, "need at least the trash page + one real page"
        assert num_pages % num_shards == 0, "pool sharding is page-aligned"
        self._trash = trash_pages_for(num_pages, num_shards)
        self._free: List[int] = [p for p in range(num_pages - 1, 0, -1)
                                 if p not in self._trash]  # pop() → lowest id
        self._refs: Dict[int, int] = {}              # page → refcount (≥ 1)
        self._cached: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()                # ref-0 retained, LRU first
        self.on_evict: Optional[Callable[[int], None]] = None
        self.num_pages = num_pages
        self.total_allocs = 0   # pages ever handed out fresh (stats)
        self.revivals = 0       # cached pages brought back by a prefix hit

    @property
    def num_free(self) -> int:
        """Pages on the free list (immediately allocatable, content dead)."""
        return len(self._free)

    @property
    def num_cached(self) -> int:
        """Retained ref-0 pages (allocatable after evicting their content)."""
        return len(self._cached)

    @property
    def num_allocated(self) -> int:
        """Distinct physical pages with refcount ≥ 1."""
        return len(self._refs)

    @property
    def refs_total(self) -> int:
        """Sum of all refcounts — equals the block-table ownership entries."""
        return sum(self._refs.values())

    def refcount(self, page: int) -> int:
        """Current refcount of a page (0 when free or cached)."""
        return self._refs.get(page, 0)

    def free_page_ids(self) -> List[int]:
        """Snapshot of the free list (content-dead, immediately allocatable).
        Cached pages are *not* included — their device content is live in
        the prefix index and must survive until eviction.  The chaos
        harness's ``poison`` fault clobbers exactly these pages to prove
        nothing ever reads freed storage."""
        return list(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Hand out ``n`` fresh pages at refcount 1, or return None (and
        leave the pool untouched) if free + cached can't cover it.  The free
        list is drained first; then cached pages are evicted oldest-first,
        firing ``on_evict`` so the prefix index forgets their content."""
        if n > len(self._free) + len(self._cached):
            return None
        got: List[int] = []
        while len(got) < n and self._free:
            got.append(self._free.pop())
        while len(got) < n:
            page, _ = self._cached.popitem(last=False)   # LRU eviction
            if self.on_evict is not None:
                self.on_evict(page)
            got.append(page)
        for p in got:
            self._refs[p] = 1
        self.total_allocs += n
        return got

    def share(self, page: int):
        """Add one reference to an allocated or cached page (a prefix-cache
        hit aliasing it into another block table).  Reviving a cached page
        moves it back to refcount 1 without touching its device content."""
        if page in self._refs:
            self._refs[page] += 1
        elif page in self._cached:
            del self._cached[page]
            self._refs[page] = 1
            self.revivals += 1
        else:
            raise ValueError(f"page {page} is not allocated or cached — "
                             f"cannot share a free page")

    def free(self, pages: List[int],
             retain: FrozenSet[int] = frozenset()) -> List[int]:
        """Drop one reference per page; pages reaching refcount 0 return to
        the free list — unless listed in ``retain`` (the prefix index still
        maps their content), in which case they park in the cached ring.
        Raises on a trash page or a page with no outstanding reference (the
        double-free that used to silently alias two sequences' KV).
        Returns the pages that actually went back to the free list, so the
        engine's ``poison_reclaimed`` hook clobbers only truly dead pages."""
        released: List[int] = []
        for p in pages:
            if p in self._trash:
                raise ValueError(f"page {p} is a trash page — never allocated")
            if p not in self._refs:
                raise ValueError(f"page {p} has no outstanding reference — "
                                 f"double free")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                if p in retain:
                    self._cached[p] = None   # most-recently-used end
                else:
                    released.append(p)
        self._free.extend(released)
        return released


class PrefixIndex:
    """Content-addressed map from page-aligned token blocks to physical pages.

    Block ``k`` of a prompt is hashed as ``blake2b(digest(k-1) ‖ tokens[k·ps
    : min((k+1)·ps, n)])`` — the chaining makes a digest stand for the whole
    prefix through its block, so equal digests imply equal tokens *at equal
    absolute positions*, which (causal attention + positions-from-zero RoPE)
    implies bit-equal cached K/V.  Full blocks and the final partial block
    both index; a partial block's digest covers its exact token count, so
    only an identical-length identical tail matches it.

    Entries are registered only *after* the block's KV has been written
    (post-prefill) and forgotten when the allocator evicts the backing page.
    A registered page's indexed tokens never change: appends land at offsets
    past them, and any write to a page with refcount > 1 goes through
    copy-on-write first.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._pages: Dict[bytes, int] = {}    # digest → physical page
        self._digests: Dict[int, bytes] = {}  # physical page → digest
        self.hits = 0     # admission-time block matches (stats)
        self.misses = 0   # admission-time block lookups that missed

    @staticmethod
    def _digest(parent: bytes, tokens: np.ndarray) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(parent)
        h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
        return h.digest()

    def block_digests(self, tokens: np.ndarray) -> List[bytes]:
        """Chained digests for every block a prompt covers (the last one may
        be partial)."""
        tokens = np.asarray(tokens, np.int32)
        n = int(tokens.shape[0])
        ps = self.page_size
        out: List[bytes] = []
        parent = b""
        for blk in range(-(-n // ps)):
            parent = self._digest(parent, tokens[blk * ps:min((blk + 1) * ps,
                                                              n)])
            out.append(parent)
        return out

    def lookup(self, digest: bytes) -> Optional[int]:
        """The physical page registered for a block digest, if any."""
        page = self._pages.get(digest)
        if page is None:
            self.misses += 1
        else:
            self.hits += 1
        return page

    def register(self, digest: bytes, page: int) -> bool:
        """Publish a freshly prefilled block.  First writer wins: a digest
        already mapped, or a page already registered under another digest,
        is left alone (returns False)."""
        if digest in self._pages or page in self._digests:
            return False
        self._pages[digest] = page
        self._digests[page] = digest
        return True

    def registered(self, page: int) -> bool:
        """Is this physical page currently indexed?"""
        return page in self._digests

    def forget(self, page: int):
        """Drop a page's entry (allocator eviction: its content is about to
        be overwritten by a new owner)."""
        digest = self._digests.pop(page, None)
        if digest is not None and self._pages.get(digest) == page:
            del self._pages[digest]

    def __len__(self) -> int:
        return len(self._pages)


class BlockTables:
    """Per-slot block tables + lengths over one shared :class:`PageAllocator`.

    Ownership is per logical block (``slot → {block → page}``), so a row's
    owned blocks need not be a prefix of its table: lazy growth appends the
    next write block on demand, and sliding-window reclamation removes fully
    out-of-window blocks from the low end (their entries revert to the trash
    page — inert by the kernels' ``kv_len``/window gates).

    With ``share_prefix=True`` a :class:`PrefixIndex` rides along: admission
    points matched prompt blocks at existing pages (sharing the refcount),
    releases park still-indexed pages in the allocator's cached ring instead
    of freeing them, and :meth:`prepare_write` copy-on-writes the first
    divergent write to a shared page.  The device-side page copies a COW
    produces are queued in ``drain_copies`` order for the engine to apply
    before the next prefill/decode step.

    A :class:`~repro.serving.state_cache.StateCache` rides along as
    ``self.state``: hybrid SSM/recurrent archs keep O(1) per-slot state
    rows next to the page pool, and the same admit/release calls that bind
    a slot's pages bind its state row — preemption and eviction free both
    atomically (attention-only archs just never read the rows).
    """

    def __init__(self, cfg: PagedCacheConfig, share_prefix: bool = False):
        self.cfg = cfg
        self.allocator = PageAllocator(cfg.num_pages, cfg.num_shards)
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(cfg.page_size) if share_prefix else None)
        if self.prefix is not None:
            self.allocator.on_evict = self.prefix.forget
        self.tables = np.full((cfg.max_batch, cfg.max_pages_per_seq),
                              TRASH_PAGE, np.int32)
        self.kv_len = np.zeros((cfg.max_batch,), np.int32)
        self.state = StateCache(cfg.max_batch)  # per-slot recurrent state
        self._owned: Dict[int, Dict[int, int]] = {}  # slot → {block → page}
        self._digests: Dict[int, Tuple[List[bytes], int]] = {}
        # slot → (block digest chain of its prompt, prompt length): consumed
        # by register_prefilled as the prompt's blocks finish writing
        self._pending_copies: List[Tuple[int, int, int]] = []
        # COW queue: (slot, src page, dst page) in issue order; the engine
        # applies them as device copies before the next step reads dst
        self.hist: Dict[int, int] = {}  # slot → prefix tokens matched at admit
        self.pages_grown = 0        # lazily-allocated decode pages (stats)
        self.pages_reclaimed = 0    # out-of-window pages freed early (stats)
        self.pages_shared = 0       # block-table entries served by a hit
        self.cow_copies = 0         # copy-on-write page copies queued

    def free_slots(self) -> List[int]:
        """Decode slots not currently backing a sequence."""
        return [s for s in range(self.cfg.max_batch) if s not in self._owned]

    def _match_prefix(self, tokens: Optional[np.ndarray]
                      ) -> Tuple[int, Dict[int, int], Optional[List[bytes]]]:
        """Walk the prompt's digest chain against the index: returns (matched
        token count, {block → existing page}, the full digest chain).  The
        match is capped at ``prompt_len - 1`` so prefill always processes at
        least the prompt's last token — its logits seed generation."""
        if self.prefix is None or tokens is None:
            return 0, {}, None
        tokens = np.asarray(tokens, np.int32)
        n_prompt = int(tokens.shape[0])
        digests = self.prefix.block_digests(tokens)
        ps = self.cfg.page_size
        hist = 0
        matched: Dict[int, int] = {}
        for blk, digest in enumerate(digests):
            page = self.prefix.lookup(digest)
            if page is None:
                break
            end = min((blk + 1) * ps, n_prompt)
            if end >= n_prompt:
                end = n_prompt - 1          # keep the last token for prefill
                if end <= blk * ps:
                    break                   # block would contribute nothing
            matched[blk] = page
            hist = end
            if end < (blk + 1) * ps:
                break                       # partial tail ends the chain
        return hist, matched, digests

    def admit(self, slot: int, n_tokens: int, first_block: int = 0,
              tokens: Optional[np.ndarray] = None) -> bool:
        """Reserve the pages covering ``n_tokens`` at logical blocks
        ``first_block .. pages_for(n_tokens)-1``.

        Eager admission passes the full lifetime budget (prompt + gen);
        lazy admission passes only the prompt (decode pages come from
        :meth:`grow`).  Sliding-window admission skips blocks already dead
        on arrival via ``first_block`` — a resumed long-tail prompt then
        reserves only its O(window) live tail, not the whole prefix; prefill
        writes into skipped blocks land in the trash page (their table
        entries stay 0) and the kernels' window gate never reads them.

        With prefix sharing, pass the *prompt* ``tokens``: blocks whose
        chained digest is already indexed alias the existing physical pages
        (refcount + 1; dead-on-arrival blocks below ``first_block`` are
        matched for compute-skipping but get no page), and ``hist[slot]``
        records how many prompt tokens are already resident — the engine
        prefills only the remainder.  All-or-nothing: False (no side effect)
        when the pool can't cover the unmatched blocks.
        """
        assert slot not in self._owned
        if n_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"sequence of {n_tokens} tokens exceeds the block-table "
                f"capacity {self.cfg.max_seq_len} (raise max_pages_per_seq)")
        n_blocks = self.cfg.pages_for(n_tokens)
        assert 0 <= first_block < n_blocks
        hist, matched, digests = self._match_prefix(tokens)
        shared = {blk: page for blk, page in matched.items()
                  if blk >= first_block}
        # take the shared references first: alloc() below may otherwise evict
        # the very cached pages the match found
        for page in shared.values():
            self.allocator.share(page)
        need = [blk for blk in range(first_block, n_blocks)
                if blk not in shared]
        pages = self.allocator.alloc(len(need))
        if pages is None:
            if shared:   # roll back, parking revived pages back in the cache
                self.allocator.free(list(shared.values()),
                                    retain=frozenset(shared.values()))
            return False
        owned = dict(shared)
        owned.update(zip(need, pages))
        self._owned[slot] = owned
        self.state.admit(slot)   # bind the slot's recurrent-state row too
        self.tables[slot] = TRASH_PAGE
        for blk, page in owned.items():
            self.tables[slot, blk] = page
        self.kv_len[slot] = hist   # matched tokens are already resident
        self.hist[slot] = hist
        if digests is not None:
            self._digests[slot] = (digests, int(np.asarray(tokens).shape[0]))
        self.pages_shared += len(shared)
        return True

    def _ensure_block(self, slot: int, blk: int) -> bool:
        """Ensure one specific logical block is owned, allocating a page if
        it isn't.  Idempotent; returns False (no side effect) when a page is
        needed but the pool is dry — the scheduler's cue to preempt."""
        owned = self._owned[slot]
        if blk in owned:
            return True
        if blk >= self.cfg.max_pages_per_seq:
            raise ValueError(
                f"slot {slot}: write block {blk} escapes the block-table "
                f"capacity {self.cfg.max_seq_len}")
        pages = self.allocator.alloc(1)
        if pages is None:
            return False
        owned[blk] = pages[0]
        self.tables[slot, blk] = pages[0]
        self.pages_grown += 1
        return True

    def grow(self, slot: int) -> bool:
        """Ensure the next token's write block (``kv_len // page_size``) is
        owned, allocating one page if it isn't.  Idempotent; returns False
        (no side effect) when a page is needed but the pool is dry — the
        scheduler's cue to preempt."""
        return self._ensure_block(slot,
                                  int(self.kv_len[slot]) // self.cfg.page_size)

    def prepare_write(self, slot: int, n: int = 1) -> bool:
        """Make the blocks covering the next ``n`` token writes (positions
        ``kv_len .. kv_len + n - 1``) owned and exclusively writable,
        copy-on-writing shared pages as needed.

        ``n = 1`` is the plain decode step; speculative decode passes
        ``k + 1`` so one verify call can scatter a row's whole draft, which
        may cross one or more page boundaries in a single step — every
        boundary crossed grows one page.  A missing block *below* the row's
        highest owned block is a window-skipped dead zone — mid-prefill
        writes there go to the trash page by design, so nothing is
        allocated; missing blocks above are genuine appends.  When a write
        block's page has refcount > 1 — a prefix-shared page this row is
        about to diverge from — the row moves to a fresh page: the device
        copy is queued in ``_pending_copies``, the table entry is rewritten,
        and the shared page loses one reference.  Returns False (pool dry)
        as the scheduler's cue to preempt; pages already granted for earlier
        blocks of the range stay owned (they are the row's future write
        blocks — release/preemption reclaims them like any owned page).
        """
        assert n >= 1
        owned = self._owned[slot]
        ps = self.cfg.page_size
        first = int(self.kv_len[slot]) // ps
        last = (int(self.kv_len[slot]) + n - 1) // ps
        for blk in range(first, last + 1):
            if blk not in owned:
                if owned and blk < max(owned):
                    continue   # window-skipped block: writes go to trash
                if not self._ensure_block(slot, blk):
                    return False
            page = owned.get(blk)
            if page is not None and self.allocator.refcount(page) > 1:
                fresh = self.allocator.alloc(1)
                if fresh is None:
                    return False
                retain = (frozenset([page]) if self.prefix is not None
                          and self.prefix.registered(page) else frozenset())
                self.allocator.free([page], retain=retain)
                owned[blk] = fresh[0]
                self.tables[slot, blk] = fresh[0]
                self._pending_copies.append((slot, page, fresh[0]))
                self.cow_copies += 1
        return True

    def drain_copies(self) -> List[Tuple[int, int]]:
        """Take the queued COW page copies as (src, dst) pairs in issue
        order; the engine applies them to every layer's pools before the
        next step reads the destination pages."""
        pairs = [(src, dst) for _, src, dst in self._pending_copies]
        self._pending_copies = []
        return pairs

    def register_prefilled(self, slot: int, upto: int):
        """Publish the prompt blocks whose content is fully written now that
        ``upto`` tokens are prefilled — full blocks as they complete, the
        partial tail once the whole prompt is in.  No-op without sharing or
        for window-skipped (trash-backed) blocks."""
        entry = self._digests.get(slot)
        if self.prefix is None or entry is None:
            return
        digests, n_tokens = entry
        ps = self.cfg.page_size
        owned = self._owned[slot]
        for blk, digest in enumerate(digests):
            end = min((blk + 1) * ps, n_tokens)
            if end > upto:
                break
            page = owned.get(blk)
            if page is not None:
                self.prefix.register(digest, page)

    def _retained(self, pages: List[int]) -> FrozenSet[int]:
        """The subset of pages the prefix index still maps — releases park
        these in the allocator's cached ring instead of the free list."""
        if self.prefix is None:
            return frozenset()
        return frozenset(p for p in pages if self.prefix.registered(p))

    def reclaim_out_of_window(self, slot: int, window: int) -> List[int]:
        """Free this row's blocks that have slid fully out of a sliding
        attention window; returns the page ids that actually went back to
        the free list (shared or index-retained pages survive with their
        content — the engine's poison hook must not clobber those).

        At the next decode step the query sits at position ``kv_len`` and the
        kernels admit keys at positions ``kp > kv_len - window`` (the same
        gate in the Pallas grid skip and the XLA fallback mask).  A block is
        dead once its *last* position ``(blk+1)·page_size - 1`` falls at or
        below ``kv_len - window`` — and stays dead, since ``kv_len`` only
        grows.  Its table entry reverts to the trash page, which the window
        gate skips without reading.
        """
        owned = self._owned.get(slot)
        if not owned:
            return []
        ps = self.cfg.page_size
        horizon = int(self.kv_len[slot]) - window  # last masked-out position
        freed = []
        for blk in sorted(owned):
            if (blk + 1) * ps - 1 > horizon:
                break                      # blocks are dead low-end-first
            freed.append(owned.pop(blk))
            self.tables[slot, blk] = TRASH_PAGE
        if not freed:
            return []
        self.pages_reclaimed += len(freed)
        return self.allocator.free(freed, retain=self._retained(freed))

    def release(self, slot: int) -> List[int]:
        """Return every page a slot owns (finish, EOS, or preemption);
        still-indexed pages park in the allocator's cached ring so future
        identical prefixes can revive them.  Queued COW copies for the slot
        are dropped (their destination pages just went away).  Returns the
        page ids that actually went back to the free list."""
        pages = list(self._owned.pop(slot).values())
        self.state.release(slot)   # the slot's recurrent-state row dies too
        self.tables[slot] = TRASH_PAGE
        self.kv_len[slot] = 0
        self._digests.pop(slot, None)
        self.hist.pop(slot, None)
        self._pending_copies = [c for c in self._pending_copies
                                if c[0] != slot]
        return self.allocator.free(pages, retain=self._retained(pages))

    def prefill_dest(self, segment_ids_row: np.ndarray,
                     slots: List[int]) -> np.ndarray:
        """Flat page-pool token slots for one packed prefill row.

        segment_ids_row [S]: ids 0..n-1 over contiguous prompt spans, -1 pad;
        slots[i]: the cache slot backing segment i.  Returns dest [S] int32 —
        token t of segment i lands in ``table[t // ps] * ps + t % ps`` of slot
        ``slots[i]``'s table; padding lands in the trash page's slot 0.
        """
        ps = self.cfg.page_size
        dest = np.zeros(segment_ids_row.shape, np.int32)  # pad → trash slot 0
        for i, slot in enumerate(slots):
            (pos,) = np.nonzero(segment_ids_row == i)
            local = np.arange(len(pos))
            dest[pos] = self.tables[slot, local // ps] * ps + local % ps
        return dest

    def span_dest(self, slot: int, start: int, end: int) -> np.ndarray:
        """Flat page-pool token slots for tokens ``[start, end)`` of one
        sequence — the chunked-prefill scatter destinations (positions are
        global, unlike :meth:`prefill_dest`'s per-segment layout).  Tokens in
        window-skipped blocks map through the trash table entry."""
        ps = self.cfg.page_size
        pos = np.arange(start, end)
        return (self.tables[slot, pos // ps] * ps + pos % ps).astype(np.int32)

    def append_dest_ok(self, slot: int, n: int = 1) -> bool:
        """Do the next ``n`` tokens' write positions all fall inside owned
        pages?  (The decode/verify steps assert this before scattering.)"""
        ps = self.cfg.page_size
        first = int(self.kv_len[slot]) // ps
        last = (int(self.kv_len[slot]) + n - 1) // ps
        owned = self._owned.get(slot, {})
        return all(blk in owned for blk in range(first, last + 1))

    def utilization(self) -> Dict[str, float]:
        """Live tokens vs. reserved page capacity — the admission-policy
        metric: eager full-budget reservation holds pages long before tokens
        exist, lazy growth tracks the live set (and reclamation drops tokens
        that slid out of the window along with their pages).  ``utilization``
        counts logical blocks (a shared page counts once per alias);
        ``pool_fraction`` counts distinct physical pages, so prefix sharing
        drives it *down* while utilization holds."""
        ps = self.cfg.page_size
        allocated = sum(len(p) for p in self._owned.values())
        cap = allocated * ps
        used = 0                     # tokens resident in *owned* pages
        for slot, owned in self._owned.items():
            n = int(self.kv_len[slot])
            used += sum(max(0, min(ps, n - blk * ps)) for blk in owned)
        physical = self.allocator.num_allocated
        return {
            "used_tokens": float(used),
            "allocated_tokens": float(cap),
            "allocated_pages": float(allocated),
            "physical_pages": float(physical),
            "pool_pages": float(self.cfg.usable_pages),
            "utilization": used / cap if cap else 0.0,
            "pool_fraction": physical / self.cfg.usable_pages,
        }
