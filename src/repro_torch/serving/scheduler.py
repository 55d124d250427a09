"""Continuous-batching scheduler over the paged KV cache.

Requests arrive with a prompt and a generation budget; between decode steps
the engine asks the scheduler to (a) evict finished sequences — returning
their pages to the pool — (b) reclaim pages that slid out of a sliding
attention window, (c) grow every running sequence's next write page, and
(d) admit waiting requests FCFS while a free decode slot and their admission
page budget are available.  Two admission policies share the machinery:

* **eager** (default) — admission reserves the *full* lifetime budget
  (``prompt + max_new`` pages) up front, so growth is a no-op and a running
  batch can never run dry; utilization pays for the guarantee.
* **lazy** (``lazy=True``) — admission reserves only the *prompt* pages and
  decode pages are allocated one at a time as ``kv_len`` crosses page
  boundaries.  When the pool runs dry mid-growth, the scheduler **preempts
  the youngest running sequence**: its pages are freed and it re-queues at
  the *front* of the waiting line with its generated tokens appended to the
  prompt, to be **re-prefilled** later.  Greedy decode makes the resumed
  generation token-identical to an unpreempted run (tests assert it).

The state machine (docs/scheduling.md has the full picture)::

    WAITING --admit--> ACTIVE --done/EOS--> FINISHED
       ^                  |
       +---- preempt -----+   (lazy only: growth failed → the youngest row
                               is re-queued at the front of WAITING with
                               prompt := prompt + generated)

The scheduler is pure host-side state — it never touches device arrays.  The
engine turns admissions into packed prefill calls and the active set into the
per-step ``block_tables``/``kv_len`` arrays; preemption/growth/reclamation
only rewrite those host arrays, so the fixed-shape jitted steps never
recompile.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.serving.paged_cache import BlockTables, PagedCacheConfig


class AdmissionImpossible(ValueError):
    """A request whose worst-case footprint can never fit this pool.

    Subclasses ``ValueError`` so callers treating capacity rejection as
    malformed input keep working, while the engine can catch it
    specifically and shed the request with a typed ``SHED`` outcome
    instead of propagating an exception."""


@dataclasses.dataclass
class Request:
    """One serving request (or the resumed tail of a preempted one)."""
    rid: int
    tokens: np.ndarray            # [prompt_len] int32
    max_new_tokens: int
    eos_id: Optional[int] = None  # finish early when this token is emitted
                                  # (None: run to the max_new_tokens budget)
    generated_prefix: List[int] = dataclasses.field(default_factory=list)
    # tokens generated before a preemption: they ride along in ``tokens`` for
    # the re-prefill, and the engine stitches them back onto the output

    @property
    def prompt_len(self) -> int:
        """Tokens the next prefill must process (original prompt, plus any
        generated-so-far carried across a preemption)."""
        return int(self.tokens.shape[0])

    @property
    def budget_tokens(self) -> int:
        """KV writes over the remaining lifetime: the prompt plus every
        decode-step input token (prompt + max_new - 1); one spare keeps the
        math obviously safe.  Invariant under preemption — the resumed
        request's longer prompt and smaller budget sum to the same total."""
        return self.prompt_len + self.max_new_tokens


@dataclasses.dataclass
class ActiveSeq:
    """A request bound to a decode slot, plus its generation state."""
    request: Request
    slot: int
    birth: int = 0                # admission stamp: preemption evicts max
    generated: List[int] = dataclasses.field(default_factory=list)
    prefilled: int = 0            # prompt tokens resident in pages so far
    # (admission seeds it with the prefix-cache hit length; chunked prefill
    # advances it one budgeted span at a time until it hits prompt_len)

    @property
    def prefilling(self) -> bool:
        """Still mid-prompt: excluded from decode steps, fed to the chunked
        prefill until ``prefilled`` reaches the prompt length."""
        return self.prefilled < self.request.prompt_len

    @property
    def done(self) -> bool:
        """Budget exhausted, or EOS emitted (freeing the slot and its pages
        immediately instead of decoding dead tokens to the budget)."""
        if len(self.generated) >= self.request.max_new_tokens:
            return True
        eos = self.request.eos_id
        return (eos is not None and bool(self.generated)
                and self.generated[-1] == eos)

    @property
    def all_generated(self) -> List[int]:
        """Full generation including tokens from before any preemption."""
        return self.request.generated_prefix + self.generated


class Scheduler:
    """Admission / growth / preemption / eviction over one page pool."""

    def __init__(self, cfg: PagedCacheConfig, *, lazy: bool = False,
                 window: Optional[int] = None, share_prefix: bool = False,
                 chunked: bool = False):
        """window: the sliding attention window when page reclamation is on
        (None otherwise).  Lazy admission uses it to skip blocks that are
        dead on arrival — a preempted long-tail row resumes by reserving
        only its O(window) live tail instead of the whole prefix.
        share_prefix: content-addressed prefix caching — admission aliases
        matched prompt blocks onto existing physical pages (skipping their
        prefill compute) and divergent writes copy-on-write.
        chunked: the engine splits prompts into prefill chunks — like
        share_prefix, this makes prefill read *cached* history instead of
        in-row activations, which disables the dead-on-arrival block skip
        (see :meth:`_first_live_block`)."""
        self.cfg = cfg
        self.lazy = lazy
        self.window = window
        self.share_prefix = share_prefix
        self.chunked = chunked
        self.tables = BlockTables(cfg, share_prefix=share_prefix)
        self.waiting: Deque[Request] = collections.deque()
        self.active: Dict[int, ActiveSeq] = {}    # slot → sequence
        self.finished: List[ActiveSeq] = []
        self.preemptions = 0
        self.prefill_skipped = 0   # prompt tokens served by prefix hits
        self._births = 0
        self._rids: set = set()    # every rid ever submitted (dup guard)

    @property
    def idle(self) -> bool:
        """Nothing waiting and nothing running — the serve loop's exit."""
        return not self.waiting and not self.active

    def submit(self, req: Request):
        """Queue a request; rejects ones that could never be admitted —
        empty prompts, duplicate rids (two requests with the same rid would
        silently drop one generation from the keyed output), and budgets the
        block tables or the page pool can never cover (a too-big request
        would otherwise sit at the queue head and deadlock the serve loop)."""
        if req.prompt_len < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.rid in self._rids:
            raise ValueError(
                f"request rid {req.rid} is already submitted — rids key the "
                f"output dict, a duplicate would drop one generation")
        if req.budget_tokens > self.cfg.max_seq_len:
            raise AdmissionImpossible(
                f"request {req.rid}: prompt+generation of {req.budget_tokens} "
                f"tokens can never fit max_seq_len={self.cfg.max_seq_len}")
        if self.peak_pages(req) > self.cfg.usable_pages:
            raise AdmissionImpossible(
                f"request {req.rid} needs more pages than the pool holds "
                f"({self.peak_pages(req)} > {self.cfg.usable_pages} usable)")
        self._rids.add(req.rid)
        self.waiting.append(req)

    def peak_pages(self, req: Request) -> int:
        """Worst-case simultaneous page footprint of a request on this
        scheduler — the submit-time shedding bound.

        The naive bound is ``pages_for(budget_tokens)``: every position the
        lifetime writes gets a page.  Under a sliding window with lazy
        admission (and neither prefix sharing nor chunked prefill, which
        re-enable whole-prefix residency — see :meth:`_first_live_block`),
        dead-on-arrival blocks go to trash at admission and reclamation
        frees blocks as they slide out, so a row only ever holds its
        O(window) live tail: ``pages_for(window)`` plus one straddle page
        and one not-yet-reclaimed page.  Without this relaxation a long
        request on a small windowed pool sheds at submit even though the
        pool could serve it forever — and with the *old* token-count-only
        check such a request was accepted and then spun in the admission
        queue without ever fitting."""
        full = self.cfg.pages_for(req.budget_tokens)
        if self.lazy and self.window is not None \
                and not self.share_prefix and not self.chunked:
            return min(full, self.cfg.pages_for(self.window) + 2)
        return full

    def remove_waiting(self, rid: int) -> Optional[Request]:
        """Pull a request out of the waiting queue by rid (cancellation,
        deadline expiry, watchdog shedding).  Returns it, or None if no
        waiting request has that rid.  The rid stays burned in the dup
        guard — a terminated request must not be resubmittable under the
        same key."""
        for req in self.waiting:
            if req.rid == rid:
                self.waiting.remove(req)
                return req
        return None

    def evict_finished(self) -> List[ActiveSeq]:
        """Move done sequences to ``finished``, returning their pages."""
        done = [seq for seq in self.active.values() if seq.done]
        for seq in done:
            del self.active[seq.slot]
            self.tables.release(seq.slot)
            self.finished.append(seq)
        return done

    def reclaim(self, window: int) -> List[int]:
        """Free every active row's fully-out-of-window pages (sliding-window
        archs only); returns the freed page ids so the engine can poison them
        under test.  Valid in both admission modes — reclaimed blocks sit
        strictly below the write block, so eager's no-growth invariant holds."""
        freed: List[int] = []
        for slot in list(self.active):
            freed.extend(self.tables.reclaim_out_of_window(slot, window))
        return freed

    def preempt(self, seq: ActiveSeq):
        """Free a running sequence's pages and re-queue it for re-prefill.

        The resumed request carries the original prompt *plus* everything
        generated so far as its new prompt (greedy decode: re-prefilling the
        full prefix reproduces the next token exactly), keeps the rid/EOS,
        and shrinks the budget by what it already produced.  It goes to the
        *front* of the waiting line: running work outranks new arrivals.
        """
        del self.active[seq.slot]
        self.tables.release(seq.slot)
        req = seq.request
        self.waiting.appendleft(Request(
            rid=req.rid,
            tokens=np.concatenate(
                [req.tokens, np.asarray(seq.generated, np.int32)]),
            max_new_tokens=req.max_new_tokens - len(seq.generated),
            eos_id=req.eos_id,
            generated_prefix=req.generated_prefix + list(seq.generated)))
        self.preemptions += 1

    def ensure_growth(self, n: int = 1) -> List[int]:
        """Guarantee every surviving active row owns its next ``n`` write
        pages' worth of positions (``n = 1``: plain decode; speculative
        decode passes ``k + 1`` so one verify step can scatter a whole
        draft, growing across page boundaries when the draft straddles one).

        Oldest rows grow first; when the pool is dry the *youngest* active
        sequence is preempted and the allocation retried — each preemption
        strictly shrinks the active set, so the loop terminates even when a
        victim's pages were all shared (freeing them only drops refcounts).
        If the youngest is the row being grown, it preempts itself; its
        resumed prompt needs one page more than it just freed, which the
        submit-time check (budget pages <= usable pages) guarantees the pool
        can supply once it is the admission front-runner — each such cycle
        still moves at least one generated token into the prefix, so it
        cannot loop forever.  Under prefix sharing this pass also performs
        the copy-on-write step: a row whose write block sits on a shared
        page moves to a fresh page here (the engine applies the queued
        device copies right after).  Returns the preempted rids.  Eager
        mode owns every budget page up front, so growth is a no-op there
        (COW is not — with sharing on, even eager can preempt here).

        The lookahead is capped per row at the tokens it can still write
        before finishing (a nearly-done row must not reserve pages past its
        budget — they could never be used and would shrink everyone else's
        pool) and drops to 1 for mid-prefill rows, whose prompt pages were
        all reserved at admission.
        """
        preempted: List[int] = []
        for seq in sorted(self.active.values(), key=lambda s: s.birth):
            if self.active.get(seq.slot) is not seq:
                continue               # already preempted by an older row
            n_row = 1 if seq.prefilling else max(1, min(
                n, seq.request.max_new_tokens - len(seq.generated)))
            while not self.tables.prepare_write(seq.slot, n_row):
                victim = max(self.active.values(), key=lambda s: s.birth)
                self.preempt(victim)
                preempted.append(victim.request.rid)
                if victim is seq:
                    break              # self-preempted: nothing left to grow
        return preempted

    def _first_live_block(self, prompt_len: int) -> int:
        """Blocks already dead at admission under a sliding window: at the
        first post-prefill decode the query sits at ``prompt_len``, so a
        block whose last position ``(blk+1)·ps - 1 <= prompt_len - window``
        is out of the window before it is ever read (the same horizon
        ``reclaim`` uses).  Prefill attention reads the in-row activations,
        not the cache, so those blocks' writes can go straight to trash.

        That justification only holds for whole-prompt in-row prefill:
        chunked and prefix-hit suffix spans attend through the *cache*, and
        a suffix query just above the skipped region still reaches into it
        (its window spans positions below ``prompt_len - window``), so with
        sharing or chunking enabled every prompt block gets a real page."""
        if not self.lazy or self.window is None \
                or self.share_prefix or self.chunked:
            return 0
        ps = self.cfg.page_size
        n_blocks = self.cfg.pages_for(prompt_len)
        dead = max(0, (prompt_len - self.window + 1) // ps)
        return min(dead, n_blocks - 1)   # the last block is always live

    def admit(self) -> List[ActiveSeq]:
        """FCFS admission: free slot + the admission page budget (full
        lifetime when eager, prompt-only when lazy, minus any blocks a
        sliding window already killed), else stop — arrival order is
        preserved, and preempted requests re-enter from the front."""
        admitted = []
        free = self.tables.free_slots()
        while self.waiting and free:
            req = self.waiting[0]
            slot = free[0]
            need = req.prompt_len if self.lazy else req.budget_tokens
            if not self.tables.admit(slot, need,
                                     self._first_live_block(req.prompt_len),
                                     tokens=req.tokens):
                break  # pool exhausted — keep arrival order, wait for pages
            self.waiting.popleft()
            free.pop(0)
            hist = self.tables.hist.get(slot, 0)
            seq = ActiveSeq(request=req, slot=slot, birth=self._births,
                            prefilled=hist)
            self.prefill_skipped += hist
            self._births += 1
            self.active[slot] = seq
            admitted.append(seq)
        return admitted
