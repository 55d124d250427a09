"""Continuous-batching serving engine over the paged KV cache (counterpart
of ``repro.serving.engine`` on one device).

Ties the pieces together: between decode steps the scheduler evicts finished
sequences, reclaims pages that slid out of a sliding attention window, grows
every running sequence's next write page (lazy mode — preempting the youngest
row when the pool runs dry), and admits waiting requests; admissions are
packed into fused prefill rows (segment-aware: one forward fills every
admitted prompt's pages), and the decode step runs all active slots against
the page pool via block tables.  Greedy sampling; a request finishes when it
emits its ``eos_id`` (set per request or engine-wide) or exhausts
``max_new_tokens`` — EOS eviction frees the slot and pages immediately.

Admission policy (``lazy=``): eager reserves a sequence's full page budget up
front and never preempts on growth; lazy reserves only the prompt pages,
grows decode pages one at a time, and re-prefills preempted rows with their
generated tokens appended to the prompt — token-identical to eager under
greedy decode (tests assert it), at strictly higher pool utilization.  The
state machine and its invariants are documented in docs/scheduling.md.

Prefix caching (``share_prefix=``): admission matches each prompt's
page-aligned blocks against a content-addressed index and aliases matched
blocks onto the existing physical pages — those tokens skip both page
allocation and prefill compute; the first divergent write to a shared page
copy-on-writes it (the scheduler queues the device page copy, applied here
before the next step).  Finished/preempted sequences park their indexed
pages in a cached LRU ring, so later identical prefixes revive them for
free.  Generations are bit-identical to the unshared engine: identical
prefixes at identical positions have identical K/V, and COW isolates every
divergence (with sharing on, even eager admission can preempt when a COW
allocation finds the pool dry).

Chunked prefill (``prefill_chunk=``): prompts are prefilled in spans of at
most that many tokens per engine iteration, interleaved with decode steps —
one long prompt no longer stalls the whole batch.  A span scatters its K/V
into the pages first and then attends per-token through its own block-table
row (``chunk_prefill_fn``), which also serves prefix-cache hits: a matched
prompt just prefills its unmatched suffix the same way.  Greedy decode makes
chunked runs token-identical to unchunked ones.

Speculative decoding (``speculate_k=``): between steps a prompt-lookup
drafter (serving/drafter.py) proposes up to ``k`` continuation tokens per
decode row from its own token history; the decode step is then replaced by a
verify step that scores all ``k + 1`` positions (current token + drafts) in
one model call through the same per-token paged-attention primitive chunked
prefill uses.  The longest draft prefix matching the model's own greedy
argmaxes is accepted — plus the model's token at the first mismatch — so
each verify call emits 1 to ``k + 1`` tokens and advances ``kv_len`` by as
many, growing/COW-ing every page the multi-token write touches *before* the
step (``ensure_growth(k + 1)``).  Rejected drafts' K/V writes are rolled
back logically: they sit at positions ``>= kv_len``, which every kernel read
gates out, and the next verify re-scatters those positions before ``kv_len``
ever covers them.  Greedy acceptance makes the generation token-identical to
plain single-step decode by construction (the JAX suite pins this across
every serving feature; tests/test_torch_engine.py holds this engine to the
JAX one token for token).

The device steps see fixed shapes only — [B=max_batch] decode rows, packed
prefill rows of ``prefill_len``, [B, k+1] verify rows — and run eagerly
(``runtime.steps.make_serve_steps(paged=)``): the host arrays of each step
(tokens, block tables, lengths) go to the device as tensors, the pools are
updated in place, and the logits come back to the host for greedy sampling.

Distributed serving (``mesh=``, a ``distributed.mesh.TrainMesh``, or a
``PoolMesh`` as the mesh ``("model",)``, with ``PagedCacheConfig.num_shards``
= its ``model`` size): every rank runs this engine (SPMD) on its shard of
each layer's page pool (pages over ``model``) and its shard of the weights
(JAX's serving rules, ``ShardPlan.serving``: tensor parallel over
``model`` and, for an FSDP config, every ``embed`` dim over ``data``,
where JAX's engine places its weights under the prefill rules; a model
handed over whole is cut to the rank's shard), the
slots replicated over the batch axes, and decode merges the shards'
attention partials (``distributed/paged.py``). A packed prefill row
``[1, T]`` (and a chunk or verify step's rows) runs under the prefill
rules' ``seq`` where ``model`` divides T, each rank holding T / model rows
of the residual stream, and under ``seq_full`` where the rules set it;
the pool sees the same scatters and reads (``self.plan`` is the rank's
``ShardPlan``).
The numpy host layer is unchanged: block tables keep global page ids, and
its decisions are replicated, since every input to them is equal on every
rank (greedy sampling reads logits the merge made identical; faults, the
watchdog and step budgets run on the iteration clock) — except wall-clock
deadlines, which read each rank's own clock: rank 0 decides which requests
expired and broadcasts them. Copy-on-write and the poison hook go through
the sharded pool ops, and ``run()``'s wall time is rank 0's, so the stats
are equal on every rank. ``snapshot``/``restore`` hold each rank's own
shard of the pool.

Recurrent archs (recurrentgemma's RG-LRU, falcon-mamba's Mamba): every
recurrent layer keeps one fixed state row per decode slot (plus a trailing
trash row), admitted and released by the same scheduler calls that bind a
slot's pages (``serving/state_cache.py``).  Prefill spans route through
per-token ``state_slots``/``state_local`` — the packed scan resets at span
starts, a chunked continuation resumes the slot's stored state, and
span-end state scatters back to the row; decode updates rows gated on
``kv_len > 0``.  A re-admitted slot's first span starts at position 0,
which injects a fresh zero state (``poison_reclaimed`` clobbers released
rows to prove it).
Prefix sharing and speculation are attention-only (the index certifies KV
pages, not state; cumulative state cannot roll back) and raise on
recurrent archs.

Under a mesh the recurrent layers keep every state row on every rank (a
row holds the rank's ``rnn`` channels where ``model`` splits them), beside
the rank's shard of the pools: every rank sees the same tokens, and the
state hooks (admission, release, ``poison_reclaimed``) run on every rank as
the host decisions do.  Every removal of an active sequence still records a
typed outcome.

Split-count autotuning (``autotune=``): the decode and verify steps run with
the split count ``perf/autotune.py`` plans for the card's kernel at this
engine's worst-case geometry (every slot at its full block-table reach;
under a mesh one shard's launch over it, planned on rank 0 and broadcast so
that every rank launches alike); an explicit ``num_splits`` wins. An
attention-free arch (falcon-mamba) has no attention decode to split, and
``autotune=True`` raises ``ValueError`` for it.

The ssm family (falcon-mamba: every layer a Mamba mixer) has no attention
layer: ``_pools()`` is empty and the state rows carry everything. The
scheduler still allocates pages, which no layer reads, so the page
lifecycle and its stats run as for any arch.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.mesh import as_train_mesh
from repro_torch.distributed.paged import (copy_pages_sharded,
                                           poison_pages_sharded)
from repro_torch.models.layers import paged_decode_window
from repro_torch.runtime import tracing
from repro_torch.runtime.steps import make_serve_steps
from repro_torch.serving.drafter import NgramDrafter, longest_accept
from repro_torch.serving.faults import FaultPlan, InjectedCrash
from repro_torch.serving.outcomes import Outcome, RequestResult, outcome_counts
from repro_torch.serving.paged_cache import PagedCacheConfig, TRASH_PAGE
from repro_torch.serving.scheduler import (AdmissionImpossible, ActiveSeq,
                                           Request, Scheduler)


def no_attention_decode(cfg) -> str:
    """Why autotuning refuses an attention-free arch (the ssm family): the
    planner splits the attention decode's KV, and there is none. (JAX's
    engine and launcher divide by the zero KV heads there instead.)"""
    return (f"autotune plans the split count of the attention decode: "
            f"{cfg.name} has no attention layer, so there is no attention "
            f"decode to split")


class ServingEngine:
    """The serving loop: scheduler decisions → the device steps."""

    def __init__(self, cfg, paged_cfg: PagedCacheConfig, params, *,
                 impl: str = "kernel", prefill_len: Optional[int] = None,
                 torch_chunk: int = 1024, mesh=None, device="cuda",
                 eos_id: Optional[int] = None, lazy: bool = False,
                 reclaim: Optional[bool] = None,
                 poison_reclaimed: bool = False,
                 num_splits: Optional[int] = None, autotune: bool = False,
                 share_prefix: bool = False,
                 prefill_chunk: Optional[int] = None,
                 speculate_k: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 max_steps: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 watchdog_patience: int = 16):
        """params: the model (``models.lm.LM``) on ``device``. impl: the
        attention impl (``core.attention.IMPLS``); torch_chunk: the KV chunk
        of ``impl="torch"``'s prefill. mesh: serve over the ranks of a
        ``distributed.mesh.TrainMesh`` or ``PoolMesh`` (module docstring);
        ``device`` is then this rank's. autotune: pick ``num_splits`` with the
        ``perf/autotune.py`` planner (module docstring).
        lazy: admission policy (module docstring). reclaim: free
        fully-out-of-window pages each step — defaults to "whenever the arch
        has a sliding window"; pass False to pin pages for a model's whole
        residency (the pre-reclamation behaviour, kept for A/B tests).
        poison_reclaimed: test hook — overwrite freed pages and the trash
        page with a huge constant, so any kernel read of a reclaimed page
        corrupts the output instead of passing silently.
        num_splits: split-KV decode slices per (batch, kv-head) of the
        decode and verify steps (default 1).
        share_prefix: content-addressed prefix caching + copy-on-write pages
        (module docstring). prefill_chunk: max prompt tokens prefilled per
        engine iteration (None: whole prompts at once), interleaving long
        prompts with decode steps.
        speculate_k: draft up to this many tokens per decode row with the
        prompt-lookup drafter and verify them in one model call (module
        docstring); None/0 turns speculation off.  Token-identical to plain
        greedy decode under every admission/sharing/chunking mode.
        deadline_ms / max_steps: default per-request deadlines — wall-clock
        milliseconds and engine-iteration budget respectively; a request
        exceeding either terminates with a ``TIMEOUT`` outcome and its
        slot/pages/state reclaimed immediately (``submit`` takes per-request
        overrides).  None disables that limit.
        max_queue: bounded admission queue — submissions past this many
        waiting requests shed (reject-newest, typed ``SHED`` outcome)
        instead of queueing without bound.  None: unbounded (the batch-
        replay default).
        fault_plan: a seeded :class:`~repro.serving.faults.FaultPlan` whose
        events this engine applies at host-layer seams each iteration (the
        chaos harness); None serves faithfully.
        watchdog_patience: iterations with zero progress (no tokens, no
        prefill, no completions) the livelock watchdog tolerates before it
        fails a stuck row with a diagnostic ``FAILED`` outcome."""
        assert cfg.causal, "serving needs an autoregressive arch"
        self.has_state = any(k != "attn" for k in cfg.block_pattern)
        if self.has_state and share_prefix:
            raise ValueError(
                "prefix sharing is attention-only: the prefix index "
                "certifies cached KV pages, not recurrent state — a hit "
                "would skip the state computation a resumed scan needs")
        if self.has_state and speculate_k:
            raise ValueError(
                "speculative decoding is attention-only: recurrent state "
                "is cumulative, so rejected drafts cannot be rolled back "
                "logically the way out-of-kv_len page writes can")
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = None if mesh is None else as_train_mesh(mesh)
        self.pool = None if mesh is None else self.mesh.pool_shards
        self.pcfg = paged_cfg
        self.prefill_len = prefill_len or paged_cfg.max_seq_len
        self.eos_id = eos_id                     # default for submissions
        self.lazy = lazy
        self.window = paged_decode_window(cfg)
        self.reclaim = (self.window is not None) if reclaim is None else reclaim
        if self.reclaim and self.window is None:
            raise ValueError("page reclamation needs a sliding-window arch "
                             "(cfg.attn_window is None)")
        self.poison_reclaimed = poison_reclaimed
        self.share_prefix = share_prefix
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be at least one token")
        self.prefill_chunk = prefill_chunk
        if autotune and "attn" not in cfg.block_pattern:
            raise ValueError(no_attention_decode(cfg))
        if num_splits is None:
            num_splits = self._autotuned_splits() if autotune else 1
        self.num_splits = num_splits
        if speculate_k is not None and speculate_k < 0:
            raise ValueError("speculate_k must be a non-negative draft width")
        self.speculate_k = int(speculate_k or 0)
        self.drafter = (NgramDrafter(self.speculate_k)
                        if self.speculate_k else None)
        # with speculation on, a verify step can advance kv_len by up to
        # k + 1 tokens, so every growth pass reserves that many positions
        self._lookahead = self.speculate_k + 1
        arts = make_serve_steps(cfg, impl=impl, paged=paged_cfg, mesh=self.mesh,
                                num_splits=num_splits,
                                torch_chunk=min(torch_chunk, self.prefill_len),
                                device=self.device)
        self.plan = arts.plan
        self.params = params if arts.plan is None else arts.plan.place(params)
        self.prefill_fn = arts.prefill_fn
        self.decode_fn = arts.decode_fn
        self.chunk_prefill_fn = arts.chunk_prefill_fn
        self.verify_fn = arts.verify_fn
        self.caches = arts.cache_init_fn()
        # the scheduler learns the window only when reclamation is on: with
        # reclaim=False pinned-pages runs keep the full-prefix reservation
        # so they reflect the pre-reclamation footprint faithfully
        self.scheduler = Scheduler(
            paged_cfg, lazy=lazy,
            window=self.window if self.reclaim else None,
            share_prefix=share_prefix,
            chunked=prefill_chunk is not None)
        self.util_samples: List[float] = []
        self.pool_samples: List[float] = []      # allocated / usable pages
        self.prefill_tokens = 0                  # prompt tokens run by prefill
        self.drafted_tokens = 0                  # draft tokens sent to verify
        self.accepted_tokens = 0                 # drafts the model agreed with
        self._next_rid = 0
        # rid → the moment its first token's logits reached the host
        # (``tracing.clock``), whatever route gave them
        self.first_token_at: Dict[int, float] = {}
        # -- resilience state (typed outcomes, deadlines, watchdog, faults) --
        self.deadline_ms = deadline_ms
        self.max_steps = max_steps
        self.max_queue = max_queue
        self.fault_plan = fault_plan
        self.watchdog_patience = watchdog_patience
        self.results: Dict[int, RequestResult] = {}   # rid → terminal record
        self.watchdog_fires = 0
        self.cancels = 0
        self._iter = 0            # engine iterations — the fault-plan clock
        self._steps = 0           # decode/verify steps (stats)
        self._stall = 0           # consecutive zero-progress iterations
        self._deadline_at: Dict[int, float] = {}   # rid → absolute wall time
        self._step_limit: Dict[int, int] = {}      # rid → absolute iteration
        self._nan_pending: List[int] = []          # fault args awaiting decode
        self._fault_pocket: List[Tuple[int, List[int]]] = []
        # (release-at iteration, pages) held by the "exhaust" fault

    def decode_shape(self):
        """The worst-case decode geometry this engine can see, as the
        autotune planner takes it: every slot active at its full
        block-table reach, with its window; under a mesh, one shard's
        launch over that table (``DecodeShape.shards``)."""
        from repro_torch.perf.autotune import DecodeShape
        return DecodeShape(
            batch=self.pcfg.max_batch,
            hkv=self.cfg.num_kv_heads,
            group=self.cfg.num_heads // self.cfg.num_kv_heads,
            kv_len=self.pcfg.max_pages_per_seq * self.pcfg.page_size,
            head_dim=self.cfg.head_dim,
            page_size=self.pcfg.page_size,
            dtype_bytes=self.cfg.dtype.itemsize,
            window=self.window or 0,
            shards=1 if self.pool is None else self.pool.size)

    def _autotuned_splits(self) -> int:
        """The decode step's split count from the autotune planner, for
        :meth:`decode_shape`. Plans memoise in the persistent autotune
        cache (``perf/autotune.py``), keyed by that geometry and the
        device; under a mesh rank 0 plans and broadcasts its count."""
        from repro_torch.perf.autotune import (device_name,
                                               plan_decode_persistent)
        mesh = self.mesh
        if mesh is not None and mesh.rank != 0:
            return mesh.broadcast_object(None)
        splits = plan_decode_persistent(
            self.decode_shape(), device=device_name(self.device)).num_splits
        return splits if mesh is None else mesh.broadcast_object(splits)

    # -- request intake ----------------------------------------------------
    def submit(self, tokens, max_new_tokens: int, rid: Optional[int] = None,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               max_steps: Optional[int] = None):
        """Queue one request; validates it can ever be served.

        Malformed requests (empty prompt, duplicate rid, prompts wider than
        a prefill row) still raise — those are caller bugs.  *Capacity*
        rejections are load conditions, not bugs, so they shed instead: a
        full admission queue (``max_queue``) or an impossible page footprint
        (:class:`~repro.serving.scheduler.AdmissionImpossible`) records a
        typed ``SHED`` outcome and returns the rid without queueing.
        deadline_ms / max_steps override the engine-wide defaults for this
        request."""
        tokens = np.asarray(tokens, np.int32)
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        if rid in self.results:
            raise ValueError(
                f"request rid {rid} is already submitted — rids key the "
                f"output dict, a duplicate would drop one generation")
        req = Request(rid=rid, tokens=tokens, max_new_tokens=max_new_tokens,
                      eos_id=self.eos_id if eos_id is None else eos_id)
        # prefill-row-width checks live here (the scheduler doesn't know the
        # engine's prefill_len); empty-prompt / duplicate-rid / pool-capacity
        # validation lives in Scheduler.submit so direct scheduler users get
        # the same guarantees
        if req.prompt_len > self.prefill_len \
                and not (self.share_prefix or self.prefill_chunk):
            # chunked prefill and prefix-hit suffixes span multiple rows, so
            # the one-row limit only binds the classic whole-prompt path
            raise ValueError(f"prompt of {req.prompt_len} tokens exceeds "
                             f"prefill_len={self.prefill_len}")
        if self.lazy and req.budget_tokens > self.prefill_len \
                and not (self.share_prefix or self.prefill_chunk):
            # a preempted row re-prefills prompt+generated, which can reach
            # the full budget — reject now rather than overflow a row later
            raise ValueError(
                f"request {rid}: lazy serving needs prefill_len >= the "
                f"prompt+generation budget ({req.budget_tokens}) so a "
                f"preempted sequence can re-prefill")
        if self.max_queue is not None \
                and len(self.scheduler.waiting) >= self.max_queue:
            self._record_outcome(
                rid, Outcome.SHED, [],
                f"admission queue full ({self.max_queue} waiting) — "
                f"reject-newest backpressure")
            return rid
        try:
            self.scheduler.submit(req)
        except AdmissionImpossible as e:
            self._record_outcome(rid, Outcome.SHED, [], str(e))
            return rid
        dl = self.deadline_ms if deadline_ms is None else deadline_ms
        if dl is not None:
            self._deadline_at[rid] = time.perf_counter() + dl / 1e3
        ms = self.max_steps if max_steps is None else max_steps
        if ms is not None:
            self._step_limit[rid] = self._iter + ms
        return rid

    # -- resilience: outcomes, cancellation, deadlines, watchdog, faults ----
    def _record_outcome(self, rid: int, outcome: Outcome, tokens,
                        reason: str = ""):
        """Write a request's terminal record and retire its deadlines.
        Every path that ends a request funnels through here (or through
        :meth:`_terminate_active`, which calls it) — the invariant the
        ``engine-outcome-taxonomy`` lint rule and the chaos tests pin."""
        self._deadline_at.pop(rid, None)
        self._step_limit.pop(rid, None)
        self.results[rid] = RequestResult.make(rid, outcome, tokens, reason)

    def _terminate_active(self, seq: ActiveSeq, outcome: Outcome,
                          reason: str = ""):
        """End a running sequence early: free its slot, pages, and state row
        immediately and record the typed outcome with its partial tokens."""
        sched = self.scheduler
        del sched.active[seq.slot]
        sched.tables.release(seq.slot)
        self._record_outcome(seq.request.rid, outcome, seq.all_generated,
                             reason)

    def _evict_finished(self) -> List[ActiveSeq]:
        """Evict done sequences and record their ``COMPLETED`` outcomes."""
        done = self.scheduler.evict_finished()
        for seq in done:
            self._record_outcome(seq.request.rid, Outcome.COMPLETED,
                                 seq.all_generated)
        return done

    def cancel(self, rid: int, reason: str = "cancelled by client") -> bool:
        """Cancel a request by rid — waiting or mid-flight.  A waiting
        request leaves the queue; an active one releases its slot, pages,
        and state row immediately.  Either way the request terminates with
        a ``CANCELLED`` outcome keeping any tokens generated so far.
        Returns False when no live request has that rid (already finished,
        shed, or never submitted) — cancellation races are expected under
        load and must not raise."""
        req = self.scheduler.remove_waiting(rid)
        if req is not None:
            self._record_outcome(rid, Outcome.CANCELLED,
                                 req.generated_prefix, reason)
            self.cancels += 1
            return True
        for seq in list(self.scheduler.active.values()):
            if seq.request.rid == rid:
                self._terminate_active(seq, Outcome.CANCELLED, reason)
                self.cancels += 1
                return True
        return False

    def _check_deadlines(self):
        """Expire requests past their wall-clock or engine-step budget:
        waiting ones leave the queue, active ones release everything they
        hold — both with a ``TIMEOUT`` outcome naming the budget that fired."""
        sched = self.scheduler
        now = time.perf_counter()
        expired: Dict[int, str] = {}
        for rid, t in self._deadline_at.items():
            if now >= t:
                expired[rid] = "wall-clock deadline expired"
        if self.mesh is not None and self._deadline_at:
            # each rank reads its own clock: rank 0's decision holds for all
            expired = dict.fromkeys(self.mesh.broadcast_object(sorted(expired)),
                                    "wall-clock deadline expired")
        for rid, limit in self._step_limit.items():
            if self._iter >= limit:
                expired.setdefault(
                    rid, f"engine-step budget exhausted at iteration "
                         f"{self._iter}")
        for rid, why in expired.items():
            req = sched.remove_waiting(rid)
            if req is not None:
                self._record_outcome(rid, Outcome.TIMEOUT,
                                     req.generated_prefix, why)
                continue
            for seq in list(sched.active.values()):
                if seq.request.rid == rid:
                    self._terminate_active(seq, Outcome.TIMEOUT, why)
                    break

    def _release_pocket(self):
        """Return every page the "exhaust" fault pocketed to the allocator —
        at scheduled expiry, before an injected crash, and at loop exit, so
        pool conservation holds at every boundary the tests check."""
        for _, pages in self._fault_pocket:
            self.scheduler.tables.allocator.free(pages)
        self._fault_pocket = []

    def _storm_eligible(self, seq: ActiveSeq) -> bool:
        """A preemption-storm victim must be re-prefillable: with neither
        chunked prefill nor prefix sharing, the resumed prompt+generated
        must still fit one prefill row (lazy admission already guarantees
        that via its submit check; eager does not).  A row that already
        reached its budget is never a victim — resuming a spent request
        would re-prefill it into a one-token overshoot."""
        if seq.done:
            return False
        if self.prefill_chunk or self.share_prefix:
            return True
        return (seq.request.prompt_len + len(seq.generated)) \
            <= self.prefill_len

    def _apply_faults(self):
        """Apply this iteration's :class:`FaultPlan` events at the host
        seams (module docstring of serving/faults.py).  The plan decides,
        this method applies — nothing here touches the device steps."""
        plan = self.fault_plan
        sched = self.scheduler
        alloc = sched.tables.allocator
        due = [p for p in self._fault_pocket if p[0] <= self._iter]
        if due:
            self._fault_pocket = [p for p in self._fault_pocket
                                  if p[0] > self._iter]
            for _, pages in due:
                alloc.free(pages)
        if plan.crash_step is not None and self._iter == plan.crash_step:
            self._release_pocket()
            raise InjectedCrash(
                f"injected crash at engine iteration {self._iter}")
        for ev in plan.events_at(self._iter):
            if ev.kind == "exhaust":
                # pocket only the free list: evicting cached pages would
                # destroy live prefix-index content, which real exhaustion
                # (allocation pressure) is allowed to do but a *transient*
                # fault that gives the pages back must not
                n = alloc.num_free
                pages = alloc.alloc(n) if n else None
                if pages:
                    self._fault_pocket.append(
                        (self._iter + plan.pocket_hold, pages))
            elif ev.kind == "storm":
                victims = sorted(
                    (s for s in sched.active.values()
                     if self._storm_eligible(s)),
                    key=lambda s: s.birth, reverse=True)[:1 + ev.arg % 4]
                for v in victims:
                    sched.preempt(v)
            elif ev.kind == "poison":
                pages = alloc.free_page_ids()
                if pages:
                    self._poison_pages(pages)
                if self.has_state:
                    slots = sched.tables.state.free_slot_ids()
                    if slots:
                        self._poison_state(slots)
            elif ev.kind == "nan":
                self._nan_pending.append(ev.arg)
            elif ev.kind == "cancel":
                live = sorted(
                    {r.rid for r in sched.waiting}
                    | {s.request.rid for s in sched.active.values()})
                if live:
                    self.cancel(live[ev.arg % len(live)],
                                reason="fault-plan cancellation")

    def _stuck_diagnostic(self) -> str:
        """One-line pool/queue picture for watchdog and stuck diagnostics."""
        alloc = self.scheduler.tables.allocator
        return (f"free={alloc.num_free} cached={alloc.num_cached} "
                f"allocated={alloc.num_allocated} "
                f"usable={self.pcfg.usable_pages} "
                f"waiting={len(self.scheduler.waiting)} "
                f"active={len(self.scheduler.active)} "
                f"pocketed={sum(len(p) for _, p in self._fault_pocket)}")

    def _watchdog_fire(self):
        """The livelock watchdog tripped: fail one stuck row — the oldest
        active sequence (holding the most resources for the least progress)
        or, with nothing active, the waiting head — with a diagnostic.
        Every firing removes a request, so a wedged engine drains to
        termination instead of hanging."""
        self.watchdog_fires += 1
        self._stall = 0
        sched = self.scheduler
        why = (f"livelock watchdog: no progress for "
               f"{self.watchdog_patience} iterations ({self._stuck_diagnostic()})")
        if sched.active:
            victim = min(sched.active.values(), key=lambda s: s.birth)
            self._terminate_active(victim, Outcome.FAILED, why)
        elif sched.waiting:
            req = sched.waiting.popleft()
            self._record_outcome(req.rid, Outcome.FAILED,
                                 req.generated_prefix, why)

    # -- crash recovery: host-state snapshot / restore ----------------------
    def snapshot(self) -> Dict[str, object]:
        """Capture the full host serving state plus the device caches as
        host tensors — everything needed to resume this engine's work on a
        fresh engine of the same configuration (``restore`` + ``run()``
        continues token-identically).  The
        scheduler deep-copy carries block tables, allocator, prefix index,
        and state cache in one consistent piece; wall-clock deadlines are
        stored as *remaining* seconds so a pause between snapshot and
        restore doesn't silently expire them.  Any fault pocket is released
        first so pool conservation holds inside the snapshot."""
        self._release_pocket()
        now = time.perf_counter()
        host = {
            "scheduler": self.scheduler,
            "results": self.results,
            "util_samples": self.util_samples,
            "pool_samples": self.pool_samples,
            "prefill_tokens": self.prefill_tokens,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "next_rid": self._next_rid,
            "iter": self._iter,
            "steps": self._steps,
            "stall": self._stall,
            "watchdog_fires": self.watchdog_fires,
            "cancels": self.cancels,
            "step_limit": self._step_limit,
            "deadline_left": {rid: t - now
                              for rid, t in self._deadline_at.items()},
            "nan_pending": self._nan_pending,
        }
        caches = [{k: t.to("cpu", copy=True) for k, t in layer.items()}
                  for layer in self.caches]
        return {"host": copy.deepcopy(host), "caches": caches}

    def restore(self, snap: Dict[str, object]):
        """Adopt a :meth:`snapshot`'s state (deep-copied — restoring twice
        from one snapshot is safe).  The engine must be built with the same
        model/pool configuration; a following ``run()`` resumes serving
        exactly where the snapshot left off."""
        host = copy.deepcopy(snap["host"])
        now = time.perf_counter()
        self.scheduler = host["scheduler"]
        self.results = host["results"]
        self.util_samples = host["util_samples"]
        self.pool_samples = host["pool_samples"]
        self.prefill_tokens = host["prefill_tokens"]
        self.drafted_tokens = host["drafted_tokens"]
        self.accepted_tokens = host["accepted_tokens"]
        self._next_rid = host["next_rid"]
        self._iter = host["iter"]
        self._steps = host["steps"]
        self._stall = host["stall"]
        self.watchdog_fires = host["watchdog_fires"]
        self.cancels = host["cancels"]
        self._step_limit = host["step_limit"]
        self._deadline_at = {rid: now + left
                             for rid, left in host["deadline_left"].items()}
        self._nan_pending = host["nan_pending"]
        self._fault_pocket = []
        with torch.inference_mode():
            for layer, saved in zip(self.caches, snap["caches"]):
                for k, t in saved.items():
                    layer[k].copy_(t)

    # -- one packed prefill wave -------------------------------------------
    def _pack_rows(self, seqs: List[ActiveSeq]) -> List[List[ActiveSeq]]:
        """First-fit pack admitted prompts into prefill_len-wide rows."""
        rows: List[List[ActiveSeq]] = [[]]
        used = 0
        for seq in seqs:  # first-fit in admission order
            n = seq.request.prompt_len
            if used + n > self.prefill_len:
                rows.append([])
                used = 0
            rows[-1].append(seq)
            used += n
        return rows

    def _prefill(self, seqs: List[ActiveSeq]):
        """Run classic packed prefill over whole prompts (no cached prefix:
        per-segment positions from zero, in-row segment-masked attention)."""
        tables = self.scheduler.tables
        for row in self._pack_rows(seqs):
            with tracing.span("serve.prefill",
                              rids=[s.request.rid for s in row],
                              tokens=sum(s.request.prompt_len for s in row),
                              width=self.prefill_len):
                with tracing.span("serve.prefill.pack"):
                    tokens = np.zeros((1, self.prefill_len), np.int32)
                    seg = np.full((1, self.prefill_len), -1, np.int32)
                    pos = np.zeros((1, self.prefill_len), np.int32)
                    slots = np.full((1, self.prefill_len), -1, np.int32)
                    off = 0
                    for i, seq in enumerate(row):
                        n = seq.request.prompt_len
                        tokens[0, off:off + n] = seq.request.tokens
                        seg[0, off:off + n] = i
                        pos[0, off:off + n] = np.arange(n)
                        slots[0, off:off + n] = seq.slot
                        off += n
                    dest = tables.prefill_dest(seg[0], [s.slot for s in row])
                    args = (self._dev(tokens), self._dev(seg), self._dev(pos),
                            self._dev(dest[None]), self._dev(slots))
                # one row of logits a prompt: its last token's
                with tracing.span("serve.prefill.launch"):
                    logits, self.caches = self.prefill_fn(self.params, *args,
                                                          self.caches)
                with tracing.span("serve.prefill.wait"):
                    logits = self._host(logits[:, :self.cfg.vocab_size])
                self._on_host(s.request.rid for s in row)
                for li, seq in enumerate(row):
                    tables.kv_len[seq.slot] = seq.request.prompt_len
                    seq.prefilled = seq.request.prompt_len
                    tables.register_prefilled(seq.slot, seq.prefilled)
                    seq.generated.append(int(logits[li].argmax()))

    def _prefill_chunks(self, spans: List[Tuple[ActiveSeq, int, int]]):
        """Run chunked/suffix prefill spans — tokens ``[start, end)`` of
        sequences whose earlier tokens already sit in pages (prefix hits or
        earlier chunks).  Spans pack first-fit into prefill_len-wide rows;
        each row scatters its K/V first and attends per-token through the
        owning slot's block-table row, so spans of one prompt may split
        across rows (later rows read earlier rows' pages)."""
        tables = self.scheduler.tables
        width = self.prefill_len
        rows: List[List[Tuple[ActiveSeq, int, int]]] = [[]]
        used = 0
        for sp in spans:
            n = sp[2] - sp[1]
            if used + n > width:
                rows.append([])
                used = 0
            rows[-1].append(sp)
            used += n
        for row in rows:
            with tracing.span("serve.prefill",
                              rids=[seq.request.rid for seq, _, _ in row],
                              tokens=sum(b - a for _, a, b in row),
                              width=width):
                with tracing.span("serve.prefill.pack"):
                    tokens = np.zeros((1, width), np.int32)
                    pos = np.zeros((1, width), np.int32)
                    # pad rows finalize to zero, and write to trash slot 0
                    kvl = np.zeros((1, width), np.int32)
                    ttab = np.full((1, width, self.pcfg.max_pages_per_seq),
                                   TRASH_PAGE, np.int32)
                    dest = np.zeros((1, width), np.int32)
                    slots = np.full((1, width), -1, np.int32)
                    local = np.zeros((1, width), np.int32)
                    off = 0
                    marks = []
                    for seq, a, b in row:
                        n = b - a
                        tokens[0, off:off + n] = seq.request.tokens[a:b]
                        pos[0, off:off + n] = np.arange(a, b)
                        kvl[0, off:off + n] = np.arange(a, b) + 1
                        ttab[0, off:off + n] = tables.tables[seq.slot]
                        dest[0, off:off + n] = tables.span_dest(seq.slot, a, b)
                        slots[0, off:off + n] = seq.slot
                        local[0, off:off + n] = np.arange(n)
                        marks.append((seq, b, len(marks)))
                        off += n
                    args = (self._dev(tokens), self._dev(pos), self._dev(dest),
                            self._dev(ttab), self._dev(kvl), self._dev(slots),
                            self._dev(local))
                # one row of logits a span (a row holds a sequence's span
                # once): its last token's
                with tracing.span("serve.prefill.launch"):
                    logits, self.caches = self.chunk_prefill_fn(
                        self.params, *args, self.caches)
                with tracing.span("serve.prefill.wait"):
                    logits = self._host(logits[:, :self.cfg.vocab_size])
                self._on_host(seq.request.rid for seq, end, _ in marks
                              if end == seq.request.prompt_len)
                for seq, end, li in marks:
                    seq.prefilled = end
                    tables.kv_len[seq.slot] = end
                    tables.register_prefilled(seq.slot, end)
                    if end == seq.request.prompt_len:
                        seq.generated.append(int(logits[li].argmax()))

    def _prefill_step(self) -> int:
        """Advance every mid-prompt row, spending at most ``prefill_chunk``
        prompt tokens (unlimited when chunking is off).  Whole prompts with
        no cached prefix take the classic packed path — bit-identical to the
        unshared, unchunked engine — and everything else (prefix-hit
        suffixes, chunk continuations) goes through the per-token path.
        Returns the number of prompt tokens processed."""
        sched = self.scheduler
        pre = [seq for seq in sorted(sched.active.values(),
                                     key=lambda s: s.birth) if seq.prefilling]
        if not pre:
            return 0
        budget = self.prefill_chunk or (1 << 62)
        classic: List[ActiveSeq] = []
        chunks: List[Tuple[ActiveSeq, int, int]] = []
        used = 0
        for seq in pre:
            start = seq.prefilled
            total = seq.request.prompt_len
            while start < total and used < budget:
                end = min(total, start + min(budget - used, self.prefill_len))
                if start == 0 and end == total:
                    classic.append(seq)
                else:
                    chunks.append((seq, start, end))
                used += end - start
                start = end
        if classic:
            self._prefill(classic)
        if chunks:
            self._prefill_chunks(chunks)
        self.prefill_tokens += used
        return used

    def _inject_nan(self, logits: np.ndarray, slots: List[int]
                    ) -> np.ndarray:
        """Apply pending "nan" fault events: corrupt one consumed row's
        logits per event (victim picked by the event arg over the sorted
        consumed slots), exercising the health sentinel below.  Returns the
        (copied, corrupted) logits — the host array may share the step's
        output memory."""
        if self._nan_pending and slots:
            logits = logits.copy()
            for arg in self._nan_pending:
                logits[sorted(slots)[arg % len(slots)]] = np.nan
            self._nan_pending = []
        return logits

    # -- one decode step over every active slot ----------------------------
    def _decode(self) -> int:
        """One fixed-shape decode step over all max_batch slots.  Mid-prefill
        rows ride along masked — trash table, kv_len 0, token 0 — so their
        half-written pages are neither read nor advanced; their garbage
        logits are ignored like any inactive slot's.  Each consumed row's
        logits pass a health sentinel first: a NaN/inf row is quarantined —
        slot/pages/state freed, ``FAILED`` outcome — instead of emitting
        garbage (its kv_len never advances, so the poisoned write is
        unreachable).  Returns the number of tokens emitted."""
        sched = self.scheduler
        tables = sched.tables
        rows = [slot for slot, seq in sched.active.items()
                if not seq.prefilling]
        with tracing.span("serve.decode", rows=len(rows)):
            with tracing.span("serve.decode.prepare"):
                tok = np.zeros((self.pcfg.max_batch,), np.int32)
                bt, kvl = tables.tables, tables.kv_len
                if len(rows) < len(sched.active):
                    bt, kvl = bt.copy(), kvl.copy()
                    for slot, seq in sched.active.items():
                        if seq.prefilling:
                            bt[slot] = TRASH_PAGE
                            kvl[slot] = 0
                for slot in rows:
                    assert tables.append_dest_ok(slot), \
                        f"slot {slot}: write position escaped its owned pages"
                    tok[slot] = sched.active[slot].generated[-1]
                args = (self._dev(tok), self.caches, self._dev(bt),
                        self._dev(kvl))
            with tracing.span("serve.decode.launch"):
                logits, self.caches = self.decode_fn(self.params, *args)
            with tracing.span("serve.decode.wait"):
                logits = self._host(logits[:, :self.cfg.vocab_size])
            with tracing.span("serve.decode.sample"):
                logits = self._inject_nan(logits, rows)
                finite = np.isfinite(logits).all(axis=-1)
                emitted = 0
                bad: List[ActiveSeq] = []
                for slot in rows:
                    seq = sched.active[slot]
                    if not finite[slot]:
                        bad.append(seq)
                        continue
                    tables.kv_len[slot] += 1
                    seq.generated.append(int(logits[slot].argmax()))
                    emitted += 1
                for seq in bad:
                    self._terminate_active(
                        seq, Outcome.FAILED,
                        f"health sentinel: non-finite decode logits (slot "
                        f"{seq.slot})")
        return emitted

    def _decode_spec(self) -> int:
        """One fixed-shape [B, k+1] verify step over all max_batch slots.

        Each non-prefilling row carries its current token plus up to ``k``
        prompt-lookup drafts at positions ``kv_len .. kv_len+k`` (per-token
        causal visibility via ``token_kv_len``, exactly like a chunked
        prefill span); mid-prefill and inactive rows pad with the trash
        table, kv_len 0 and dest 0, so they neither read nor write real
        pages.  After the step the longest draft prefix matching the model's
        own greedy argmaxes is accepted (``longest_accept``) and ``kv_len``
        advances by the emitted count — the K/V of rejected drafts stays in
        owned pages at positions ``>= kv_len``, unreadable until the next
        verify overwrites it.  Drafts are budget-capped so the write never
        exceeds the positions ``ensure_growth(k + 1)`` reserved."""
        sched = self.scheduler
        tables = sched.tables
        width = self.speculate_k + 1
        n_rows = sum(not seq.prefilling for seq in sched.active.values())
        with tracing.span("serve.decode", rows=n_rows):
            with tracing.span("serve.decode.prepare"):
                tok = np.zeros((self.pcfg.max_batch, width), np.int32)
                pos = np.zeros((self.pcfg.max_batch, width), np.int32)
                kvl = np.zeros((self.pcfg.max_batch, width), np.int32)
                ttab = np.full((self.pcfg.max_batch, width,
                                self.pcfg.max_pages_per_seq), TRASH_PAGE,
                               np.int32)
                dest = np.zeros((self.pcfg.max_batch, width), np.int32)
                drafts: Dict[int, np.ndarray] = {}
                for slot, seq in sched.active.items():
                    if seq.prefilling:
                        continue
                    history = np.concatenate(
                        [seq.request.tokens,
                         np.asarray(seq.generated, np.int32)])
                    room = seq.request.max_new_tokens - len(seq.generated)
                    draft = self.drafter.propose(history, max_tokens=room - 1)
                    m = len(draft) + 1
                    L = int(tables.kv_len[slot])
                    assert tables.append_dest_ok(slot, m), \
                        f"slot {slot}: verify write escaped its owned pages"
                    tok[slot, 0] = seq.generated[-1]
                    tok[slot, 1:m] = draft
                    pos[slot, :m] = L + np.arange(m)
                    kvl[slot, :m] = L + 1 + np.arange(m)
                    ttab[slot, :m] = tables.tables[slot]
                    dest[slot, :m] = tables.span_dest(slot, L, L + m)
                    drafts[slot] = draft
                    self.drafted_tokens += len(draft)
                args = (self._dev(tok), self._dev(pos), self._dev(dest),
                        self._dev(ttab), self._dev(kvl))
            with tracing.span("serve.decode.launch"):
                logits, self.caches = self.verify_fn(self.params, *args,
                                                     self.caches)
            with tracing.span("serve.decode.wait"):
                logits = self._host(logits[:, :, :self.cfg.vocab_size])
            with tracing.span("serve.decode.sample"):
                logits = self._inject_nan(logits, list(drafts))
                n_out = 0
                for slot, draft in drafts.items():
                    seq = sched.active[slot]
                    if not np.isfinite(logits[slot, :len(draft) + 1]).all():
                        # health sentinel — same quarantine as plain decode;
                        # only the row's live verify positions are checked
                        # (masked tail positions legitimately carry garbage)
                        self._terminate_active(
                            seq, Outcome.FAILED,
                            f"health sentinel: non-finite verify logits (slot "
                            f"{slot})")
                        continue
                    greedy = logits[slot, :len(draft) + 1].argmax(axis=-1)
                    accepted, emitted = longest_accept(draft, greedy)
                    self.accepted_tokens += accepted
                    eos = seq.request.eos_id
                    if eos is not None and eos in emitted:
                        emitted = emitted[:emitted.index(eos) + 1]
                    seq.generated.extend(emitted)
                    tables.kv_len[slot] += len(emitted)
                    n_out += len(emitted)
        return n_out

    def _apply_cow(self):
        """Apply queued copy-on-write page copies to every layer's pools —
        always before the next device step reads the destination pages (the
        sources still hold their pre-step content: freed source pages are
        never rewritten before the next alloc-and-write, which follows)."""
        pairs = self.scheduler.tables.drain_copies()
        if not pairs:
            return
        src = self._dev(np.asarray([s for s, _ in pairs], np.int64))
        dst = self._dev(np.asarray([d for _, d in pairs], np.int64))
        with torch.inference_mode():
            if self.pool is not None:      # a pair may span two shards
                copy_pages_sharded(self._pools(), src, dst, self.pool)
                return
            for pool in self._pools():     # [Hkv, P, ps, D]
                pool[:, dst] = pool[:, src]

    def _poison_pages(self, pages: List[int]):
        """Test hook: clobber freed pages (plus the trash page their table
        entries now alias) with 1e6 in every layer's pool — reads of a
        reclaimed page then corrupt generations instead of silently reusing
        stale KV.  The window/kv_len gates make poisoned pages inert; the
        reclamation test asserts token-identity under this hook."""
        idx = self._dev(np.asarray(sorted(set(pages) | {TRASH_PAGE}), np.int64))
        with torch.inference_mode():
            if self.pool is not None:      # each shard poisons what it owns
                poison_pages_sharded(self._pools(), idx, self.pool)
                return
            for pool in self._pools():
                pool[:, idx] = 1e6

    def _pools(self) -> List[torch.Tensor]:
        """Every attention layer's k and v pools (this rank's shards under a
        mesh)."""
        return [layer[k] for layer in self.caches if "k_pages" in layer
                for k in ("k_pages", "v_pages")]

    def _poison_state(self, slots: List[int]):
        """Test hook: clobber released recurrent-state rows (plus the
        trailing trash row) with 1e6 in every recurrent layer — any read of
        dead state then corrupts generations instead of passing silently.
        1e6 rather than NaN because legitimately masked gathers (padding
        tokens, fresh spans) multiply the gathered row by zero."""
        idx = self._dev(np.asarray(sorted(set(slots)) + [self.pcfg.max_batch],
                                   np.int64))
        with torch.inference_mode():
            for layer in self.caches:
                if "h" in layer:
                    layer["h"][idx] = 1e6
                    layer["conv"][idx] = 1e6

    def _drain_state_releases(self):
        """Drain slots whose recurrent-state rows just died (finish or
        preemption) and poison them under the test hook.  Correctness never
        needs host-side zeroing — a re-admitted slot's first prefill span
        starts at position 0, which injects a fresh zero state on device —
        so this only arms the stale-read tripwire.  Called before every
        admission pass, i.e. before any re-admitted slot could prefill."""
        released = self.scheduler.tables.state.drain_released()
        if released and self.poison_reclaimed and self.has_state:
            self._poison_state(released)

    def _on_host(self, rids) -> None:
        """Stamp ``first_token_at`` for ``rids``, whose first token's
        logits have just reached the host (a later stamp keeps the
        first)."""
        now = tracing.clock()
        for rid in rids:
            self.first_token_at.setdefault(rid, now)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the engine's device (ids stay
        int32, as the kernels take them)."""
        return torch.as_tensor(a, device=self.device)

    @staticmethod
    def _host(logits: torch.Tensor) -> np.ndarray:
        """Logits back on the host, f32, for greedy sampling."""
        return logits.float().cpu().numpy()

    # -- the serving loop ---------------------------------------------------
    def _iteration(self):
        """One engine iteration: evict → faults → deadlines → reclaim →
        grow/COW → admit → prefill → decode/verify → watchdog.  Each call
        either makes progress (tokens, prefill spans, completions) or moves
        the engine strictly closer to a watchdog firing — which removes a
        request — so ``run`` terminates for every reachable state.

        Eviction runs *before* faults and deadlines: a row that reached its
        budget last iteration has completed, and must record ``COMPLETED``
        before a storm can preempt it (which would re-prefill a spent
        request and overshoot its budget by one token) or a deadline can
        mislabel it ``TIMEOUT``."""
        with tracing.span("serve.iteration"):
            sched = self.scheduler
            with tracing.span("serve.schedule"):
                done = self._evict_finished()
                if self.fault_plan is not None:
                    self._apply_faults()
                if self._deadline_at or self._step_limit:
                    self._check_deadlines()
                if sched.idle:
                    return
                if self.reclaim and sched.active:
                    freed = sched.reclaim(self.window)
                    if freed and self.poison_reclaimed:
                        self._poison_pages(freed)
                self._drain_state_releases()
                n_pre = sched.preemptions
                if sched.active:
                    # running rows claim write pages first — the whole verify
                    # span at once under speculation (lookahead = k + 1)
                    sched.ensure_growth(self._lookahead)
                    self._apply_cow()
                self._drain_state_releases()   # growth-pass preemptions
                admitted = sched.admit()
                if admitted:
                    # newly admitted rows may need a copy-on-write before their
                    # first prefill span (a shared partial-tail block, or the
                    # re-prefilled last token of a fully matched prompt)
                    sched.ensure_growth(self._lookahead)
                    self._apply_cow()
            progressed = self._prefill_step()
            with tracing.span("serve.schedule"):
                if progressed:
                    # max_new == 1 finishes at prefill
                    done += self._evict_finished()
                if sched.active:
                    # just-prefilled rows may sit exactly on a page boundary;
                    # this pass may preempt one of them (its prefill work
                    # survives in generated_prefix and resumes later)
                    sched.ensure_growth(self._lookahead)
                    self._apply_cow()
            emitted = 0
            if any(not seq.prefilling for seq in sched.active.values()):
                u = sched.tables.utilization()
                self.util_samples.append(u["utilization"])
                self.pool_samples.append(u["pool_fraction"])
                emitted = (self._decode_spec() if self.speculate_k
                           else self._decode())
                self._steps += 1
            if emitted or progressed or done:
                # tokens, prefill spans, or completions: real progress — an
                # admitted wave may finish entirely at prefill (max_new == 1),
                # a preemption wave empties the active set to retry next
                # iteration, and a chunked-prefill step may advance prompts
                # without decoding; all reset the watchdog
                self._stall = 0
                return
            if sched.waiting and not sched.active and not admitted \
                    and sched.preemptions == n_pre:
                # no admission, no prefill, no preemption, nothing decodable:
                # the waiting head can never be served — fail it with a
                # diagnostic and keep serving the rest (the pre-resilience
                # engine raised here, taking the whole batch down)
                req = sched.waiting.popleft()
                self._record_outcome(
                    req.rid, Outcome.FAILED, req.generated_prefix,
                    "scheduler stuck: nothing active yet nothing admissible — "
                    + self._stuck_diagnostic())
                return
            self._stall += 1
            if self._stall > self.watchdog_patience:
                self._watchdog_fire()

    def run(self, requests: Optional[List[Tuple[np.ndarray, int]]] = None
            ) -> Tuple[Dict[int, np.ndarray], Dict[str, object]]:
        """Serve until the queue drains. requests: (prompt_tokens, max_new)
        pairs to submit first. Returns ({rid: generated tokens} for the
        ``COMPLETED`` requests, stats — with every request's typed outcome
        tallied under ``stats["outcomes"]`` and per-request records in
        ``self.results``)."""
        for tokens, max_new in requests or []:
            self.submit(tokens, max_new)
        sched = self.scheduler
        t0 = time.perf_counter()
        try:
            while not sched.idle:
                self._iteration()
                self._iter += 1
        finally:
            # an injected crash (or any error) must not strand pocketed
            # pages: conservation holds at every exit
            self._release_pocket()
        wall = time.perf_counter() - t0
        if self.mesh is not None:          # equal stats on every rank
            wall = self.mesh.broadcast_object(wall)
        steps = self._steps
        out = {rid: res.tokens for rid, res in sorted(self.results.items())
               if res.outcome is Outcome.COMPLETED}
        n_tok = sum(len(g) for g in out.values())
        tables = sched.tables
        stats = {
            "wall_s": wall,
            "decode_steps": float(steps),
            "generated_tokens": float(n_tok),
            "tokens_per_s": n_tok / max(wall, 1e-9),
            "mean_utilization": (float(np.mean(self.util_samples))
                                 if self.util_samples else 0.0),
            "mean_pool_fraction": (float(np.mean(self.pool_samples))
                                   if self.pool_samples else 0.0),
            "preemptions": float(sched.preemptions),
            "pages_grown": float(tables.pages_grown),
            "pages_reclaimed": float(tables.pages_reclaimed),
            "prefill_tokens": float(self.prefill_tokens),
            "prefill_tokens_skipped": float(sched.prefill_skipped),
            "pages_shared": float(tables.pages_shared),
            "pages_allocated": float(tables.allocator.total_allocs),
            "cow_copies": float(tables.cow_copies),
            "state_releases": float(tables.state.releases),
            "drafted_tokens": float(self.drafted_tokens),
            "accepted_tokens": float(self.accepted_tokens),
            "acceptance_rate": (self.accepted_tokens /
                                max(self.drafted_tokens, 1)),
            "watchdog_fires": float(self.watchdog_fires),
            "cancels": float(self.cancels),
            "outcomes": outcome_counts(self.results),
        }
        return out, stats
