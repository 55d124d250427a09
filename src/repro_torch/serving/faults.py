"""Deterministic fault injection for the serving engine ("chaos" harness).

A :class:`FaultPlan` is a seeded, replayable schedule of host-layer faults:
the plan is generated once from a ``numpy`` PRNG seed (same seed → the
exact same event tuple, byte for byte), and the engine consults it at the
top of every iteration.  The plan only *decides* — picking steps, kinds,
and victim indices — while the engine *applies* each event at the existing
host-layer seams (allocator, scheduler, state cache, decode logits), so
injection never perturbs the jitted device steps.

Fault kinds (``FaultEvent.kind``):

* ``"exhaust"`` — grab every free page from the allocator into a side
  pocket for ``pocket_hold`` steps, forcing growth failures / preemption
  exactly as a saturated pool would.
* ``"storm"``   — preempt the youngest eligible active rows (a preemption
  storm), exercising resume-from-prefix paths.
* ``"poison"``  — overwrite currently *free* pages and *free* state rows
  with huge garbage on device, proving reclaimed storage is never read.
* ``"nan"``     — corrupt one slot's decode logits with NaN for one step;
  the engine's health sentinel must quarantine that row (``FAILED``).
* ``"cancel"``  — cancel a live request mid-flight via the public
  :meth:`~repro.serving.engine.ServingEngine.cancel` API.

``crash_step`` additionally raises :class:`InjectedCrash` at the top of
that iteration, after which the host state can be snapshotted and a fresh
engine restored to resume token-identically (pinned in ``tests/test_chaos.py``).

Host layer: plain numpy/python, no jax (sparklint ``host-layer-numpy-only``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

KINDS: Tuple[str, ...] = ("exhaust", "storm", "poison", "nan", "cancel")


class InjectedCrash(RuntimeError):
    """Raised by the engine when a FaultPlan's ``crash_step`` fires.

    Deliberately *not* a typed request outcome: a crash kills the process
    mid-flight, and recovery is snapshot/restore, not per-request
    bookkeeping.  The engine releases any fault pocket before raising so
    pool conservation holds at the crash boundary.
    """


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fire at iteration ``step``, of kind ``kind``.

    ``arg`` disambiguates the victim where one is needed — storm width for
    ``"storm"``, a live-rid index for ``"cancel"``, a consumed-slot index
    for ``"nan"``; unused otherwise.
    """
    step: int
    kind: str
    arg: int = 0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, replayable schedule of :class:`FaultEvent`s.

    Constructing two plans with the same ``(seed, horizon, events_per_kind,
    kinds, crash_step, pocket_hold)`` yields identical ``events`` tuples —
    the determinism contract the chaos tests pin.  Pass ``events=``
    explicitly to hand-author a plan (seed is then ignored for scheduling
    but still recorded).
    """
    seed: int = 0
    horizon: int = 64
    events_per_kind: int = 2
    kinds: Tuple[str, ...] = KINDS
    crash_step: Optional[int] = None
    pocket_hold: int = 3
    events: Tuple[FaultEvent, ...] = dataclasses.field(default=None)  # type: ignore[arg-type]

    def __post_init__(self):
        for k in self.kinds:
            if k not in KINDS:
                raise ValueError(f"unknown fault kind {k!r} (known: {KINDS})")
        if self.events is None:
            object.__setattr__(self, "events", self._generate())
        else:
            object.__setattr__(self, "events", tuple(sorted(
                self.events, key=lambda e: (e.step, e.kind, e.arg))))

    def _generate(self) -> Tuple[FaultEvent, ...]:
        rs = np.random.RandomState(self.seed)
        out: List[FaultEvent] = []
        for kind in self.kinds:
            # Skip step 0 so every run admits at least one wave cleanly.
            steps = rs.randint(1, max(2, self.horizon), size=self.events_per_kind)
            args = rs.randint(0, 8, size=self.events_per_kind)
            out.extend(FaultEvent(int(s), kind, int(a))
                       for s, a in zip(steps, args))
        return tuple(sorted(out, key=lambda e: (e.step, e.kind, e.arg)))

    def events_at(self, step: int) -> List[FaultEvent]:
        """All events scheduled for engine iteration ``step``."""
        return [e for e in self.events if e.step == step]

    def describe(self) -> Dict[str, object]:
        """JSON-friendly summary for benchmark artifacts and logs."""
        return {
            "seed": self.seed,
            "crash_step": self.crash_step,
            "pocket_hold": self.pocket_hold,
            "events": [[e.step, e.kind, e.arg] for e in self.events],
        }


def plan_for_seeds(seeds: Sequence[int], **kwargs) -> List[FaultPlan]:
    """One plan per seed with shared knobs — the fuzz-matrix helper."""
    return [FaultPlan(seed=int(s), **kwargs) for s in seeds]
