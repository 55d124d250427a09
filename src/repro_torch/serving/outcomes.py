"""Typed request outcomes: how every serving request terminates.

The resilience contract (docs/serving.md, "Resilience") is that **every**
request the engine ever accepts ends in exactly one typed outcome — there
is no way for a request to vanish from the books, hang forever, or fail
with an engine-wide exception that takes its batch-mates down with it:

* ``COMPLETED`` — ran to its budget or emitted EOS; its tokens are in the
  ``run()`` output dict keyed by rid (the pre-resilience behaviour).
* ``CANCELLED`` — removed by :meth:`~repro.serving.engine.ServingEngine.cancel`
  (waiting or mid-flight); partial tokens are kept in the result record.
* ``TIMEOUT``   — exceeded its wall-clock deadline or its engine-step
  budget; slot/pages/state reclaimed immediately, partial tokens kept.
* ``SHED``      — rejected at submit: the bounded admission queue was full
  (reject-newest backpressure) or the request's worst-case page footprint
  can never fit the pool (``AdmissionImpossible``).  Never occupied a slot.
* ``FAILED``    — quarantined by a health sentinel (non-finite decode
  logits) or killed by the livelock watchdog, with a diagnostic ``reason``.

This module is part of the serving host layer (sparklint's
``host-layer-numpy-only`` rule covers it): plain numpy/python, no jax.  The
companion sparklint rule ``engine-outcome-taxonomy`` enforces that every
engine code path removing an active sequence records one of these.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, List

import numpy as np


class Outcome(enum.Enum):
    """The five terminal states of a serving request (module docstring)."""
    COMPLETED = "completed"
    CANCELLED = "cancelled"
    TIMEOUT = "timeout"
    SHED = "shed"
    FAILED = "failed"


@dataclasses.dataclass
class RequestResult:
    """One request's terminal record: outcome, tokens produced, diagnosis.

    ``tokens`` holds whatever the request generated before terminating —
    the full generation for ``COMPLETED``, a partial one for
    ``CANCELLED``/``TIMEOUT``/``FAILED``, empty for ``SHED``.  ``reason``
    is a human-readable diagnostic for the non-completed outcomes (which
    deadline fired, what the watchdog saw, which sentinel tripped).
    """
    rid: int
    outcome: Outcome
    tokens: np.ndarray
    reason: str = ""

    @staticmethod
    def make(rid: int, outcome: Outcome, tokens: Iterable[int],
             reason: str = "") -> "RequestResult":
        """Build a record, normalizing ``tokens`` to an int32 array."""
        return RequestResult(rid=rid, outcome=outcome,
                             tokens=np.asarray(list(tokens), np.int32),
                             reason=reason)


def outcome_counts(results: Dict[int, RequestResult]) -> Dict[str, int]:
    """Per-outcome totals over a result map — the ``stats["outcomes"]``
    payload and the launcher's final report line.  Every outcome appears
    (zero-filled), so consumers can index unconditionally."""
    counts = {o.value: 0 for o in Outcome}
    for res in results.values():
        counts[res.outcome.value] += 1
    return counts


def untyped_rids(submitted: Iterable[int],
                 results: Dict[int, RequestResult]) -> List[int]:
    """Submitted rids with no terminal record — the chaos harness's
    zero-untyped-outcomes assertion (must always return ``[]`` after
    ``run()`` drains)."""
    return sorted(set(submitted) - set(results))
