"""Collective traffic of the port's steps (counterpart of
``repro.perf.hlo_analysis``).

JAX parses its collectives out of compiled HLO; the port has no HLO and
makes its collectives itself, so it costs the calls a step makes:
``distributed/collectives.log`` records each call's kind, its result's
bytes under JAX's convention (the all-reduce's tensor, the all-gather's
whole gathered tensor, the reduce-scatter's shard) and its group size n.
Each is costed with the ring-algorithm bytes a participating device moves,
JAX's formulas:

    all-reduce       2·S·(n−1)/n      (reduce-scatter + all-gather ring)
    all-gather       S·(n−1)/n        (S = full gathered size)
    reduce-scatter   S·(n−1)          (S = scattered shard size; input S·n)
    all-to-all       S·(n−1)/n
    collective-permute S

with n = max(2, group size), as JAX takes it. Bytes are per device; the
roofline divides them by a link's rate.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List


@dataclasses.dataclass
class CollectiveStats:
    """Collective traffic of one logged step (JAX's fields)."""
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]
    total_bytes: float
    ops: List[dict]


def collective_stats(log: Iterable[dict]) -> CollectiveStats:
    """Total the ring bytes of the calls of ``log`` (entries ``{"kind",
    "bytes", "group"}``, ``collectives.log``'s)."""
    bytes_by_kind: Dict[str, float] = defaultdict(float)
    count_by_kind: Dict[str, int] = defaultdict(int)
    ops = []
    for call in log:
        kind, size = call["kind"], call["bytes"]
        n = max(2, call["group"])
        if kind == "all-reduce":
            dev = 2.0 * size * (n - 1) / n
        elif kind == "all-gather":
            dev = size * (n - 1) / n
        elif kind == "reduce-scatter":
            dev = size * (n - 1)
        elif kind == "all-to-all":
            dev = size * (n - 1) / n
        else:                             # collective-permute
            dev = size
        bytes_by_kind[kind] += dev
        count_by_kind[kind] += 1
        ops.append({"kind": kind, "result_bytes": size, "group": n,
                    "device_bytes": dev})
    return CollectiveStats(dict(bytes_by_kind), dict(count_by_kind),
                           sum(bytes_by_kind.values()), ops)
