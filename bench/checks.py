"""The comparisons that decide ``correct``: each number a run compares,
against its limit from ``bench/limits/<cell>.json``."""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, List, Tuple


def worst_leaf(got: Dict[str, float], ref: Dict[str, float],
               names: List[str]) -> Tuple[float, str]:
    """The largest gap |got - ref| of a leaf's norm over ``names``, each
    measured against the reference's norm of that leaf or of the median
    leaf, whichever is larger; with the leaf that gives it."""
    floor = median(ref[n] for n in names)
    worst = max(names, key=lambda n: abs(got[n] - ref[n]) / max(ref[n], floor))
    return abs(got[worst] - ref[worst]) / max(ref[worst], floor), worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): correct where every number is
    finite and at most its limit (a number without a limit is an error)."""
    out = {name: {"value": numbers[name], "limit": limits[name]} for name in numbers}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in out.values())
    return ok, out
