"""Arithmetic the metric readers of ``bench/metrics/`` share. A reader
returns None where its run has nothing to read, and the harness then
leaves the metric out of the result line."""

from __future__ import annotations

import math
from typing import Optional

from bench import flops


def peak(run) -> float:
    return flops.PEAK_FLOPS[run.dtype]


def counted(run, t: float) -> bool:
    """Whether a record at time t counts: inside the window, outside its
    profiled part (the profiler slows the host)."""
    if not run.t0 <= t <= run.t1:
        return False
    return run.profiled is None or not run.profiled[0] <= t <= run.profiled[1]


def counted_s(run) -> float:
    """The window's seconds outside its profiled part."""
    a, b = run.profiled or (run.t0, run.t0)
    return (run.t1 - run.t0) - (min(b, run.t1) - max(a, run.t0))


def spans(run, name: str):
    """The window's spans ``name``, those inside the profiled part left
    out (the profiler slows the host)."""
    out = run.rec.between(name, run.t0, run.t1)
    if run.profiled is None:
        return out
    a, b = run.profiled
    return [s for s in out if s[2] <= a or s[1] >= b]


def mean_span_ms(run, name: str) -> Optional[float]:
    """Mean duration of the window's spans ``name`` (outside the profiled
    part), in ms."""
    spans_ = spans(run, name)
    if not spans_:
        return None
    return 1e3 * sum(t1 - t0 for _, t0, t1, _ in spans_) / len(spans_)


def roofline_pct(run, name: str) -> Optional[float]:
    """The traced calls' bounds over the device time under their range
    ``name``, in %."""
    prof = run.profile
    bound = sum(b for n, b in run.rec.calls if n == name)
    if prof is None or bound == 0.0 or prof["ranges"].get(name, 0.0) == 0.0:
        return None
    return 100.0 * bound / prof["ranges"][name]


def idle_pct(run) -> Optional[float]:
    prof = run.profile
    if prof is None or prof["busy_s"] == 0.0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank (a missing value is inf)."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]
