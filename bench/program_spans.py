"""The program's own spans (``repro_torch.runtime.tracing``), as the
per-layer metrics of ``bench/metrics/`` read them: those of the window,
the profiled part left out (the profiler slows the host). A program
without the recorder has none, and its readers read None."""

from __future__ import annotations

from typing import List, Optional


def window(run, name: str) -> List:
    """The program's spans ``name`` that started and ended inside the
    window and outside its profiled part; [] where the program records
    none."""
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return []
    out = tracing.spans(name, run.t0, run.t1)
    if run.profiled is None:
        return out
    a, b = run.profiled
    return [s for s in out if s.t1 <= a or s.t0 >= b]


def mean_ms(run, name: str) -> Optional[float]:
    """Mean host duration of the window's spans ``name``, in ms."""
    got = window(run, name)
    if not got:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in got) / len(got)


def device_ms_a_step(run, name: str) -> Optional[float]:
    """Device ms of the spans ``name`` a ``train.step``, summed within each
    of the window's steps (microbatches), mean over the steps; None where
    a span has no device time (the CPU)."""
    steps = window(run, "train.step")
    held = {id(s): 0.0 for s in steps}
    for s in window(run, name):
        if id(s.parent) in held:
            if s.device_ms is None:
                return None
            held[id(s.parent)] += s.device_ms
    if not steps:
        return None
    return sum(held.values()) / len(steps)
