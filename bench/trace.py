"""Spans, counters and the device trace of a run.

``Recorder`` keeps host spans (name, start, end, attributes) in memory,
taken by the benchmark's own files around its calls into the program; in
a traced run each span is also a ``record_function`` range, so the
profiler's timeline says what the host was doing. ``install`` wraps the
port's attention entries (``kernels/ops``' forward, backward and paged
decode) in ``record_function`` ranges and records each call's roofline
bound (``flops.py``) while the profiler runs. ``Profile`` runs
``torch.profiler`` over part of the window and reduces its events, in
memory, to what the per-layer metrics read: busy time, device time under
each range and under aten's matrix products, the top kernels and the idle
gaps by the host span they fell in.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Optional

from bench import flops

#: the ranges around the port's attention entries
ATTN_RANGES = ("bench.attn_fwd", "bench.attn_bwd", "bench.attn_decode")
#: aten's matrix-product ops, whatever library runs them
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul",
              "aten::linear")
SPAN_PREFIX = "bench.span."
#: the port's kernels under each range, by name: they are launched from
#: the port's own libraries (ctypes), so the profiler does not link them to
#: the range that launched them as it links aten's kernels
PORT_KERNELS = {"bench.attn_fwd": "::fwd_kernel<",
                "bench.attn_bwd": "::flash_bwd_kernel<",
                "bench.attn_decode": "::decode_kernel<"}


def port_range(kernel: str) -> Optional[str]:
    """The range whose port kernel ``kernel`` is, or None."""
    for name, pattern in PORT_KERNELS.items():
        if pattern in kernel:
            return name
    return None


def _linked_device_s(e) -> float:
    """Device seconds of the kernels linked to event ``e`` and its
    children, the port's kernels left out (they are counted by name)."""
    own = sum(k.duration for k in e.kernels if port_range(k.name) is None)
    return own / 1e6 + sum(_linked_device_s(c) for c in e.cpu_children)


class Recorder:
    """Host spans and counters of one run, and the attention calls the
    wrappers saw while tracing."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.spans: List[tuple] = []        # (name, t0, t1, attrs)
        self.calls: List[tuple] = []        # (range, bound_s)
        self.context: Dict[str, int] = {}   # host facts the wrappers read
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        rf = None
        if self.tracing:
            from torch.profiler import record_function
            rf = record_function(SPAN_PREFIX + name)
            rf.__enter__()
        t0 = self.clock()
        try:
            yield attrs
        finally:
            t1 = self.clock()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.spans.append((name, t0, t1, attrs))

    def between(self, name: str, t0: float, t1: float) -> List[tuple]:
        """Spans ``name`` that started at or after t0 and ended by t1."""
        return [s for s in self.spans if s[0] == name and s[1] >= t0 and s[2] <= t1]


#: the recorder the wrappers feed: ``ops``' functions are the process's, so
#: they are wrapped once and each run's ``install`` points them at its own
_ACTIVE: List[Recorder] = []


def install(rec: Recorder) -> None:
    """Wrap ``repro_torch.kernels.ops``' calls of the forward, backward and
    paged-decode kernels, once a process; ``rec`` becomes the recorder the
    wrappers feed. While ``rec.tracing``, each call runs inside its
    ``record_function`` range and adds its bound to ``rec.calls``. Pairs
    of a packed (segment) call and K/V rows of a paged call come from the
    host (``rec.context["pairs"]``, ``["decode_kv"]``), so no wrapper
    reads the device."""
    from repro_torch.kernels import ops

    first = not _ACTIVE
    _ACTIVE[:] = [rec]
    if not first:
        return
    fwd, bwd, dec = ops.flash_fwd, ops.flash_bwd, ops.flash_paged_decode

    def n_pairs(q, k, kw):
        if kw.get("segment_ids") is not None:
            return _ACTIVE[0].context["pairs"]
        return flops.pairs(q.shape[2], kw.get("causal", False)) \
            if q.shape[2] == k.shape[2] else q.shape[2] * k.shape[2]

    def traced(name, call, cost):
        def wrapper(*args, **kw):
            r = _ACTIVE[0]
            if not r.tracing:
                return call(*args, **kw)
            from torch.profiler import record_function
            with record_function(name):
                out = call(*args, **kw)
            r.calls.append((name, flops.bound_s(*cost(r, *args, **kw))))
            return out
        return wrapper

    def fwd_cost(r, q, k, v, **kw):
        b, hq, sq, d = q.shape
        seg = kw.get("segment_ids")
        return flops.attn_fwd_cost(b, hq, k.shape[1], sq, k.shape[2], d,
                                   n_pairs(q, k, kw), q.element_size(),
                                   0 if seg is None else seg.numel())

    def bwd_cost(r, q, k, v, o, lse, do, **kw):
        b, hq, sq, d = q.shape
        return flops.attn_bwd_cost(b, hq, k.shape[1], sq, k.shape[2], d,
                                   n_pairs(q, k, kw), q.element_size())

    def dec_cost(r, q, k_pages, v_pages, block_tables, kv_len, **kw):
        b, hq, d = q.shape
        return flops.paged_decode_cost(b, hq, k_pages.shape[0], d,
                                       r.context["decode_kv"],
                                       block_tables.shape[1], q.element_size())

    ops.flash_fwd = traced("bench.attn_fwd", fwd, fwd_cost)
    ops.flash_bwd = traced("bench.attn_bwd", bwd, bwd_cost)
    ops.flash_paged_decode = traced("bench.attn_decode", dec, dec_cost)


def launch_counts() -> Dict[str, int]:
    """The port's kernel launch counters: row 1, rows 2-3, row 5."""
    from repro_torch.kernels import decode, flash_bwd, flash_fwd
    return {"flash_fwd": flash_fwd.launches, "flash_bwd": flash_bwd.launches_bwd,
            "paged_decode": decode.launches_paged}


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _holder(spans, starts, t: float, reach: int = 64) -> str:
    """The name of the innermost span (the latest to start) that holds
    time t; spans on one thread nest or follow each other, so it is among
    the last few that started before t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if spans[j][1] >= t:
            return spans[j][2]
    return "outside any span"


def _sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Profile:
    """``torch.profiler`` over part of a run's window; after ``stop``,
    ``reduce`` (once the window has closed) turns it into a ``summary``
    dict (seconds throughout)."""

    def __init__(self, rec: Recorder):
        self.rec = rec
        self.summary: Optional[dict] = None
        self._prof = None
        self._stopped = None
        self.ran = False
        self.t0 = 0.0
        self.interval = None       # (start, end) on the recorder's clock

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        _sync()
        self._prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.cuda.is_available() else []))
        self._prof.start()
        self.rec.tracing = True
        self.rec.calls.clear()
        self.ran = True
        self.t0 = self.rec.clock()

    def stop(self) -> None:
        _sync()
        wall = self.rec.clock() - self.t0
        self.rec.tracing = False
        self._prof.stop()
        self._stopped, self._wall, self._prof = self._prof, wall, None
        self.interval = (self.t0, self.t0 + wall)

    def reduce(self, log=None) -> Optional[dict]:
        """The summary of the profiled part (reduced once, after the window;
        ``log`` is told how long that took)."""
        if self._stopped is not None:
            t = self.rec.clock()
            self.summary = summarize(self._stopped.events(), self._wall)
            self._stopped = None
            if log is not None:
                log(f"trace of {self._wall:.2f} s reduced in {self.rec.clock() - t:.1f} s")
        return self.summary


def summarize(events, wall: float) -> dict:
    """Busy seconds (the union of device intervals), device seconds under
    each ``ATTN_RANGES`` range (aten's kernels linked to it, and the port's
    kernels of the range by name) and under the outermost matrix-product
    ops, device seconds by kernel name, and the idle gaps between device
    intervals, by the host span whose range holds the gap's middle."""
    from torch.autograd import DeviceType

    device, cpu = [], []
    for e in events:
        if e.device_type == DeviceType.CPU:
            cpu.append(e)
        elif not getattr(e, "is_user_annotation", False) \
                and not e.name.startswith("bench."):
            device.append(e)
    merged = _union((e.time_range.start, e.time_range.end) for e in device)
    busy = sum(b - a for a, b in merged) / 1e6
    ranges = {name: 0.0 for name in ATTN_RANGES}
    matmul = 0.0
    spans = []
    for e in cpu:
        if e.name in ranges:
            ranges[e.name] += _linked_device_s(e)
        elif e.name in MATMUL_OPS:
            parent = e.cpu_parent
            while parent is not None and parent.name not in MATMUL_OPS:
                parent = parent.cpu_parent
            if parent is None:
                matmul += e.device_time_total / 1e6
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.time_range.start, e.time_range.end,
                          e.name[len(SPAN_PREFIX):]))
    by_kernel: Dict[str, float] = {}
    for e in device:
        t = (e.time_range.end - e.time_range.start) / 1e6
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + t
        if port_range(e.name) is not None:
            ranges[port_range(e.name)] += t
    spans.sort()
    starts = [s[0] for s in spans]
    idle: Dict[str, float] = {}
    for (_, end), (start, _) in zip(merged, merged[1:]):
        label = _holder(spans, starts, 0.5 * (end + start))
        idle[label] = idle.get(label, 0.0) + (start - end) / 1e6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": wall, "ranges": ranges,
            "matmul_s": matmul, "device_ops": [[n[:200], t] for n, t in top],
            "idle_gaps": [[n, t] for n, t in gaps]}
