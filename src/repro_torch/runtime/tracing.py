"""Spans and counters of the port: one recorder for the process.

``span(name, **attrs)`` records ``(name, t0, t1, parent, attrs)`` on
``time.perf_counter``: ``parent`` is the span that was open when it
opened, so a layer's self time is its span less its children. Spans go
into a ring of :data:`RING_SPANS` in memory; beyond it the oldest are
dropped. Nothing is written anywhere: :func:`spans` reads them,
:func:`counters` reads the kernels' launch counters and the collectives'
statistics where their modules keep them, and :func:`reset` clears both.

Recording is on unless ``REPRO_TORCH_TRACE=0`` is set in the environment
or :func:`enable` turns it off; off, a span is one flag check.

While ``torch.profiler`` runs, each span is also the
``record_function("repro_torch." + name)`` range, so the profiler's trace
shows the program's spans on its own clock, nested as they are; while no
profiler runs, no range is entered.

``span(name, device=...)`` (True: the current CUDA device; or a
``torch.device``) also records a CUDA event on the device's stream at
each end: ``device_ms`` is their elapsed time, resolved without blocking
(``Event.query``) as later spans open and when spans are read; None on
the CPU, or while the device has not reached the span's end.

The span names the port records (``docs/tracing.md``): ``data.place``;
``train.step`` ⊃ ``train.forward``, ``train.backward``,
``train.optimizer``; ``serve.iteration`` ⊃ ``serve.schedule``,
``serve.prefill`` (⊃ ``.pack``, ``.launch``, ``.wait``), ``serve.decode``
(⊃ ``.prepare``, ``.launch``, ``.wait``, ``.sample``); ``dist.merge``.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

#: spans the ring holds; the oldest are dropped beyond it
RING_SPANS = 1 << 16
#: the prefix of the spans' ``record_function`` ranges
RANGE_PREFIX = "repro_torch."

clock = time.perf_counter

_on = os.environ.get("REPRO_TORCH_TRACE", "1") != "0"
_ring: collections.deque = collections.deque(maxlen=RING_SPANS)
_recorded = 0                           # spans recorded since the last reset
_pending: collections.deque = collections.deque()   # device spans to resolve


class _Open(threading.local):
    span: Optional["Span"] = None       # the thread's innermost open span


_open = _Open()
_cuda: Optional[bool] = None


class Span:
    """One span: ``name``, ``t0`` / ``t1`` (``clock`` seconds), ``parent``
    (the enclosing span or None), ``attrs`` and ``device_ms``."""

    __slots__ = ("name", "t0", "t1", "parent", "attrs", "device_ms", "_rf",
                 "_ev")

    def __init__(self, name: str, stream, attrs: dict):
        self.name, self.attrs, self._ev = name, attrs, stream
        self.t1 = self.device_ms = self._rf = None

    def __enter__(self) -> "Span":
        if _pending:
            _resolve()
        self.parent = _open.span
        _open.span = self
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(RANGE_PREFIX + self.name)
            self._rf.__enter__()
        if self._ev is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._ev)
            self._ev = (start, self._ev)
        self.t0 = clock()
        return self

    def __exit__(self, *exc) -> bool:
        global _recorded
        self.t1 = clock()
        if self._ev is not None:
            start, stream = self._ev
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self._ev = (start, end)
            _pending.append(self)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _open.span = self.parent
        _ring.append(self)
        _recorded += 1
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.t0!r}, {self.t1!r}, "
                f"parent={getattr(self.parent, 'name', None)!r}, "
                f"attrs={self.attrs!r}, device_ms={self.device_ms!r})")


class _Off:
    """The span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _stream(device):
    """The CUDA stream a device span records its events on, or None."""
    global _cuda
    if _cuda is None:
        _cuda = torch.cuda.is_available()
    if not _cuda:
        return None
    if device is True:
        return torch.cuda.current_stream()
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def span(name: str, device=None, **attrs):
    """A context manager that records the span ``name`` with ``attrs``
    (module docstring); ``device`` (True or a ``torch.device``) times it on
    that CUDA device's stream too."""
    if not _on:
        return _OFF
    return Span(name, _stream(device) if device else None, attrs)


def _resolve() -> None:
    """Give the device spans whose end the device has reached their
    ``device_ms``, in order, without waiting."""
    while _pending:
        sp = _pending[0]
        start, end = sp._ev
        if not end.query():
            return
        sp.device_ms = start.elapsed_time(end)
        sp._ev = None
        _pending.popleft()


def spans(name: Optional[str] = None, t0: Optional[float] = None,
          t1: Optional[float] = None) -> List[Span]:
    """The ring's spans (``name``'s only, where given) that started at or
    after ``t0`` and ended by ``t1`` (None: no bound), in the order they
    ended."""
    _resolve()
    return [s for s in _ring if (name is None or s.name == name)
            and (t0 is None or s.t0 >= t0) and (t1 is None or s.t1 <= t1)]


def counters() -> Dict[str, float]:
    """The kernels' launch counters and the collectives' statistics, read
    from their modules, and the spans recorded and dropped since the last
    :func:`reset`."""
    from repro_torch.distributed import collectives
    from repro_torch.kernels import decode, flash_bwd, flash_fwd
    return {"flash_fwd.launches": flash_fwd.launches,
            "flash_bwd.launches_bwd": flash_bwd.launches_bwd,
            "decode.launches": decode.launches,
            "decode.launches_partials": decode.launches_partials,
            "decode.launches_paged": decode.launches_paged,
            "decode.launches_paged_valid": decode.launches_paged_valid,
            **{f"collectives.{k}": v for k, v in collectives.stats.items()},
            "tracing.spans": _recorded,
            "tracing.dropped": _recorded - len(_ring)}


def reset() -> None:
    """Clear the ring and zero the counters :func:`counters` reads."""
    global _recorded
    from repro_torch.distributed import collectives
    from repro_torch.kernels import decode, flash_bwd, flash_fwd
    _ring.clear()
    _pending.clear()
    _recorded = 0
    flash_fwd.launches = flash_bwd.launches_bwd = 0
    decode.launches = decode.launches_partials = 0
    decode.launches_paged = decode.launches_paged_valid = 0
    collectives.stats.update(calls=0, bytes=0, seconds=0.0)


def enable(on: bool = True) -> None:
    """Turn recording on or off (``REPRO_TORCH_TRACE=0`` starts it off)."""
    global _on
    _on = bool(on)
