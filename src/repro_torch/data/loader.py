"""Prefetching device loader (counterpart of ``repro.data.loader``).

A background thread places each host batch on the device while the
current step runs: with a batch sharding (``make_train_step(mesh=)``'s
``shardings["batch"]``) only this rank's rows are cut out and copied; keys
without a sharding are copied whole. On a CUDA device the copy runs on a
side stream from pinned host memory, and each batch carries the event that
ends its copy: ``__next__`` makes the caller's current stream wait on it
before handing the batch over, so the step never reads a batch in flight.

JAX's ``Trainer`` does not use the loader, and neither does the port's.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.distributed.parallel import NamedSharding


class PrefetchLoader:
    """Iterate over ``host_iter``'s batches (dicts of arrays) placed on
    ``device`` (the card unless the caller asks for the CPU), up to
    ``prefetch`` ahead. An error of the worker is raised
    by the ``__next__`` that would have returned its batch; the end of
    ``host_iter`` raises ``StopIteration``."""

    def __init__(self, host_iter: Iterator[dict],
                 shardings: Optional[Dict[str, NamedSharding]] = None,
                 prefetch: int = 2, device="cuda"):
        self._it = host_iter
        self._shardings = shardings or {}
        self._device = torch.device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch: dict):
        """(placed batch, the event ending its copy or None)."""
        out = {}
        for k, v in batch.items():
            sh = self._shardings.get(k)
            part = np.ascontiguousarray(sh.shard(np.asarray(v)) if sh is not None
                                        else np.asarray(v))
            out[k] = torch.from_numpy(part)
        if self._stream is None:
            return {k: t.to(self._device) for k, t in out.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: t.pin_memory().to(self._device, non_blocking=True)
                   for k, t in out.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _worker(self):
        try:
            for batch in self._it:
                self._q.put(self._place(batch))
        except Exception as e:   # raised by the next __next__
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is None:
            self._q.put(None)            # every later call ends the same way
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, done = item
        if done is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(done)
            for t in batch.values():     # the caller's stream now uses them
                t.record_stream(current)
        return batch
