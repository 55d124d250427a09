"""Spawning the ranks of distributed serving (counterpart of
``repro.launch.mesh``): one process per pool shard, each joined to the
others as a :class:`~repro_torch.distributed.mesh.PoolMesh`.

The backend is the caller's choice, never switched silently:
``nccl`` when each rank has a card of its own (the default on ``cuda``),
``gloo`` on the CPU and for ranks that share one card (NCCL refuses two
ranks on one device; gloo's ``all_reduce`` and ``broadcast`` take CUDA
tensors through host memory). Rank ``r`` uses ``cuda:(r % device_count)``.

:func:`run_ranks` spawns the ranks (``torch.multiprocessing``, spawn
context) with a ``file://`` rendezvous in a fresh temporary directory, so
no TCP port is taken, and returns what each rank's function returned.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import make_mesh

BACKENDS = ("nccl", "gloo")


def default_backend(device_type: str) -> str:
    """``nccl`` on ``cuda``, ``gloo`` on ``cpu``."""
    return "nccl" if device_type == "cuda" else "gloo"


def check_backend(backend: str, device_type: str, size: int) -> None:
    """Raise if ``backend`` cannot join ``size`` ranks on ``device_type``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"ranks run on cuda or cpu, not {device_type}")
    if backend == "nccl" and device_type == "cpu":
        raise ValueError("nccl needs CUDA devices: use --dist-backend gloo "
                         "on the CPU")
    if backend == "nccl" and torch.cuda.device_count() < size:
        raise ValueError(
            f"nccl needs one card a rank: {size} ranks, "
            f"{torch.cuda.device_count()} card(s); ranks that share a card "
            f"need --dist-backend gloo")


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank ``r``'s device: ``cuda:(r % device_count)``, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _rank_main(rank: int, size: int, backend: str, device_type: str,
               init_method: str, fn: Callable, args: Sequence, results) -> None:
    """A spawned rank: join the group, run ``fn(mesh, device, *args)``,
    report ``(rank, ok, value or traceback)``, leave the group."""
    try:
        device = rank_device(rank, device_type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        mesh = make_mesh(size, rank, backend=backend, init_method=init_method)
        try:
            value = fn(mesh, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:   # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, size: int, args: Sequence = (), *,
              backend: Optional[str] = None, device_type: str = "cuda",
              timeout_s: float = 1800.0) -> List[Any]:
    """Spawn ``size`` ranks, each running ``fn(mesh, device, *args)``, and
    return their results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by import path), so ``fn`` is a
    module-level function. ``backend`` defaults to :func:`default_backend`
    and is checked by :func:`check_backend`. If a rank raises, the others
    are stopped and a ``RuntimeError`` carries the rank's traceback; so does
    a run past ``timeout_s``.
    """
    backend = backend or default_backend(device_type)
    check_backend(backend, device_type, size)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got: Dict[int, Any] = {}
    failures: List[str] = []
    with tempfile.TemporaryDirectory(prefix="pool_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, size, backend, device_type, init, fn,
                                   tuple(args), results), daemon=True)
                 for r in range(size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            # drain the queue before joining: a rank blocks on exit until
            # its result has left the pipe
            while len(got) < size and not failures:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        failures.append(f"rank {dead[0]} died with exit code "
                                        f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        failures.append(f"ranks still running after {timeout_s} s")
                    continue
                if ok:
                    got[rank] = value
                else:
                    failures.append(f"rank {rank} failed:\n{value}")
        finally:
            for p in procs:
                p.join(timeout=30 if not failures else 1)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
            results.close()
    if failures:
        raise RuntimeError("; ".join(failures))
    return [got[r] for r in range(size)]
