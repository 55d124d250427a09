"""The pool axis of distributed serving: one process per pool shard
(counterpart of the ``("model",)`` mesh that ``repro.distributed.paged``
takes from JAX).

JAX runs one controller over a device mesh with ``shard_map``; the port
runs one process per shard of the page pool, every rank running the same
program (SPMD), joined by a ``torch.distributed`` process group.
:class:`PoolMesh` is what the model and the serving engine see of it: the
group, this rank and the number of ranks. ``launch.mesh`` spawns the ranks
and checks their backend.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class PoolMesh:
    """One rank's view of the pool axis: the process group, this rank and
    the group's size (the number of pool shards)."""
    group: Any
    rank: int
    size: int

    def broadcast_object(self, obj, src: int = 0):
        """``obj`` as rank ``src`` holds it, on every rank (a host value:
        pickled through the backend's host path)."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group,
                                   device=self._object_device())
        return box[0]

    def _object_device(self):
        # NCCL moves objects through a card, gloo through host memory
        if dist.get_backend(self.group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")


def make_mesh(size: int, rank: int, *, backend: str, init_method: str,
              timeout_s: float = 600.0) -> PoolMesh:
    """Join the process group of ``size`` ranks as ``rank`` and return its
    :class:`PoolMesh`. ``init_method``: a rendezvous URL
    (``file:///path`` or ``tcp://host:port``)."""
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return PoolMesh(group=dist.group.WORLD, rank=rank, size=size)
