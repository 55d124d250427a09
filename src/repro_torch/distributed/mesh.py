"""The pool axis of distributed serving: one process per pool shard
(counterpart of the ``("model",)`` mesh that ``repro.distributed.paged``
takes from JAX).

JAX runs one controller over a device mesh with ``shard_map``; the port
runs one process per shard of the page pool, every rank running the same
program (SPMD), joined by a ``torch.distributed`` process group.
:class:`PoolMesh` is what the model and the serving engine see of it: the
group, this rank and the number of ranks. ``launch.mesh`` spawns the ranks
and checks their backend.

:class:`TrainMesh` is the named-axis mesh of training (counterpart of the
``("model",)``, ``("data", "model")`` and ``("pod", "data", "model")``
meshes of ``repro.launch.train --mesh``): one process a mesh position,
ranks laid out row-major over the axes (the last the fastest, as JAX lays
devices out), with a process group for every slice along every set of
axes, made in one order on every rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
from typing import Any, Dict, Tuple

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


#: the axes a training mesh may have, in their layout order
TRAIN_AXES = ("pod", "data", "model")


@dataclasses.dataclass
class TrainMesh:
    """One rank's view of a training mesh.

    ``shape``: axis → size, in ``TRAIN_AXES`` order; ``rank`` and its
    ``coords`` (axis → position). An *entry* names mesh axes as a spec
    does: None, an axis, or a tuple of axes in mesh order (split row-major,
    the first the slowest). :meth:`group`, :meth:`index` and :meth:`size`
    give the process group of this rank's slice along an entry, the rank's
    position in it and its size."""
    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    groups: Dict[Tuple[str, ...], Any]

    @property
    def world(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def axes(self, entry) -> Tuple[str, ...]:
        """An entry as a tuple of axis names (empty for None)."""
        if entry is None:
            return ()
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [a for a in self.shape if a in axes]
        if list(axes) != order:
            raise ValueError(f"mesh axes {axes} not in the mesh's order "
                             f"{tuple(self.shape)}")
        return axes

    def size(self, entry) -> int:
        n = 1
        for a in self.axes(entry):
            n *= self.shape[a]
        return n

    def index(self, entry) -> int:
        """This rank's position along ``entry`` (row-major)."""
        i = 0
        for a in self.axes(entry):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, entry):
        """The process group of the ranks that differ from this one only
        along ``entry`` (None where that is this rank alone)."""
        return self.groups.get(self.axes(entry))


def _coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    coords = {}
    for a in reversed(list(shape)):
        rank, coords[a] = divmod(rank, shape[a])
    return {a: coords[a] for a in shape}


def join_train_mesh(shape: Dict[str, int]) -> TrainMesh:
    """The :class:`TrainMesh` of ``shape`` over the initialised default
    process group (its world size must be the mesh's size): every rank
    calls this, and creates the same groups in the same order."""
    if not shape or set(shape) - set(TRAIN_AXES):
        raise ValueError(f"mesh axes must be among {TRAIN_AXES}, got "
                         f"{tuple(shape)}")
    shape = {a: int(shape[a]) for a in TRAIN_AXES if a in shape}
    world = dist.get_world_size()
    mesh = TrainMesh(shape=shape, rank=dist.get_rank(), coords={}, groups={})
    if mesh.world != world:
        raise ValueError(f"a mesh of {shape} needs {mesh.world} ranks, the "
                         f"process group has {world}")
    mesh.coords = _coords(shape, mesh.rank)
    names = list(shape)
    everyone = [_coords(shape, r) for r in range(world)]
    for k in range(1, len(names) + 1):
        for sub in itertools.combinations(names, k):
            if mesh.size(sub) == 1:
                continue
            if k == len(names):
                mesh.groups[sub] = dist.group.WORLD
                continue
            rest = [a for a in names if a not in sub]
            slices: Dict[tuple, list] = {}
            for r, c in enumerate(everyone):
                slices.setdefault(tuple(c[a] for a in rest), []).append(r)
            for key in sorted(slices):
                g = dist.new_group(slices[key])
                if key == tuple(mesh.coords[a] for a in rest):
                    mesh.groups[sub] = g
    return mesh


def make_train_mesh(shape: Dict[str, int], rank: int, *, backend: str,
                    init_method: str, timeout_s: float = 600.0) -> TrainMesh:
    """Join the process group of the mesh's ranks as ``rank`` (as
    :func:`make_mesh`) and return this rank's :class:`TrainMesh`."""
    size = 1
    for s in shape.values():
        size *= int(s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return join_train_mesh(shape)
