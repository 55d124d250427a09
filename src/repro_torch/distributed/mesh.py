"""The meshes of the port's ranks (counterpart of the JAX meshes of
``repro.launch.train --mesh`` and ``repro.launch.serve --mesh``).

JAX runs one controller over a device mesh with ``shard_map`` and GSPMD;
the port runs one process a mesh position, every rank running the same
program (SPMD), joined by a ``torch.distributed`` process group.
``launch.mesh`` spawns the ranks and checks their backend.

:class:`TrainMesh` is the named-axis mesh of training and serving (the
``("model",)``, ``("data", "model")`` and ``("pod", "data", "model")``
meshes of ``--mesh N | DxM | PxDxM``): ranks laid out row-major over the
axes (the last the fastest, as JAX lays devices out), with a process group
for every slice along every set of axes, made in one order on every rank.

:class:`PoolMesh` is its ``model``-axis view (:attr:`TrainMesh.pool`): the
axis a page pool is sharded over, as JAX's ``POOL_AXIS = "model"``
(``distributed/paged.py``); its group, this rank's position on it and its
size. :func:`as_train_mesh` takes either and gives the :class:`TrainMesh`
(a bare :class:`PoolMesh` is the one-axis mesh ``("model",)``).

:func:`dry_train_mesh` is one rank's :class:`TrainMesh` with no process
group behind it (``launch/dryrun.py``): every slice a
``collectives.DryGroup``, on which the collectives move nothing.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist


def _broadcast_object(obj, group, src: int = 0):
    """``obj`` as global rank ``src`` holds it, on every rank of ``group``
    (a host value: pickled through the backend's host path; NCCL moves it
    through a card, gloo through host memory)."""
    box = [obj]
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    dist.broadcast_object_list(box, src=src, group=group, device=device)
    return box[0]


@dataclasses.dataclass(frozen=True)
class PoolMesh:
    """The ``model`` axis of a mesh as a page pool sees it: the axis's
    process group, this rank's position on it and its size (the number of
    pool shards)."""
    group: Any
    rank: int
    size: int

    def broadcast_object(self, obj, src: int = 0):
        """``obj`` as rank ``src`` of the axis holds it, on every rank of
        the axis."""
        return _broadcast_object(obj, self.group, src)


def make_mesh(size: int, rank: int, *, backend: str, init_method: str,
              timeout_s: float = 600.0) -> PoolMesh:
    """Join the process group of ``size`` ranks as ``rank`` and return its
    :class:`PoolMesh`, the whole world on one axis. ``init_method``: a
    rendezvous URL (``file:///path`` or ``tcp://host:port``)."""
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

    @property
    def pool(self) -> PoolMesh:
        """The ``model`` axis as a :class:`PoolMesh` (a page pool's shards)."""
        if "model" not in self.shape:
            return PoolMesh(group=None, rank=0, size=1)
        return PoolMesh(group=self.group("model"), rank=self.index("model"),
                        size=self.size("model"))

    @property
    def pool_shards(self):
        """The page pool's shards: :attr:`pool`, but None where the
        ``model`` axis is one rank with no process group of its own (the
        pool whole on every rank; a one-rank mesh over a group of its own,
        as ``launch.mesh`` makes one, still runs the sharded path)."""
        pool = self.pool
        return pool if pool.size > 1 or pool.group is not None else None

    def broadcast_object(self, obj):
        """``obj`` as global rank 0 holds it, on every rank of the mesh."""
        if self.world == 1:
            return obj
        return _broadcast_object(obj, self.group(tuple(self.shape)))


def as_train_mesh(mesh) -> TrainMesh:
    """``mesh`` as a :class:`TrainMesh`: itself, or a :class:`PoolMesh` as
    the one-axis mesh ``("model",)`` over its group."""
    if isinstance(mesh, TrainMesh):
        return mesh
    groups = ({("model",): mesh.group}
              if mesh.size > 1 or mesh.group is not None else {})
    return TrainMesh(shape={"model": mesh.size}, rank=mesh.rank,
                     coords={"model": mesh.rank}, groups=groups)


def _coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    coords = {}
    for a in reversed(list(shape)):
        rank, coords[a] = divmod(rank, shape[a])
    return {a: coords[a] for a in shape}


def _slices(shape: Dict[str, int]):
    """Every set of axes with more than one rank (k axes at a time, in
    mesh order): ``(axes, {coords of the other axes: ranks})``."""
    names = list(shape)
    world = 1
    for s in shape.values():
        world *= s
    everyone = [_coords(shape, r) for r in range(world)]
    for k in range(1, len(names) + 1):
        for sub in itertools.combinations(names, k):
            rest = [a for a in names if a not in sub]
            slices: Dict[tuple, list] = {}
            for r, c in enumerate(everyone):
                slices.setdefault(tuple(c[a] for a in rest), []).append(r)
            if len(next(iter(slices.values()))) > 1:
                yield sub, rest, slices


def dry_train_mesh(shape: Dict[str, int], rank: int = 0) -> TrainMesh:
    """Rank ``rank``'s :class:`TrainMesh` of ``shape`` with a
    ``collectives.DryGroup`` for every slice of more than one rank, and no
    process group (module docstring)."""
    from repro_torch.distributed.collectives import DryGroup
    shape = {a: int(shape[a]) for a in TRAIN_AXES if a in shape}
    mesh = TrainMesh(shape=shape, rank=rank, coords=_coords(shape, rank),
                     groups={})
    for sub, _, _ in _slices(shape):
        mesh.groups[sub] = DryGroup(mesh.size(sub))
    return mesh


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
    for sub, rest, slices in _slices(shape):
        if not rest:
            mesh.groups[sub] = dist.group.WORLD
            continue
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
