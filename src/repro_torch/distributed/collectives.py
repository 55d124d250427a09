"""Collectives over the axes of a training mesh, with and without autograd
(what GSPMD inserts in the JAX package around sharded tensors).

An *entry* names mesh axes as a spec does (``TrainMesh.axes``). Over an
entry of size 1 every function here is the identity.

* :func:`copy_to` — identity forward, all-reduce (sum) backward: where a
  replicated activation (or weight) enters work split over an axis
  (Megatron's *f*).
* :func:`reduce_from` — all-reduce (sum) forward, identity backward: where
  the partial results of split work leave it (Megatron's *g*).
* :func:`gather` — all-gather along a dim, reduce-scatter backward: a
  weight sharded over the data axis (FSDP) is gathered before use, and its
  gradient summed and scattered back.
* :func:`reduce_scatter` — sum over an entry and keep this rank's part
  along a dim, all-gather backward: the partial sums of a row-parallel
  product whose consumer is split along its output dim (the RG-LRU's
  gates, ``models/rglru.py``).

A dim may be a row of ``block``-long blocks, each split over the entry on
its own (the gated MLP's ``[gate | up]`` columns, a batch's microbatches):
a rank's part is its slice of every block, in block order.

The gather and the reduce-scatter are ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` on every backend: gloo takes both on CUDA
tensors as NCCL does (torch 2.11 on the H100 machine, probed by
``chip_smoke.py`` phase 5g, which checks their values), and on the CPU.
A group's ranks are in ascending order, which is the row-major order of an
entry's axes (``TrainMesh.index``).

:data:`stats` counts the collectives of this process: calls, the bytes of
their input tensors, and the host seconds spent in them (with gloo the
call returns when the data has moved; with NCCL when it is enqueued).
:data:`log`, when it is a list, gets one entry a call: its kind
(``all-reduce``, ``all-gather``, ``reduce-scatter``), the bytes of its
result as JAX's HLO shapes count them (the all-reduce's tensor, the
all-gather's whole gathered tensor, the reduce-scatter's shard) and the
size of its group, what ``perf/collective_analysis.collective_stats``
costs. Every collective of the port's steps goes through
:func:`all_reduce_`, :func:`gather_nograd` or
:func:`reduce_scatter_nograd`, so the log holds all of a step's.

A :class:`DryGroup` (``distributed.mesh.dry_train_mesh``, the dry run of
``launch/dryrun.py``) stands for a process group that is not there: a
collective on it moves nothing and leaves its output as it was made
(of the right shape and dtype; on the ``meta`` device there are no
values), and is still counted and logged.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

#: calls, input bytes and host seconds of this process's collectives
stats = {"calls": 0, "bytes": 0, "seconds": 0.0}

#: None, or a list to which every collective appends ``{"kind", "bytes",
#: "group"}`` (module docstring)
log = None


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """A process group of ``size`` ranks that is not there (module
    docstring)."""
    size: int


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _run(kind: str, fn, x: torch.Tensor, result: torch.Tensor, n: int,
         *args, **kw) -> None:
    """``fn(*args, **kw)``, a collective of ``kind`` over ``n`` ranks on
    input ``x`` giving ``result``: counted, logged, skipped on a dry
    group."""
    if log is not None:
        log.append({"kind": kind, "bytes": _nbytes(result), "group": n})
    t0 = time.perf_counter()
    if not isinstance(kw["group"], DryGroup):
        fn(*args, **kw)
    stats["seconds"] += time.perf_counter() - t0
    stats["calls"] += 1
    stats["bytes"] += _nbytes(x)


def all_reduce_(x: torch.Tensor, mesh, entry, op: str = "sum") -> torch.Tensor:
    """All-reduce ``x`` in place over ``entry`` (no autograd); returns it."""
    group = mesh.group(entry)
    if group is not None:
        _run("all-reduce", dist.all_reduce, x, x, mesh.size(entry), x,
             op=_OPS[op], group=group)
    return x


def _split(shape, dim: int, n: int, block):
    """A full shape with ``dim`` as [blocks, n, chunk]."""
    full = shape[dim]
    block = full if block is None else block
    if full % block or block % n:
        raise ValueError(f"dim {dim} of {full} in blocks of {block} does not "
                         f"split over {n} ranks")
    return (*shape[:dim], full // block, n, block // n, *shape[dim + 1:])


def shard(x, dim: int, mesh, entry, block=None):
    """This rank's part of the full ``x`` along ``dim`` (numpy or torch; a
    view where the layout allows): its slice of every ``block``-long block."""
    n = mesh.size(entry)
    if n == 1:
        return x
    i = mesh.index(entry)
    v = x.reshape(_split(tuple(x.shape), dim, n, block))
    part = v[(slice(None),) * (dim + 1) + (i,)]
    shape = list(x.shape)
    shape[dim] //= n
    return part.reshape(shape)


@torch.no_grad()
def gather_nograd(x: torch.Tensor, dim: int, mesh, entry,
                  block=None) -> torch.Tensor:
    """The full tensor of which ``x`` is this rank's part along ``dim``."""
    n = mesh.size(entry)
    if n == 1:
        return x
    x = x.detach()
    local = list(x.shape)
    full_shape = local.copy()
    full_shape[dim] *= n
    split = _split(tuple(full_shape), dim, n, block)
    part = x.reshape(split[:dim + 1] + split[dim + 2:]).contiguous()
    buf = x.new_empty(n * part.numel())
    _run("all-gather", dist.all_gather_into_tensor, part, buf, n, buf,
         part.reshape(-1), group=mesh.group(entry))
    return buf.view(n, *part.shape).movedim(0, dim + 1).reshape(full_shape)


@torch.no_grad()
def reduce_scatter_nograd(y: torch.Tensor, dim: int, mesh, entry,
                          block=None) -> torch.Tensor:
    """This rank's part along ``dim`` of the sum over ``entry`` of ``y``."""
    n = mesh.size(entry)
    if n == 1:
        return y
    y = y.detach()
    split = _split(tuple(y.shape), dim, n, block)
    parts = y.reshape(split).movedim(dim + 1, 0).contiguous()
    out = y.new_empty(parts[0].numel())
    _run("reduce-scatter", dist.reduce_scatter_tensor, parts, out, n, out,
         parts.reshape(-1), group=mesh.group(entry))
    local = list(y.shape)
    local[dim] //= n
    return out.reshape(local)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, entry):
        ctx.mesh, ctx.entry = mesh, entry
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh, ctx.entry), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, entry):
        return all_reduce_(x.contiguous().clone(), mesh, entry)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, entry, block):
        ctx.args = (dim, mesh, entry, block)
        return gather_nograd(x, dim, mesh, entry, block)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_nograd(g, *ctx.args), None, None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, entry):
        ctx.args = (dim, mesh, entry)
        return reduce_scatter_nograd(x, dim, mesh, entry)

    @staticmethod
    def backward(ctx, g):
        return (gather_nograd(g.contiguous(), *ctx.args), None, None, None)


def copy_to(x: torch.Tensor, mesh, entry) -> torch.Tensor:
    """Identity forward; the gradient is all-reduced over ``entry``."""
    return x if mesh.size(entry) == 1 else _CopyTo.apply(x, mesh, entry)


def reduce_from(x: torch.Tensor, mesh, entry) -> torch.Tensor:
    """All-reduce (sum) over ``entry``; the gradient passes as it is."""
    return x if mesh.size(entry) == 1 else _ReduceFrom.apply(x, mesh, entry)


def gather(x: torch.Tensor, dim: int, mesh, entry, block=None) -> torch.Tensor:
    """All-gather along ``dim`` over ``entry``; the gradient is summed over
    ``entry`` and this rank's part kept (reduce-scatter)."""
    if mesh.size(entry) == 1:
        return x
    return _Gather.apply(x, dim, mesh, entry, block)


def reduce_scatter(x: torch.Tensor, dim: int, mesh, entry) -> torch.Tensor:
    """Sum over ``entry`` and keep this rank's part along ``dim``; the
    gradient is all-gathered along ``dim``."""
    if mesh.size(entry) == 1:
        return x
    return _ReduceScatter.apply(x, dim, mesh, entry)
