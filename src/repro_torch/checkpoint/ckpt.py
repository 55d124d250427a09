"""Atomic checkpoints with async save and resume-from-latest (counterpart of
``repro.checkpoint.ckpt``, with the same on-disk format).

* **Atomicity**: a save writes ``step_XXXXXXXX.tmp/`` and commits it with
  one directory rename, so a save cut short is never picked up by a resume.
* **Async**: ``save_async`` copies every tensor to host memory now and writes
  on a background thread, so the train step, which updates its tensors in
  place, may go on at once.
* **Self-describing**: ``metadata.json`` holds ``step``, ``keys``,
  ``shapes``, ``dtypes`` and the blake2b-16 ``digest`` of ``arrays.npz``;
  restore checks the digest first and raises
  :class:`CorruptCheckpointError` on a truncated or altered file.

A tree is a nested mapping (or dataclass) whose leaves are tensors or
Python ints; ``None`` leaves are absent. Keys join the path with
``/``. numpy has no bfloat16, so a bf16 tensor is stored as its uint16 bits
and recorded as ``"bfloat16"`` in ``dtypes``.

* **Mesh-agnostic**: on a training mesh (``shardings=``, a tree of
  ``distributed.parallel.NamedSharding`` by the state's keys) ``save``
  gathers the full tensors leaf by leaf (a collective every rank joins),
  only rank 0 keeps each on the host and writes, and the others wait at a
  barrier until the rename has committed it; ``restore`` reads the full
  arrays and keeps each rank's part. The files are those of one device, so
  a checkpoint of one mesh resumes on one device or on another mesh; a
  full shape that differs from the one a rank's part implies (another
  padded vocab) raises :class:`CheckpointShapeError`.

A checkpoint that the JAX package's ``Trainer`` wrote has the same files but
JAX's tree: stacked superblock params (``params/blocks/sub_0/mixer/wq``)
and the optimizer state as a NamedTuple, whose fields JAX's key paths spell
with a leading dot (``opt/.m/...``, ``opt/.step``). :func:`is_jax_layout`
tells the two apart and :func:`read_tree` returns such a checkpoint as a
nested dict of numpy arrays, which ``models.convert`` carries into the
port's state.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_SEP = "/"


class CorruptCheckpointError(RuntimeError):
    """A checkpoint's array payload does not match its recorded digest:
    a truncated write, bit rot or tampering. Restore an older step (the keep
    ring holds several) rather than deserialise garbage."""


class CheckpointShapeError(ValueError):
    """A checkpoint's array is not of the shape the state restoring it has
    (for ``embed`` and ``lm_head``: a vocab padded for another model
    axis)."""


def _digest_file(path: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _children(node):
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return {f.name: getattr(node, f.name) for f in dataclasses.fields(node)}
    if isinstance(node, Mapping):
        return node
    return None


def _flatten(tree, prefix: str = "", leaf=None) -> Dict[str, Any]:
    """{"a/b/c": leaf} over every non-None leaf, in the tree's order
    (``leaf``: a type to keep whole, though a dataclass)."""
    kids = None if leaf is not None and isinstance(tree, leaf) else _children(tree)
    if kids is None:
        return {} if tree is None else {prefix: tree}
    flat = {}
    for k, v in kids.items():
        flat.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k), leaf))
    return flat


def _flat_shardings(shardings) -> Dict[str, Any]:
    from repro_torch.distributed.parallel import NamedSharding
    return {} if shardings is None else _flatten(shardings, leaf=NamedSharding)


def _to_host(leaf):
    """(numpy array, dtype name) of one leaf, copied off the device."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest committed step in ``ckpt_dir`` (None if there is none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.isfile(os.path.join(ckpt_dir, d, "metadata.json"))]
    return max(steps) if steps else None


def _snapshot(tree, shardings=None):
    """(host arrays, dtype names, the mesh or None); on a mesh only rank 0
    keeps the arrays (each gathered, then copied off the device, one leaf at
    a time)."""
    flat, dtypes = {}, {}
    sh = _flat_shardings(shardings)
    mesh = next(iter(sh.values())).mesh if sh else None
    for k, leaf in _flatten(tree).items():
        if k in sh and isinstance(leaf, torch.Tensor):
            leaf = sh[k].gather(leaf)
        if mesh is None or mesh.rank == 0:
            flat[k], dtypes[k] = _to_host(leaf)
        del leaf
    return flat, dtypes, mesh


class _MeshSave:
    """A save on a mesh: rank 0's writer thread (None elsewhere); ``join``
    waits for it, then every rank meets at a barrier."""

    def __init__(self, thread: Optional[threading.Thread]):
        self.thread = thread

    def join(self):
        if self.thread is not None:
            self.thread.join()
        torch.distributed.barrier()


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         shardings=None) -> Optional[str]:
    """Blocking atomic save. Returns the committed directory (None on the
    ranks of a mesh other than 0, which return once it is committed)."""
    flat, dtypes, mesh = _snapshot(tree, shardings)
    if mesh is None:
        return _write(ckpt_dir, step, flat, dtypes, keep)
    final = _write(ckpt_dir, step, flat, dtypes, keep) if mesh.rank == 0 else None
    torch.distributed.barrier()
    return final


def save_async(ckpt_dir: str, step: int, tree, *, keep: int = 3,
               shardings=None):
    """Host copy now (on a mesh: gathered, every rank taking part); disk
    write on a background thread. Returns a handle to ``join()``: on a mesh
    every rank joins it, and it returns once the step is committed."""
    flat, dtypes, mesh = _snapshot(tree, shardings)
    t = None
    if mesh is None or mesh.rank == 0:
        t = threading.Thread(target=_write,
                             args=(ckpt_dir, step, flat, dtypes, keep), daemon=True)
        t.start()
    return t if mesh is None else _MeshSave(t)


def _write(ckpt_dir, step, flat, dtypes, keep):
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {"step": step, "keys": sorted(flat.keys()),
            "digest": _digest_file(os.path.join(tmp, "arrays.npz")),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": dtypes}
    with open(os.path.join(tmp, "metadata.json"), "w") as f:
        json.dump(meta, f)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir, keep):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def _from_host(a: np.ndarray, dtype_name: str, like, key: str, sharding=None):
    if isinstance(like, torch.Tensor):
        t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
             if dtype_name == "bfloat16" else torch.from_numpy(a))
        want = (tuple(like.shape) if sharding is None
                else sharding.global_shape(like.shape))
        if tuple(t.shape) != want:
            raise CheckpointShapeError(
                f"{key}: checkpoint shape {tuple(t.shape)} != {want}"
                + (" (the vocab is padded for another model axis)"
                   if key.split(_SEP)[-1] in ("embed", "lm_head") else ""))
        return t if sharding is None else sharding.shard(t)
    return type(like)(a.item())


@torch.no_grad()
def _fill(like, arrays, dtypes, sh, prefix: str = ""):
    kids = _children(like)
    if kids is None:
        if like is None:
            return None
        src = _from_host(arrays[prefix], dtypes.get(prefix, ""), like, prefix,
                         sh.get(prefix))
        if isinstance(like, torch.Tensor):
            like.copy_(src)                    # in place: no second tree
            return like
        return src
    out = {k: _fill(v, arrays, dtypes, sh,
                    f"{prefix}{_SEP}{k}" if prefix else str(k))
           for k, v in kids.items()}
    if dataclasses.is_dataclass(like):
        for k, v in out.items():
            setattr(like, k, v)
        return like
    return out


def _meta(ckpt_dir: str, step: int):
    """(directory, metadata) of step ``step``."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "metadata.json")) as f:
        return d, json.load(f)


def _checked(ckpt_dir: str, step: int):
    """(directory, metadata) of step ``step`` once its payload matches the
    recorded digest; raises :class:`CorruptCheckpointError` if not."""
    d, meta = _meta(ckpt_dir, step)
    want = meta.get("digest")
    if want is not None:
        got = _digest_file(os.path.join(d, "arrays.npz"))
        if got != want:
            raise CorruptCheckpointError(
                f"checkpoint {d} failed integrity check: arrays.npz digest "
                f"{got} != recorded {want} (truncated or corrupted write?)")
    return d, meta


def is_jax_layout(ckpt_dir: str, step: int) -> bool:
    """Whether step ``step`` was written by the JAX package's ``Trainer``
    (its optimizer state's keys start ``opt/.``)."""
    return any(k.startswith(f"opt{_SEP}.") for k in _meta(ckpt_dir, step)[1]["keys"])


def read_tree(ckpt_dir: str, step: int) -> Dict[str, Any]:
    """Step ``step`` as a nested dict of numpy arrays, its keys split at
    ``/``; a key part's leading dot (a JAX NamedTuple field) is dropped, and
    bf16 leaves become f32 (exact). Checks the digest first."""
    d, meta = _checked(ckpt_dir, step)
    dtypes = meta.get("dtypes", {})
    tree: Dict[str, Any] = {}
    with np.load(os.path.join(d, "arrays.npz")) as z:
        for key in z.files:
            a = z[key]
            if dtypes.get(key) == "bfloat16":
                a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).float().numpy()
            *path, leaf = [p[1:] if p.startswith(".") else p for p in key.split(_SEP)]
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a
    return tree


def restore(ckpt_dir: str, step: int, like, *, shardings=None):
    """Restore step ``step`` into the structure of ``like``. Tensor leaves of
    ``like`` are overwritten **in place** (dtype and device kept), so a
    restore at full width needs no second copy of the state; int leaves are
    replaced. ``shardings`` (a tree of ``NamedSharding`` by ``like``'s keys,
    None leaves replicated): ``like`` holds this rank's parts, and each is
    filled with its part of the full array. Returns the filled tree."""
    d, meta = _checked(ckpt_dir, step)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        keys = list(_flatten(like))
        missing = set(keys) - set(z.files)
        if missing:
            raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}")
        # npz members load as they are read: one full array at a time
        return _fill(like, z, meta.get("dtypes", {}), _flat_shardings(shardings))
