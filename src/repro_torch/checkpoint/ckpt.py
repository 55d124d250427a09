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


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} over every non-None leaf, in the tree's order."""
    kids = _children(tree)
    if kids is None:
        return {} if tree is None else {prefix: tree}
    flat = {}
    for k, v in kids.items():
        flat.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    return flat


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


def _snapshot(tree):
    flat, dtypes = {}, {}
    for k, leaf in _flatten(tree).items():
        flat[k], dtypes[k] = _to_host(leaf)
    return flat, dtypes


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Blocking atomic save. Returns the committed directory."""
    flat, dtypes = _snapshot(tree)
    return _write(ckpt_dir, step, flat, dtypes, keep)


def save_async(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> threading.Thread:
    """Host copy now; disk write on a background thread (join it)."""
    flat, dtypes = _snapshot(tree)
    t = threading.Thread(target=_write, args=(ckpt_dir, step, flat, dtypes, keep),
                         daemon=True)
    t.start()
    return t


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


def _from_host(a: np.ndarray, dtype_name: str, like):
    if isinstance(like, torch.Tensor):
        t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
             if dtype_name == "bfloat16" else torch.from_numpy(a))
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint shape {tuple(t.shape)} != "
                             f"{tuple(like.shape)}")
        return t
    return type(like)(a.item())


@torch.no_grad()
def _fill(like, arrays, dtypes, prefix: str = ""):
    kids = _children(like)
    if kids is None:
        if like is None:
            return None
        src = _from_host(arrays[prefix], dtypes.get(prefix, ""), like)
        if isinstance(like, torch.Tensor):
            like.copy_(src)                    # in place: no second tree
            return like
        return src
    out = {k: _fill(v, arrays, dtypes, f"{prefix}{_SEP}{k}" if prefix else str(k))
           for k, v in kids.items()}
    if dataclasses.is_dataclass(like):
        for k, v in out.items():
            setattr(like, k, v)
        return like
    return out


def restore(ckpt_dir: str, step: int, like):
    """Restore step ``step`` into the structure of ``like``. Tensor leaves of
    ``like`` are overwritten **in place** (dtype and device kept), so a
    restore at full width needs no second copy of the state; int leaves are
    replaced. Returns the filled tree."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "metadata.json")) as f:
        meta = json.load(f)
    want = meta.get("digest")
    if want is not None:
        got = _digest_file(os.path.join(d, "arrays.npz"))
        if got != want:
            raise CorruptCheckpointError(
                f"checkpoint {d} failed integrity check: arrays.npz digest "
                f"{got} != recorded {want} (truncated or corrupted write?)")
    with np.load(os.path.join(d, "arrays.npz")) as z:
        keys = list(_flatten(like))
        missing = set(keys) - set(z.files)
        if missing:
            raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}")
        arrays = {k: z[k] for k in keys}
    return _fill(like, arrays, meta.get("dtypes", {}))
