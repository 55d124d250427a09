"""Carry the JAX package's model parameters over to the port.

The JAX params are a pytree of arrays (pass them as numpy arrays, e.g.
``jax.tree.map(np.asarray, params)``): ``embed``, ``final_norm``,
``lm_head`` and stacked superblocks ``blocks["sub_j"][leaf][n_super, ...]``
(plus ``tail["tail_r"]`` for layers past the last full period). Layer
``i = s·period + j`` is row ``s`` of ``sub_j``. Every leaf is already
``[d_in, d_out]``, the port's orientation, so conversion is an unstack: no
transposes. Vocab padding is kept as it is. This module imports neither JAX
nor ``repro``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.models.lm import LM


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: no torch.from_numpy
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _layer_tree(cfg, params: Mapping[str, Any], i: int):
    """Layer ``i``'s leaves as a nested dict of arrays."""
    period = len(cfg.block_pattern)
    n_super = cfg.num_layers // period
    if i < n_super * period:
        s, j = divmod(i, period)
        return _map(lambda a: np.asarray(a)[s], params["blocks"][f"sub_{j}"])
    return params["tail"][f"tail_{i - n_super * period}"]


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaf_count(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_leaf_count(v) for v in tree.values())
    return 1


def convert_params(cfg, params: Mapping[str, Any], *, device="cuda",
                   dtype=None) -> LM:
    """JAX params (pytree of numpy arrays) → the port's :class:`LM` on
    ``device`` in ``dtype`` (default ``cfg.dtype``). Raises if a leaf is
    missing, left over or of another shape."""
    dtype = dtype or cfg.dtype
    vpad = np.asarray(params["embed"]).shape[0]
    model = LM(cfg, vpad, device=device, dtype=dtype)
    top = {"embed": params["embed"], "final_norm": params["final_norm"],
           "lm_head": params["lm_head"]}
    for name, arr in top.items():
        _copy(getattr(model, name), arr, name, dtype, device)
    for i, blk in enumerate(model.blocks):
        tree = _layer_tree(cfg, params, i)
        named = dict(blk.named_parameters())
        if len(named) != _leaf_count(tree):
            raise ValueError(f"layer {i}: {_leaf_count(tree)} JAX leaves for "
                             f"{len(named)} port parameters")
        for name, w in named.items():
            leaf = tree
            for key in name.split("."):
                leaf = leaf[key]
            _copy(w, leaf, f"layer {i} {name}", dtype, device)
    return model


def _copy(w: torch.Tensor, arr, what: str, dtype, device) -> None:
    t = _tensor(arr, dtype, device)
    if t.shape != w.shape:
        raise ValueError(f"{what}: JAX shape {tuple(t.shape)} != port shape "
                         f"{tuple(w.shape)}")
    w.copy_(t)
