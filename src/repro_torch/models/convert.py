"""Carry the JAX package's model parameters and AdamW state over to the port.

The JAX params are a pytree of arrays (pass them as numpy arrays, e.g.
``jax.tree.map(np.asarray, params)``): ``embed``, ``final_norm``,
``lm_head`` and stacked superblocks ``blocks["sub_j"][leaf][n_super, ...]``
(plus ``tail["tail_r"]`` for layers past the last full period). Layer
``i = s·period + j`` is row ``s`` of ``sub_j``. Every leaf is already
``[d_in, d_out]``, the port's orientation, so conversion is an unstack: no
transposes. Hybrid archs (recurrentgemma: rec, rec, attn superblocks and a
rec, rec tail) unstack the same way, each layer's leaves named as its
block's parameters, and so do MoE archs' expert leaves (``mlp.router``
[d, E], ``mlp.wi`` [E, d, 2f], ``mlp.wo`` [E, f, d], ``mlp.shared.*``), and
the ssm family's mixer-only layers (``norm1`` and ``mixer.*``, no ``norm2``
or ``mlp``), and the frontend families' ``frontend_proj`` [1024, d] and
ungated ``mlp.wi`` [d, f]; each leaf lands in its parameter's dtype, so the
router (and the RG-LRU's lambda, Mamba's ``dt_bias``, ``A_log`` and ``D``)
stays f32 in a bf16 model. Vocab padding is kept as it is. The AdamW moments and master
copy mirror the params tree and convert the same way. This module imports
neither JAX nor ``repro``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.models.lm import LM, set_param
from repro_torch.optim.adamw import AdamWState


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


def _named_arrays(cfg, tree: Mapping[str, Any], model: LM) -> Dict[str, Any]:
    """A JAX params-shaped tree as ``{port parameter name: array}``, in the
    order of ``model.named_parameters()``. Raises if a leaf is missing or
    left over."""
    top = [n for n, _ in model.named_parameters() if not n.startswith("blocks.")]
    extra = set(tree) - {"blocks", "tail"} - set(top)
    if extra or not set(top) <= set(tree):
        raise ValueError(f"top-level leaves {sorted(set(tree) - {'blocks', 'tail'})} "
                         f"for the port's {top}")
    out = {name: tree[name] for name in top}
    for i, blk in enumerate(model.blocks):
        layer = _layer_tree(cfg, tree, i)
        named = [n for n, _ in blk.named_parameters()]
        if len(named) != _leaf_count(layer):
            raise ValueError(f"layer {i}: {_leaf_count(layer)} JAX leaves for "
                             f"{len(named)} port parameters")
        for name in named:
            leaf = layer
            for key in name.split("."):
                leaf = leaf[key]
            out[f"blocks.{i}.{name}"] = leaf
    return {n: out[n] for n, _ in model.named_parameters()}


@torch.no_grad()
def convert_params(cfg, params: Mapping[str, Any], *, device="cuda",
                   dtype=None, keep=None) -> LM:
    """JAX params (pytree of numpy arrays) → the port's :class:`LM` on
    ``device`` in ``dtype`` (default ``cfg.dtype``). Raises if a leaf is
    missing, left over or of another shape. ``keep(name, full) → tensor``:
    the model is built on "meta" and each parameter becomes what ``keep``
    returns for its full leaf, converted on the host, before the next is
    converted (a mesh rank keeps its shard)."""
    dtype = dtype or cfg.dtype
    vpad = np.asarray(params["embed"]).shape[0]
    model = LM(cfg, vpad, device=device if keep is None else "meta",
               dtype=dtype)
    named = dict(model.named_parameters())
    for name, arr in _named_arrays(cfg, params, model).items():
        # each leaf in its parameter's dtype: the RG-LRU's lambda stays f32
        w = named[name]
        if keep is None:
            w.copy_(_checked(arr, name, w, device))
        else:
            set_param(model, name, keep(name, _checked(arr, name, w, "cpu")))
    return model


@torch.no_grad()
def convert_opt_state(cfg, opt_state, model: LM, *, device="cuda",
                      keep=None) -> AdamWState:
    """JAX ``AdamWState`` (``step``, and ``m``/``v``/``master`` trees of numpy
    arrays, ``master`` possibly None) → the port's :class:`AdamWState` for
    ``model`` (whose parameters give the names and full shapes; it may be
    on "meta"), every tensor f32 on ``device``; ``keep`` as
    :func:`convert_params`' (each leaf converted on the host)."""
    def tree(t):
        if t is None:
            return None
        named = dict(model.named_parameters())
        put, where = (keep, "cpu") if keep else ((lambda n, x: x), device)
        return {name: put(name, _checked(arr, name, named[name], where,
                                         torch.float32))
                for name, arr in _named_arrays(cfg, t, model).items()}

    step, m, v, master = opt_state
    return AdamWState(step=int(np.asarray(step)), m=tree(m), v=tree(v),
                      master=tree(master))


def _checked(arr, what: str, w: torch.Tensor, device,
             dtype=None) -> torch.Tensor:
    """``arr`` as a tensor in ``dtype`` (default ``w``'s) on ``device``;
    raises unless it has ``w``'s shape."""
    t = _tensor(arr, dtype or w.dtype, device)
    if t.shape != w.shape:
        raise ValueError(f"{what}: JAX shape {tuple(t.shape)} != port shape "
                         f"{tuple(w.shape)}")
    return t
