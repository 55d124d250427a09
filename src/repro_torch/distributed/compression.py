"""int8 error-feedback gradient all-reduce (counterpart of
``repro.distributed.compression``).

Each gradient tensor is quantised to int8 with one scale for the tensor
before the data-parallel sum, and the quantisation residual is kept in an
error-feedback buffer that joins the next step's gradient (EF-SGD). The
scale is all-reduced with MAX first, so every rank quantises with the same
one; the int8 values are summed as int32 (an int8 sum would overflow) and
the result divided by the group's size: the mean gradient.

The JAX package wires it into no step, and neither does the port. On the
wire the values are int32 here, 4 bytes an element as f32's are. Both
collectives go through ``collectives.all_reduce_``, counted and logged
with the port's others.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh import PoolMesh, as_train_mesh


def quantize_psum(g: torch.Tensor, group, error: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tensor over the ranks of ``group`` (a process group; None: the
    default one): ``(g + error)`` quantised, summed, dequantised →
    (mean gradient f32, new error f32)."""
    n = dist.get_world_size(group)
    axis = as_train_mesh(PoolMesh(group=group or dist.group.WORLD,
                                  rank=dist.get_rank(group), size=n))
    gf = g.float() + error
    scale = gf.abs().max() / 127.0 + 1e-12
    C.all_reduce_(scale, axis, "model", "max")
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_error = gf - q.float() * scale
    total = q.to(torch.int32)
    C.all_reduce_(total, axis, "model")
    return total.float() * scale / n, new_error


def psum_tree_int8(grads: Dict[str, torch.Tensor],
                   errors: Dict[str, torch.Tensor], group
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """:func:`quantize_psum` over every leaf of ``grads`` (by name).
    Returns (mean gradients, new errors)."""
    out_g, out_e = {}, {}
    for name, g in grads.items():
        out_g[name], out_e[name] = quantize_psum(g, group, errors[name])
    return out_g, out_e


def init_error_buffers(grads_like: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Zero f32 error buffers shaped like ``grads_like``."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads_like.items()}
