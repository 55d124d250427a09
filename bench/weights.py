"""The initial weights of a run, drawn from ``--seed`` on the device.

The benchmark makes the weights and hands the same ones to the program and
to the reference. Each block of leaves (a layer's, then the rest, as the
configuration's reference module lists them in ``leaves``) comes from one
``torch.randn`` call over the block's elements, with a generator seeded
from (seed, block), in f32; each matrix is then scaled and each norm weight
set to ones. A block can be drawn again alone, so the change of the weights
after some steps is measured a block at a time.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List

import torch


def _block_seed(seed: int, block: int) -> int:
    return (int(seed) * 1_000_003 + block * 7919 + 12345) % (2 ** 63)


def blocks(leaves) -> List[List[tuple]]:
    """The leaves grouped by block, in block order."""
    out: Dict[int, list] = {}
    for leaf in leaves:
        out.setdefault(leaf[3], []).append(leaf)
    return [out[b] for b in sorted(out)]


def draw_block(block: List[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} of one block, each a view into the block's draw."""
    n = sum(math.prod(shape) for _, shape, _, _ in block)
    gen = torch.Generator(device=device).manual_seed(_block_seed(seed, block[0][3]))
    flat = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
    out, at = {}, 0
    for name, shape, scale, _ in block:
        t = flat[at:at + math.prod(shape)].view(shape)
        at += math.prod(shape)
        if scale is None:
            t.fill_(1.0)
        else:
            t.mul_(scale)
        out[name] = t
    return out


def draw(leaves, seed: int, device) -> Iterator[Dict[str, torch.Tensor]]:
    """Each block's {name: tensor} in turn (one block alive at a time if
    the caller drops it)."""
    for block in blocks(leaves):
        yield draw_block(block, seed, device)


def load(set_leaf: Callable[[str, torch.Tensor], None], leaves, seed: int,
         device) -> None:
    """``set_leaf(name, tensor)`` for every leaf, a block at a time."""
    with torch.no_grad():
        for part in draw(leaves, seed, device):
            for name, t in part.items():
                set_leaf(name, t)


def own(leaves, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf as a tensor of its own (the reference's weights)."""
    out = {}
    load(lambda n, t: out.__setitem__(n, t.clone()), leaves, seed, device)
    return out


def change_norms(current: Callable[[str], torch.Tensor], leaves, seed: int,
                 device) -> Dict[str, float]:
    """{name: ||current(name) - initial||} for every leaf, the initial
    weights drawn again a block at a time."""
    out = {}
    with torch.no_grad():
        for part in draw(leaves, seed, device):
            for name, t in part.items():
                out[name] = float(torch.linalg.vector_norm(current(name) - t))
    return out
