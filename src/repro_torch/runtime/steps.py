"""Prefill / decode steps for the contiguous cache on one device
(counterpart of ``repro.runtime.steps.make_serve_steps`` without a mesh or a
paged cache). PyTorch runs eagerly: there is no jit; the steps run under
``torch.inference_mode`` and update the caches in place, where the JAX steps
donate them and return new ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import lm
from repro_torch.models.layers import Ctx


@dataclasses.dataclass
class ServeArtifacts:
    """The three serving callables.

    prefill_fn(params, tokens [B,S], caches) → (logits [B,Vpad], caches)
    decode_fn(params, token [B], caches, position: int)
        → (logits [B,Vpad], caches)
    cache_init_fn() → fresh per-layer caches
    """
    prefill_fn: Any
    decode_fn: Any
    cache_init_fn: Any


def make_serve_steps(cfg, *, impl: str = "kernel", max_len: int = 2048,
                     batch: int = 1, torch_chunk: int = 1024,
                     num_splits: int = 1, device="cuda") -> ServeArtifacts:
    """Serving steps of ``cfg`` with attention ``impl`` on ``device``.

    num_splits: split-KV slices per (batch, kv head) row of the decode step.
    torch_chunk: KV chunk of ``impl="torch"``'s prefill.
    """
    def cache_init():
        with torch.inference_mode():
            return lm.init_cache(cfg, batch, max_len, device=device)

    @torch.inference_mode()
    def prefill_fn(params, tokens, caches):
        ctx = Ctx(impl=impl, torch_chunk=torch_chunk)
        return lm.prefill(cfg, params, ctx, tokens, caches)

    @torch.inference_mode()
    def decode_fn(params, token, caches, position):
        ctx = Ctx(impl=impl, torch_chunk=torch_chunk, num_splits=num_splits)
        return lm.decode_step(cfg, params, ctx, token, caches, position)

    return ServeArtifacts(prefill_fn=prefill_fn, decode_fn=decode_fn,
                          cache_init_fn=cache_init)
