"""Train, prefill and decode steps on one device (counterpart of
``repro.runtime.steps`` without a mesh or a paged cache).

PyTorch runs eagerly: there is no jit. The train step updates the params and
the optimizer state in place; the serving steps run under
``torch.inference_mode`` and update the caches in place, where the JAX steps
donate them and return new ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.kernels.rng import int32
from repro_torch.models.layers import Ctx
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule


@dataclasses.dataclass
class TrainArtifacts:
    """The train step and its state's initialiser.

    step_fn(params, opt_state, batch, step: int) → (params, opt_state,
        metrics {"ce", "loss", "grad_norm", "lr"}); params and opt_state are
        updated in place and returned.
    init_fn(seed=0) → (params :class:`~repro_torch.models.lm.LM`,
        opt_state :class:`~repro_torch.optim.AdamWState`) on ``device``.
    """
    step_fn: Any
    init_fn: Any
    device: Any


def step_seed(step: int) -> int:
    """The per-step dropout seed, ``uint32(step) · 2654435761`` read as an
    int32, as the JAX step computes it."""
    return int32((int(step) % 2**32) * 2654435761 % 2**32)


def place_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays from ``data.make_batch``) as tensors on
    ``device``: ids stay int32 (the kernels take int32 segment ids), floats
    stay f32."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def make_train_step(cfg, *, opt: AdamWConfig = AdamWConfig(),
                    impl: str = "kernel", total_steps: int = 10000,
                    warmup_steps: int = 100, microbatch: Optional[int] = None,
                    torch_chunk: int = 1024, device="cuda") -> TrainArtifacts:
    """The single-device training step of ``cfg`` with attention ``impl``.

    microbatch: split the batch into rows of this size and accumulate:
    grads and loss are the means over microbatches, the other metrics those
    of the last one (as JAX's scan). ``lr`` follows ``cosine_schedule`` and
    is reported in the metrics but not applied: the update uses ``opt.lr``,
    exactly as the JAX step does (it calls ``adamw_update`` without the
    scheduled rate).
    """
    def init_fn(seed: int = 0):
        params = lm.init_params(cfg, seed=seed, device=device)
        return params, adamw_init(params, opt)

    def loss_and_grads(params, batch, seed):
        ctx = Ctx(impl=impl, deterministic=(cfg.dropout_rate == 0.0),
                  seed=seed, torch_chunk=torch_chunk)
        loss, metrics = lm.loss_fn(cfg, params, batch, ctx)
        loss.backward()
        grads = {}
        for n, p in params.named_parameters():
            grads[n], p.grad = p.grad, None
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def step_fn(params, opt_state, batch, step: int):
        seed = step_seed(step)
        if microbatch is None:
            loss, metrics, grads = loss_and_grads(params, batch, seed)
        else:
            n_micro = batch["labels"].shape[0] // microbatch
            grads, loss = {}, torch.zeros((), dtype=torch.float32, device=device)
            for i in range(n_micro):
                mb = {k: v[i * microbatch:(i + 1) * microbatch]
                      for k, v in batch.items()}
                l, metrics, g = loss_and_grads(params, mb, seed)
                loss = loss + l
                for n, gi in g.items():          # summed in f32, as JAX's scan
                    gi = gi.float()
                    grads[n] = gi if n not in grads else grads[n].add_(gi)
            for g in grads.values():
                g.div_(n_micro)
            loss = loss / n_micro
        lr = cosine_schedule(step, warmup_steps, total_steps, opt.lr)
        params, opt_state, om = adamw_update(grads, opt_state, params, opt)
        metrics = dict(metrics, **om, lr=lr, loss=loss)
        return params, opt_state, metrics

    return TrainArtifacts(step_fn=step_fn, init_fn=init_fn, device=device)


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
