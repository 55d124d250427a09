"""Train, prefill and decode steps (counterpart of ``repro.runtime.steps``):
on one device, and the paged serving steps also over a pool mesh.

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
from repro_torch.models.convert import convert_opt_state, convert_params
from repro_torch.models.layers import Ctx
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule


@dataclasses.dataclass
class TrainArtifacts:
    """The train step and its state's initialiser.

    step_fn(params, opt_state, batch, step: int) → (params, opt_state,
        metrics {"ce", "loss", "grad_norm", "lr"}, and "moe_aux",
        "moe_dropped" for MoE archs); params and opt_state are updated in
        place and returned.
    init_fn(seed=0) → (params :class:`~repro_torch.models.lm.LM`,
        opt_state :class:`~repro_torch.optim.AdamWState`) on ``device``.
    from_jax(tree) → (params, opt_state) of a JAX ``Trainer`` checkpoint
        (``checkpoint.read_tree``: ``{"params", "opt"}`` in JAX's layout),
        through ``models.convert``; its master copy is dropped where the
        optimizer keeps none.
    """
    step_fn: Any
    init_fn: Any
    device: Any
    from_jax: Any


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
    of the last one (as JAX's scan), MoE metrics included. ``lr`` follows
    ``cosine_schedule`` and is reported in the metrics but not applied: the
    update uses ``opt.lr``, exactly as the JAX step does (it calls
    ``adamw_update`` without the scheduled rate).
    """
    def init_fn(seed: int = 0):
        params = lm.init_params(cfg, seed=seed, device=device)
        return params, adamw_init(params, opt)

    def from_jax(tree):
        o = tree["opt"]
        if opt.keep_master and "master" not in o:
            raise ValueError("the JAX checkpoint has no f32 master copy for "
                             "an optimizer with keep_master=True")
        params = convert_params(cfg, tree["params"], device=device)
        master = o["master"] if opt.keep_master else None
        return params, convert_opt_state(
            cfg, (o["step"], o["m"], o["v"], master), params, device=device)

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

    return TrainArtifacts(step_fn=step_fn, init_fn=init_fn, device=device,
                          from_jax=from_jax)


@dataclasses.dataclass
class ServeArtifacts:
    """The serving callables (see :func:`make_serve_steps` for the paged
    signatures).

    prefill_fn(params, tokens [B,S], caches) → (logits [B,Vpad], caches)
    decode_fn(params, token [B], caches, position: int)
        → (logits [B,Vpad], caches)
    cache_init_fn() → fresh per-layer caches
    chunk_prefill_fn, verify_fn: paged only (chunked/suffix prefill,
        speculative verify)
    """
    prefill_fn: Any
    decode_fn: Any
    cache_init_fn: Any
    chunk_prefill_fn: Any = None
    verify_fn: Any = None


def make_serve_steps(cfg, *, impl: str = "kernel", max_len: int = 2048,
                     batch: int = 1, torch_chunk: int = 1024,
                     num_splits: int = 1, device="cuda",
                     paged=None, mesh=None) -> ServeArtifacts:
    """Serving steps of ``cfg`` with attention ``impl`` on ``device``.

    num_splits: split-KV slices per (batch, kv head) row of the decode step
    (and, paged, of the verify step). torch_chunk: KV chunk of
    ``impl="torch"``'s prefill.

    paged: a ``serving.PagedCacheConfig`` switches the cache to a page pool
    shared by all sequences. The signatures are then JAX's, with the caches
    updated in place:

      prefill_fn(params, tokens, segment_ids, positions, dest, state_slots,
                 caches) → (logits [B,S,Vpad], caches)   # packed prompts
      decode_fn(params, token, caches, block_tables, kv_len)
          → (logits [B,Vpad], caches)                    # B = max_batch
      chunk_prefill_fn(params, tokens, positions, dest, token_tables,
                       token_kv_len, state_slots, state_local, caches)
          → (logits [B,S,Vpad], caches)                  # global positions
      verify_fn(params, tokens, positions, dest, token_tables, token_kv_len,
                caches) → (logits [B,W,Vpad], caches)    # W = k + 1

    ``state_slots``/``state_local`` route the recurrent layers' per-slot
    state rows (hybrid archs); attention layers ignore them.

    mesh: a ``distributed.mesh.PoolMesh`` shards the page pool over its ranks
    (``paged.num_shards`` must equal its size): every rank runs the same
    steps on its shard of the pool and replicated weights, and decode merges
    the shards' attention partials (``distributed/paged.py``). The
    contiguous cache takes no mesh yet.
    """
    if paged is not None:
        if mesh is not None and paged.num_shards != mesh.size:
            raise ValueError(
                f"PagedCacheConfig.num_shards={paged.num_shards} must "
                f"equal the mesh's model-axis size {mesh.size} (the "
                f"allocator reserves one trash page per pool shard)")
        return _paged_serve_steps(cfg, paged, impl, torch_chunk, num_splits,
                                  device, mesh)
    if mesh is not None:
        raise NotImplementedError(
            "the contiguous cache over a mesh needs the sharding rules "
            "(weights and activations split over ranks), not yet ported: "
            "serve sharded with paged=")

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


def _paged_serve_steps(cfg, paged, impl, torch_chunk, num_splits, device,
                       mesh):
    def cache_init():
        with torch.inference_mode():
            return lm.init_paged_cache(cfg, paged, device=device, mesh=mesh)

    @torch.inference_mode()
    def prefill_fn(params, tokens, segment_ids, positions, dest, state_slots,
                   caches):
        ctx = Ctx(impl=impl, torch_chunk=torch_chunk, mesh=mesh)
        return lm.paged_prefill(cfg, params, ctx, tokens, segment_ids,
                                positions, dest, caches, state_slots)

    @torch.inference_mode()
    def decode_fn(params, token, caches, block_tables, kv_len):
        ctx = Ctx(impl=impl, torch_chunk=torch_chunk, num_splits=num_splits,
                  mesh=mesh)
        return lm.paged_decode_step(cfg, params, ctx, token, caches,
                                    block_tables, kv_len)

    @torch.inference_mode()
    def chunk_prefill_fn(params, tokens, positions, dest, token_tables,
                         token_kv_len, state_slots, state_local, caches):
        ctx = Ctx(impl=impl, torch_chunk=torch_chunk, mesh=mesh)
        return lm.paged_chunk_prefill(cfg, params, ctx, tokens, positions,
                                      dest, token_tables, token_kv_len, caches,
                                      state_slots, state_local)

    @torch.inference_mode()
    def verify_fn(params, tokens, positions, dest, token_tables, token_kv_len,
                  caches):
        # the latency-bound step it replaces, k + 1 tokens wide: the decode
        # step's split-KV launch parameter
        ctx = Ctx(impl=impl, torch_chunk=torch_chunk, num_splits=num_splits,
                  mesh=mesh)
        return lm.paged_verify_step(cfg, params, ctx, tokens, positions, dest,
                                    token_tables, token_kv_len, caches)

    return ServeArtifacts(prefill_fn=prefill_fn, decode_fn=decode_fn,
                          cache_init_fn=cache_init,
                          chunk_prefill_fn=chunk_prefill_fn,
                          verify_fn=verify_fn)
