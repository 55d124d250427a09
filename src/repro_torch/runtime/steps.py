"""Train, prefill and decode steps (counterpart of ``repro.runtime.steps``):
on one device, or over a mesh of ranks (every family;
``distributed/parallel.py``): the train step, and the serving steps on
the contiguous and the paged cache under JAX's serving rules.

PyTorch runs eagerly: there is no jit. The train step updates the params and
the optimizer state in place; the serving steps run under
``torch.inference_mode`` and update the caches in place, where the JAX steps
donate them and return new ones.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.distributed.mesh import as_train_mesh
from repro_torch.distributed.parallel import (NamedSharding, ShardPlan,
                                             batch_shardings, shard_batch)
from repro_torch.distributed.sharding import (ShardingRules, default_rules,
                                             vocab_pad_for)
from repro_torch.checkpoint import CheckpointShapeError
from repro_torch.models import lm
from repro_torch.kernels.rng import int32
from repro_torch.models.convert import convert_opt_state, convert_params
from repro_torch.models.layers import Ctx
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.runtime import tracing


@dataclasses.dataclass
class TrainArtifacts:
    """The train step and its state's initialiser.

    step_fn(params, opt_state, batch, step: int) → (params, opt_state,
        metrics {"ce", "loss", "grad_norm", "lr"}, and "moe_aux",
        "moe_dropped" for MoE archs); params and opt_state are updated in
        place and returned.
    grad_fn(params, batch, step: int) → (loss, metrics, grads {name:
        gradient}): the step before its update (on a mesh, each gradient
        the rank's shard, summed over the batch axes).
    init_fn(seed=0) → (params :class:`~repro_torch.models.lm.LM`,
        opt_state :class:`~repro_torch.optim.AdamWState`) on ``device``.
    from_jax(tree) → (params, opt_state) of a JAX ``Trainer`` checkpoint
        (``checkpoint.read_tree``: ``{"params", "opt"}`` in JAX's layout),
        through ``models.convert``; its master copy is dropped where the
        optimizer keeps none.

    On a training mesh (``mesh`` given), every tensor of the state is this
    rank's shard: ``init_fn`` draws the single-device ``init_params(seed,
    vocab_pad_to=)`` tensors and ``from_jax`` converts the leaves on the
    host, each rank keeping its part of a leaf before the next is made
    (the device never holds more than one full leaf); ``step_fn`` takes this rank's rows of the
    batch (``place_batch(batch, device, shardings["batch"])``).
    ``shardings``: ``{"params": {name: NamedSharding}, "opt": {"step":
    None, "m", "v", "master": the params' (None without a master)},
    "batch": {key: NamedSharding}}``; ``rules`` the sharding rules and
    ``plan`` the ``ShardPlan``; all None on one device.
    """
    step_fn: Any
    init_fn: Any
    device: Any
    from_jax: Any
    grad_fn: Any = None
    shardings: Optional[Dict[str, Any]] = None
    rules: Optional[ShardingRules] = None
    plan: Optional[ShardPlan] = None


def step_seed(step: int) -> int:
    """The per-step dropout seed, ``uint32(step) · 2654435761`` read as an
    int32, as the JAX step computes it."""
    return int32((int(step) % 2**32) * 2654435761 % 2**32)


def place_batch(batch: Dict[str, Any], device,
                shardings: Optional[Dict[str, NamedSharding]] = None
                ) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays from ``data.make_batch``) as tensors on
    ``device``: ids stay int32 (the kernels take int32 segment ids), floats
    (a frontend arch's ``embeds``) stay f32. With a mesh's batch
    ``shardings``, only this rank's rows (cut on the host). Spanned as
    ``data.place``."""
    with tracing.span("data.place"):
        if shardings is not None:
            return shard_batch({k: np.asarray(v) if not isinstance(
                v, torch.Tensor) else v for k, v in batch.items()},
                shardings, device)
        return {k: torch.as_tensor(np.asarray(v)).to(device)
                for k, v in batch.items()}


def make_train_step(cfg, *, mesh=None, opt: AdamWConfig = AdamWConfig(),
                    impl: str = "kernel", total_steps: int = 10000,
                    warmup_steps: int = 100, microbatch: Optional[int] = None,
                    torch_chunk: int = 1024, device="cuda") -> TrainArtifacts:
    """The training step of ``cfg`` with attention ``impl``, on one device
    or, with ``mesh`` (this rank's ``distributed.mesh.TrainMesh``), over a
    mesh of ranks (``default_rules(mesh, cfg)``, the vocab padded to the
    model axis; every family, its metrics global as one device reports
    them; the residual stream and, under ``seq_full``, attention's query
    rows over ``model`` where it divides the batch's sequence,
    ``ShardPlan.seq_rows``).

    microbatch: split the batch into rows of this size and accumulate:
    grads and loss are the means over microbatches, the other metrics those
    of the last one (as JAX's scan), MoE metrics included; on a mesh a
    microbatch is ``microbatch`` rows of the global batch, of which a rank
    holds its share. ``lr`` follows ``cosine_schedule`` and is reported in
    the metrics but not applied: the update uses ``opt.lr``, exactly as the
    JAX step does (it calls ``adamw_update`` without the scheduled rate).
    """
    if mesh is not None:
        return _mesh_train_step(cfg, mesh, opt, impl, total_steps,
                                warmup_steps, microbatch, torch_chunk, device)

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

    grad_fn, step_fn = _step_fns(cfg, opt, impl, total_steps, warmup_steps,
                                 microbatch, torch_chunk, device, None)
    return TrainArtifacts(step_fn=step_fn, init_fn=init_fn, device=device,
                          from_jax=from_jax, grad_fn=grad_fn)


def _step_fns(cfg, opt, impl, total_steps, warmup_steps, microbatch,
              torch_chunk, device, plan):
    """(grad_fn, step_fn) of :func:`make_train_step`; ``plan``: on a mesh,
    whose batch axes hold ``microbatch // size`` rows of each microbatch.
    Spans: ``train.step`` around ``step_fn``, and ``train.forward``,
    ``train.backward`` (each with ``micro`` under microbatches) and
    ``train.optimizer`` timed on the device too."""
    timed = torch.device(device)

    def loss_and_grads(params, batch, seed, **micro):
        ctx = Ctx(impl=impl, deterministic=(cfg.dropout_rate == 0.0),
                  seed=seed, torch_chunk=torch_chunk, plan=plan)
        with tracing.span("train.forward", device=timed, **micro):
            loss, metrics = lm.loss_fn(cfg, params, batch, ctx)
        with tracing.span("train.backward", device=timed, **micro):
            loss.backward()
            grads = {}
            for n, p in params.named_parameters():
                # a leaf the loss does not reach (the embedding of a batch
                # of embeds, frontend_proj of one of tokens) has a zero
                # gradient, as in JAX
                grads[n] = torch.zeros_like(p) if p.grad is None else p.grad
                p.grad = None
        # on a mesh the loss is this rank's term; the metrics hold the total
        loss = metrics["loss"] if plan is not None else loss
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def grad_fn(params, batch, step: int):
        seed = step_seed(step)
        rows = microbatch
        if plan is not None and microbatch is not None:
            rows = microbatch // plan.mesh.size(plan.batch)
        if microbatch is None:
            loss, metrics, grads = loss_and_grads(params, batch, seed)
        else:
            n_micro = batch["labels"].shape[0] // rows
            grads, loss = {}, torch.zeros((), dtype=torch.float32, device=device)
            for i in range(n_micro):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                l, metrics, g = loss_and_grads(params, mb, seed, micro=i)
                loss = loss + l
                for n, gi in g.items():          # summed in f32, as JAX's scan
                    gi = gi.float()
                    grads[n] = gi if n not in grads else grads[n].add_(gi)
            for g in grads.values():
                g.div_(n_micro)
            loss = loss / n_micro
        if plan is not None:
            plan.reduce_grads(grads, plan.seq_rows(batch["labels"].shape[1]))
        return loss, metrics, grads

    def step_fn(params, opt_state, batch, step: int):
        with tracing.span("train.step", step=step):
            loss, metrics, grads = grad_fn(params, batch, step)
            lr = cosine_schedule(step, warmup_steps, total_steps, opt.lr)
            with tracing.span("train.optimizer", device=timed):
                params, opt_state, om = adamw_update(grads, opt_state, params,
                                                     opt, plan=plan)
            metrics = dict(metrics, **om, lr=lr, loss=loss)
            return params, opt_state, metrics

    return grad_fn, step_fn


def _mesh_train_step(cfg, mesh, opt, impl, total_steps, warmup_steps,
                     microbatch, torch_chunk, device) -> TrainArtifacts:
    rules = default_rules(mesh, cfg)
    vpad_to = vocab_pad_for(mesh)
    vpad = lm.padded_vocab(cfg, vpad_to)
    logical = lm.param_specs(cfg)
    shapes = {n: tuple(p.shape) for n, p in
              lm.LM(cfg, vpad, device="meta").named_parameters()}
    plan = ShardPlan(cfg, mesh, rules, rules.tree_specs(shapes, logical),
                     logical)
    dp = mesh.size(plan.batch)
    if microbatch is not None and microbatch % dp:
        raise ValueError(f"microbatch {microbatch} does not split over the "
                         f"{dp} ranks of the batch axes")
    p_sh = {n: plan.sharding(n) for n in shapes}
    shardings = {"params": p_sh,
                 "opt": {"step": None, "m": p_sh, "v": p_sh,
                         "master": p_sh if opt.keep_master else None},
                 "batch": batch_shardings(mesh, rules, microbatch)}

    def local(name, t):
        """This rank's part of the full leaf ``t``, a tensor of its own on
        ``device`` (the full one is dropped by the caller)."""
        part = p_sh[name].shard(t)
        out = torch.empty(part.shape, dtype=part.dtype, device=device)
        return out.copy_(part)

    def init_fn(seed: int = 0):
        params = lm.init_params(cfg, seed=seed, device=device,
                                vocab_pad_to=vpad_to, keep=local)
        return params, adamw_init(params, opt)

    def from_jax(tree):
        o = tree["opt"]
        got = np.asarray(tree["params"]["embed"]).shape[0]
        if got != vpad:
            raise CheckpointShapeError(
                f"the checkpoint's vocab is padded to {got}, this mesh trains "
                f"{cfg.vocab_size} padded to {vpad} (a multiple of the model "
                f"axis {vpad_to})")
        if opt.keep_master and "master" not in o:
            raise ValueError("the JAX checkpoint has no f32 master copy for "
                             "an optimizer with keep_master=True")
        params = convert_params(cfg, tree["params"], keep=local)
        master = o["master"] if opt.keep_master else None
        return params, convert_opt_state(
            cfg, (o["step"], o["m"], o["v"], master),
            lm.LM(cfg, vpad, device="meta"), keep=local)

    grad_fn, step_fn = _step_fns(cfg, opt, impl, total_steps, warmup_steps,
                                 microbatch, torch_chunk, device, plan)
    return TrainArtifacts(step_fn=step_fn, init_fn=init_fn, device=device,
                          from_jax=from_jax, grad_fn=grad_fn,
                          shardings=shardings, rules=rules, plan=plan)


@dataclasses.dataclass
class ServeArtifacts:
    """The serving callables (see :func:`make_serve_steps` for the paged
    signatures).

    prefill_fn(params, tokens [B,S], caches, embeds=None)
        → (logits [B,Vpad], caches); an arch with a frontend may prefill
        from ``embeds`` [B,S,FRONTEND_DIM] with tokens None
    decode_fn(params, token [B], caches, position: int)
        → (logits [B,Vpad], caches)
    cache_init_fn() → fresh per-layer caches
    chunk_prefill_fn, verify_fn: paged only (chunked/suffix prefill,
        speculative verify)
    init_fn(seed=0) → the model with random weights (``lm.init_params``,
        the vocab padded to the mesh's ``model`` axis): on a mesh this
        rank's shard, each leaf drawn whole and cut before the next
    plan: the ``ShardPlan`` of a mesh (None on one device); its
        ``place(params)`` cuts a model held whole to this rank's shard
    """
    prefill_fn: Any
    decode_fn: Any
    cache_init_fn: Any
    chunk_prefill_fn: Any = None
    verify_fn: Any = None
    init_fn: Any = None
    plan: Any = None


def serving_plan(cfg, mesh, *, paged: bool = False,
                 batch: Optional[int] = None) -> ShardPlan:
    """The ``ShardPlan.serving`` of ``cfg`` on ``mesh`` (a ``TrainMesh``,
    or a ``PoolMesh`` as the mesh ``("model",)``), the vocab padded to its
    ``model`` axis; ``batch``: the contiguous cache's rows."""
    mesh = as_train_mesh(mesh)
    vpad = lm.padded_vocab(cfg, vocab_pad_for(mesh))
    shapes = {n: tuple(p.shape) for n, p in
              lm.LM(cfg, vpad, device="meta").named_parameters()}
    return ShardPlan.serving(cfg, mesh, shapes, lm.param_specs(cfg),
                             paged=paged, rows=batch)


def init_serve_params(cfg, plan=None, seed: int = 0, *, device="cuda"):
    """The model with random weights (``lm.init_params``): whole on one
    device (``plan`` None); on a mesh this rank's shard under the serving
    ``plan``, the vocab padded to its ``model`` axis, each leaf drawn whole
    and cut before the next is drawn (no rank holds the whole model)."""
    if plan is None:
        return lm.init_params(cfg, seed=seed, device=device)

    def local(name, t):
        part = plan.sharding(name).shard(t)
        return torch.empty(part.shape, dtype=part.dtype,
                           device=device).copy_(part)
    return lm.init_params(cfg, seed=seed, device=device,
                          vocab_pad_to=vocab_pad_for(plan.mesh), keep=local)


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
    updated in place; the prefill and chunk steps return the logits of the
    rows that end a span only (of ``segment_ids``, of ``state_slots``; N of
    them, row-major), the rows the engine samples, where JAX returns every
    row's:

      prefill_fn(params, tokens, segment_ids, positions, dest, state_slots,
                 caches) → (logits [N,Vpad], caches)     # packed prompts
      decode_fn(params, token, caches, block_tables, kv_len)
          → (logits [B,Vpad], caches)                    # B = max_batch
      chunk_prefill_fn(params, tokens, positions, dest, token_tables,
                       token_kv_len, state_slots, state_local, caches)
          → (logits [N,Vpad], caches)                    # global positions
      verify_fn(params, tokens, positions, dest, token_tables, token_kv_len,
                caches) → (logits [B,W,Vpad], caches)    # W = k + 1

    ``state_slots``/``state_local`` route the recurrent layers' per-slot
    state rows (hybrid archs); attention layers ignore them.

    mesh: a ``distributed.mesh.TrainMesh`` (or a ``PoolMesh``, the mesh
    ``("model",)``): every rank runs the same steps on its shard of the
    model and the caches under JAX's serving rules (``ShardPlan.serving``:
    prefill and decode rules, the weights held once as the prefill rules
    lay them out, an FSDP config's ``embed`` dims over ``data`` gathered
    at each use by prefill and decode alike, the vocab padded to
    ``model``). JAX's contiguous launcher lays the caller's weights out
    under ``in_shardings`` on each prefill call and hands decode the
    caller's layout; the port holds them once where JAX's
    ``ServingEngine`` places them, on both caches: the same values, the
    bytes a rank holds and the collectives that layout implies, with no
    re-layout a call. The steps take the global inputs, and
    return the global logits, every vocab column gathered, equal on every
    rank. A prefill (and a chunk or verify step) runs under the prefill
    rules' ``seq`` where ``model`` divides its rows, and ``seq_full``
    where the rules set it: the caches are filled from the gathered K/V,
    and the contiguous prefill's last-position logits come from the rank
    that holds that row; decode's one token stays replicated. The contiguous cache holds the rank's batch rows (all of them,
    replicated, where ``batch`` does not split over the batch axes, as
    JAX's rules fall back) and its kv heads, or its slots of every kv
    head where the kv heads do not split (``kv_cache_seq``); the page pool
    is sharded over ``model`` (``paged.num_shards`` must equal its size)
    and its slots replicated over the batch axes, decode merging the
    shards' attention partials (``distributed/paged.py``).
    """
    plan = None
    if mesh is not None:
        plan = serving_plan(cfg, mesh, paged=paged is not None,
                            batch=None if paged is not None else batch)
    gather = (lambda t: t) if plan is None else plan.gather_logits
    if paged is not None:
        pool = None if plan is None else plan.mesh.pool
        if pool is not None and paged.num_shards != pool.size:
            raise ValueError(
                f"PagedCacheConfig.num_shards={paged.num_shards} must "
                f"equal the mesh's model-axis size {pool.size} (the "
                f"allocator reserves one trash page per pool shard)")
        return _paged_serve_steps(cfg, paged, impl, torch_chunk, num_splits,
                                  device, plan, gather)
    rows = (lambda t: t) if plan is None else plan.batch_part

    def cache_init():
        with torch.inference_mode():
            return lm.init_cache(cfg, batch, max_len, device=device, plan=plan)

    @torch.inference_mode()
    def prefill_fn(params, tokens, caches, embeds=None):
        ctx = Ctx(impl=impl, torch_chunk=torch_chunk, plan=plan)
        logits, caches = lm.prefill(
            cfg, params, ctx, None if tokens is None else rows(tokens), caches,
            embeds=None if embeds is None else rows(embeds))
        return gather(logits), caches

    @torch.inference_mode()
    def decode_fn(params, token, caches, position):
        ctx = Ctx(impl=impl, torch_chunk=torch_chunk, num_splits=num_splits,
                  plan=plan)
        logits, caches = lm.decode_step(cfg, params, ctx, rows(token), caches,
                                        position)
        return gather(logits), caches

    return ServeArtifacts(prefill_fn=prefill_fn, decode_fn=decode_fn,
                          cache_init_fn=cache_init,
                          init_fn=functools.partial(init_serve_params, cfg,
                                                    plan, device=device), plan=plan)


def _paged_serve_steps(cfg, paged, impl, torch_chunk, num_splits, device,
                       plan, gather):
    def cache_init():
        with torch.inference_mode():
            return lm.init_paged_cache(cfg, paged, device=device, plan=plan)

    def ctx(**kw):
        return Ctx(impl=impl, torch_chunk=torch_chunk, plan=plan, **kw)

    @torch.inference_mode()
    def prefill_fn(params, tokens, segment_ids, positions, dest, state_slots,
                   caches):
        logits, caches = lm.paged_prefill(cfg, params, ctx(), tokens,
                                          segment_ids, positions, dest,
                                          caches, state_slots)
        return gather(logits), caches

    @torch.inference_mode()
    def decode_fn(params, token, caches, block_tables, kv_len):
        logits, caches = lm.paged_decode_step(
            cfg, params, ctx(num_splits=num_splits), token, caches,
            block_tables, kv_len)
        return gather(logits), caches

    @torch.inference_mode()
    def chunk_prefill_fn(params, tokens, positions, dest, token_tables,
                         token_kv_len, state_slots, state_local, caches):
        logits, caches = lm.paged_chunk_prefill(
            cfg, params, ctx(), tokens, positions, dest, token_tables,
            token_kv_len, caches, state_slots, state_local)
        return gather(logits), caches

    @torch.inference_mode()
    def verify_fn(params, tokens, positions, dest, token_tables, token_kv_len,
                  caches):
        # the latency-bound step it replaces, k + 1 tokens wide: the decode
        # step's split-KV launch parameter
        logits, caches = lm.paged_verify_step(
            cfg, params, ctx(num_splits=num_splits), tokens, positions, dest,
            token_tables, token_kv_len, caches)
        return gather(logits), caches

    return ServeArtifacts(prefill_fn=prefill_fn, decode_fn=decode_fn,
                          cache_init_fn=cache_init,
                          chunk_prefill_fn=chunk_prefill_fn,
                          verify_fn=verify_fn,
                          init_fn=functools.partial(init_serve_params, cfg,
                                                    plan, device=device), plan=plan)
