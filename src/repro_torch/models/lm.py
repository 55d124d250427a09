"""The decoder LM of the port (counterpart of ``repro.models.lm``): the dense
attention-only family, the hybrid one (recurrentgemma: RG-LRU blocks and
local attention blocks in ``cfg.block_pattern``, cycled over the layers),
the MoE one (``cfg.moe``: every layer's FFN a mixture of experts,
``models/moe.py``), the ssm one (falcon-mamba: mixer-only Mamba blocks,
``models/mamba.py``, no attention layer) and the two frontend families:
the vlm llava-next-34b (a dense decoder) and the encoder hubert-xlarge
(non-causal attention, the ungated GELU MLP), both also fed precomputed
``FRONTEND_DIM``-wide patch or frame embeddings through ``frontend_proj``.

The JAX package scans stacked superblock params; here the layers are an
``nn.ModuleList`` walked by a plain loop, layer ``i`` of kind
``block_pattern[i % period]``, with the same per-layer dropout seed offset
``i * 1000003`` (the sum wraps to int32, as JAX's does). With ``cfg.remat``
and autograd on, each layer runs under ``torch.utils.checkpoint`` (JAX
remats per superblock): only the layer inputs are kept, and the backward
recomputes the layer, attention kernel included. Serving caches are a list
of per-layer dicts: K/V (a ring of ``window`` slots, or page pools) for
attention layers, state rows ``{"h", "conv"}`` for recurrent (RG-LRU and
Mamba) ones. MoE layers report ``moe_aux`` (summed over the layers) and
``moe_dropped`` (averaged) as JAX's forward does, in a forward without
caches; the serving steps, which drop them, do not compute them.

On a mesh (``ctx.plan``, a ``distributed.parallel.ShardPlan``) the
parameters are the rank's shards and every layer runs its part:
tensor-parallel over ``model`` (attention heads, MLPs, the recurrent
mixers' channels), sequence-parallel residuals (a rank's rows between the
blocks where the rules' ``seq`` applies) and context-parallel attention
(its query rows under ``seq_full``), expert-parallel MoE layers, FSDP
weights gathered before use, the vocab-parallel embedding, logits and
cross-entropy (the rows gathered before the head, so the cross-entropy
is today's over every row: the vocab-parallel lse needs every vocab
shard of a row on one rank, which the gather of ``d``-wide rows gives at
less traffic than moving ``V / model``-wide logits);
``loss_fn`` then returns this rank's term of the global loss (see the
plan), and the MoE metrics are global. Serving on a mesh
(``ShardPlan.serving``) threads the rank's shard of every cache
(:func:`init_cache` / :func:`init_paged_cache` with the plan) and returns
the rank's batch rows and vocab columns of the logits.

Public entry points:
  init_params(cfg, seed=, device=, vocab_pad_to=, keep=) → LM (random weights)
  param_specs(cfg)                                 → {name: logical axes}
  forward(cfg, params, ctx, tokens= or embeds=, caches=, ...)
                                                   → (logits, caches, metrics)
  loss_fn(cfg, params, batch, ctx)                 → (loss, metrics)
  init_cache / prefill / decode_step               → contiguous KV serving
  init_paged_cache / paged_prefill / paged_chunk_prefill /
  paged_verify_step / paged_decode_step            → paged KV serving
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.paged import pages_per_shard
from repro_torch.models import layers, mamba, moe, rglru
from repro_torch.models.layers import Ctx

#: the block kinds of ``cfg.block_pattern`` the port runs
KINDS = ("attn", "rec", "ssm")
#: the families and dense FFNs the port runs (every arch of ``configs.ARCHS``)
FAMILIES = ("dense", "hybrid", "moe", "ssm", "vlm", "encoder")
MLP_TYPES = ("gated_silu", "gelu")
#: the width of the embeddings the stub frontends hand over (JAX's
#: ``lm.FRONTEND_DIM``)
FRONTEND_DIM = 1024
#: each kind's mixer: (module class, initialiser, serving state rows)
_MIXERS = {
    "attn": (layers.Attention, layers.init_attention, None),
    "rec": (rglru.RGLRU, rglru.init_rglru, rglru.init_rglru_cache),
    "ssm": (mamba.Mamba, mamba.init_mamba, mamba.init_mamba_cache),
}
#: the weight of an MoE arch's load-balance loss in the training loss
#: (JAX ``loss_fn``'s default, the value every JAX caller uses)
MOE_AUX_WEIGHT = 0.01
#: each parameter's logical axes by its name in a block (JAX's specs from
#: ``init_params`` and the layers' ``dense_init``, the stacked ``layers``
#: lead dropped), and the top-level ones
_SPECS_TOP = {"embed": ("vocab", "embed"), "final_norm": ("embed",),
              "lm_head": ("embed", "vocab"), "frontend_proj": (None, "embed")}
_SPECS_BLOCK = {
    "norm1": ("embed",), "norm2": ("embed",),
    # attention
    "mixer.wq": ("embed", "q_proj"), "mixer.wk": ("embed", "kv_proj"),
    "mixer.wv": ("embed", "kv_proj"), "mixer.q_norm": ("head_dim",),
    "mixer.k_norm": ("head_dim",),
    # the RG-LRU
    "mixer.wx": ("embed", "rnn"), "mixer.wg": ("embed", "rnn"),
    "mixer.w_inp": ("rnn", "rnn"), "mixer.w_rec": ("rnn", "rnn"),
    "mixer.lambda": ("rnn",),
    # Mamba
    "mixer.in_proj": ("embed", "rnn"), "mixer.w_bc": ("rnn", "state"),
    "mixer.w_dt1": ("rnn", None), "mixer.w_dt2": (None, "rnn"),
    "mixer.dt_bias": ("rnn",), "mixer.A_log": ("rnn", "state"),
    "mixer.D": ("rnn",), "mixer.out_proj": ("rnn", "embed"),
    "mixer.conv": (None, "rnn"),
    # dense MLP
    "mlp.wi": ("embed", "mlp"), "mlp.wo": ("mlp", "embed"),
    # MoE
    "mlp.router": ("embed", "experts"),
    "mlp.shared.wi": ("embed", "mlp"), "mlp.shared.wo": ("mlp", "embed"),
}
_SPECS_KIND = {("attn", "mixer.wo"): ("q_proj", "embed"),
               ("rec", "mixer.wo"): ("rnn", "embed")}
_SPECS_MOE = {"mlp.wi": ("experts", "embed", "expert_mlp"),
              "mlp.wo": ("experts", "expert_mlp", "embed")}


def block_kinds(cfg) -> List[str]:
    """Each layer's kind: ``block_pattern`` cycled over the layers."""
    period = len(cfg.block_pattern)
    return [cfg.block_pattern[i % period] for i in range(cfg.num_layers)]


class Block(nn.Module):
    """One pre-norm block, a mixer (attention, the RG-LRU for ``kind``
    "rec", Mamba for "ssm") and a dense MLP (gated unless ``cfg.mlp_type``
    is "gelu"), or a
    :class:`~repro_torch.models.moe.MoE` when ``cfg.moe`` is set (JAX
    ``_init_block``'s leaves). An "ssm" block is mixer-only: no ``norm2``
    and no ``mlp`` (d_ff 0), as in JAX."""

    def __init__(self, cfg, kind: str, dtype, device):
        super().__init__()
        self.kind = kind
        self.norm1 = layers._param((cfg.d_model,), dtype, device)
        self.mixer = _MIXERS[kind][0](cfg, dtype, device)
        if kind == "ssm":
            return
        self.norm2 = layers._param((cfg.d_model,), dtype, device)
        self.mlp = (moe.MoE(cfg, dtype, device) if cfg.moe is not None
                    else layers.MLP(cfg.d_model, cfg.d_ff, dtype, device,
                                    gated=cfg.mlp_type == "gated_silu"))


class LM(nn.Module):
    """Parameters of the model: ``embed [Vpad, d]``, ``blocks``,
    ``final_norm [d]``, ``lm_head [d, Vpad]`` and, for an arch with a
    frontend, ``frontend_proj [FRONTEND_DIM, d]``, allocated uninitialised
    on ``device``; :func:`init_params` or ``convert.convert_params`` fill
    them. Refuses a config that no arch of ``configs.ARCHS`` has."""

    def __init__(self, cfg, vocab_padded: int, *, device, dtype=None):
        super().__init__()
        if (cfg.family not in FAMILIES or cfg.mlp_type not in MLP_TYPES
                or (cfg.family == "moe") != (cfg.moe is not None)
                or (cfg.family in ("vlm", "encoder")) != (cfg.frontend is not None)
                or not set(cfg.block_pattern) <= set(KINDS)
                or ("rec" in cfg.block_pattern) != (cfg.rglru is not None)
                or ("ssm" in cfg.block_pattern) != (cfg.mamba is not None)):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family with frontend "
                f"{cfg.frontend} and mlp_type {cfg.mlp_type} is not an arch "
                f"of repro_torch (families {', '.join(FAMILIES)}; mlp_type "
                f"{' or '.join(MLP_TYPES)})")
        dtype = dtype or cfg.dtype
        self.embed = layers._param((vocab_padded, cfg.d_model), dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, kind, dtype, device)
                                    for kind in block_kinds(cfg))
        self.final_norm = layers._param((cfg.d_model,), dtype, device)
        self.lm_head = layers._param((cfg.d_model, vocab_padded), dtype, device)
        if cfg.frontend is not None:
            self.frontend_proj = layers._param((FRONTEND_DIM, cfg.d_model),
                                               dtype, device)


def padded_vocab(cfg, vocab_pad_to: int) -> int:
    """The vocab rounded up to a multiple of ``vocab_pad_to``."""
    return -(-cfg.vocab_size // vocab_pad_to) * vocab_pad_to


def param_specs(cfg) -> dict:
    """The logical axes of every parameter of ``cfg``'s :class:`LM`, by
    its name (JAX's specs, the stacked ``layers`` lead dropped)."""
    model = LM(cfg, cfg.vocab_size, device="meta")
    kinds = block_kinds(cfg)
    out = {}
    for name, _ in model.named_parameters():
        if not name.startswith("blocks."):
            out[name] = _SPECS_TOP[name]
            continue
        _, i, key = name.split(".", 2)
        if cfg.moe is not None and key in _SPECS_MOE:
            out[name] = _SPECS_MOE[key]
        else:
            out[name] = _SPECS_KIND.get((kinds[int(i)], key)) or _SPECS_BLOCK[key]
    return out


@torch.no_grad()
def init_params(cfg, *, seed: int = 0, device="cuda",
                vocab_pad_to: int = 1, keep=None) -> LM:
    """Random weights with the JAX package's shapes and scales (normal ·
    d_in**-0.5 matrices, 0.02 embedding, unit norms), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``; the vocab
    padded to a multiple of ``vocab_pad_to`` (the padded rows and columns
    drawn too, as JAX's are). The draws differ from JAX's;
    ``convert.convert_params`` carries JAX weights over.

    The vocab's ``cfg.vocab_size`` rows of ``embed`` and columns of
    ``lm_head`` take the draws of the unpadded model; the padded ones come
    from a second generator (seeded ``seed + 1``) after them, so a model
    padded for a mesh computes the unpadded model's logits.

    keep(name, full) → tensor: the model is built on "meta" and each
    parameter becomes what ``keep`` returns for its full draw before the
    next is drawn, in the same order and so with the same values; a mesh
    rank keeps its shard, and at most one full parameter is alive at a
    time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pad_gen = torch.Generator(device=device).manual_seed(seed + 1)
    vpad = padded_vocab(cfg, vocab_pad_to)
    extra = vpad - cfg.vocab_size
    model = LM(cfg, vpad, device=device if keep is None else "meta")

    def put(name, full):
        if keep is None:
            model.get_parameter(name).copy_(full)
        else:
            set_param(model, name, keep(name, full))

    def under(prefix):
        return None if keep is None else (lambda n, t: keep(prefix + n, t))

    def ones(name):
        w = model.get_parameter(name)
        return torch.ones(w.shape, dtype=w.dtype, device=device)

    for i, blk in enumerate(model.blocks):
        pre = f"blocks.{i}."
        put(pre + "norm1", ones(pre + "norm1"))
        blk.mixer = _MIXERS[blk.kind][1](gen, cfg, cfg.dtype,
                                         keep=under(pre + "mixer."))
        if blk.kind == "ssm":
            continue
        put(pre + "norm2", ones(pre + "norm2"))
        blk.mlp = (moe.init_moe(gen, cfg, cfg.dtype, keep=under(pre + "mlp."))
                   if cfg.moe is not None else
                   layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype,
                                   gated=cfg.mlp_type == "gated_silu",
                                   keep=under(pre + "mlp.")))
    embed = layers.dense_init(gen, cfg.vocab_size, cfg.d_model, cfg.dtype,
                              scale=0.02)
    if extra:
        embed = torch.cat([embed, layers.dense_init(
            pad_gen, extra, cfg.d_model, cfg.dtype, scale=0.02)])
    put("embed", embed)
    del embed
    put("final_norm", ones("final_norm"))
    head = layers.dense_init(gen, cfg.d_model, cfg.vocab_size, cfg.dtype)
    if extra:
        head = torch.cat([head, layers.dense_init(
            pad_gen, cfg.d_model, extra, cfg.dtype,
            scale=cfg.d_model ** -0.5)], dim=1)
    put("lm_head", head)
    del head
    if cfg.frontend is not None:
        put("frontend_proj", layers.dense_init(gen, FRONTEND_DIM, cfg.d_model,
                                               cfg.dtype))
    return model


def set_param(model: nn.Module, name: str, t: torch.Tensor) -> None:
    """Replace parameter ``name`` (dotted, as ``blocks.3.mixer.wq``) of
    ``model`` by a new parameter holding ``t``."""
    mod, _, attr = name.rpartition(".")
    setattr(model.get_submodule(mod) if mod else model, attr, nn.Parameter(t))


def _apply_block(p: Block, x, ctx: Ctx, cfg, *, positions, cache, layer_seed,
                 segment_ids=None, paged=None):
    """→ (x, new_cache, metrics: the MoE's without a cache, or {})."""
    h = layers.rms_norm(x, layers.weight(ctx, p.norm1, "norm1"))
    if p.kind == "attn":
        mixed, new_cache = layers.apply_attention(
            p.mixer, h, ctx, cfg, positions=positions, cache=cache,
            layer_seed=layer_seed, segment_ids=segment_ids, paged=paged)
    else:
        # the recurrence carries state across a whole row whatever its
        # segments (packing is an attention-family feature, as in JAX)
        apply = rglru.apply_rglru if p.kind == "rec" else mamba.apply_mamba
        mixed, new_cache = apply(p.mixer, h, ctx, cfg, cache=cache,
                                 positions=positions, paged=paged)
    x = x + mixed
    if p.kind == "ssm":                    # mixer-only
        return x, new_cache, {}
    h = layers.rms_norm(x, layers.weight(ctx, p.norm2, "norm2"))
    if cfg.moe is not None:
        out, metrics = moe.apply_moe(p.mlp, h, ctx, cfg,
                                     metrics=cache is None)
        return x + out, new_cache, metrics
    return x + layers.apply_mlp(p.mlp, h, ctx), new_cache, {}


def _train_block(p: Block, x, ctx: Ctx, cfg, positions, segment_ids,
                 layer_seed: int):
    """One layer without a cache: what ``checkpoint`` recomputes.
    → (x, metrics)."""
    x, _, metrics = _apply_block(p, x, ctx, cfg, positions=positions,
                                 cache=None, layer_seed=layer_seed,
                                 segment_ids=segment_ids)
    return x, metrics


def forward(cfg, params: LM, ctx: Ctx, *, tokens=None, embeds=None,
            caches=None, positions=None, segment_ids=None, paged=None,
            rows=None, last: bool = False):
    """tokens [B, S] int or embeds [B, S, FRONTEND_DIM] (an arch with a
    frontend; cast to the model's dtype, then ``@ frontend_proj``) →
    (logits [B, S, Vpad], new_caches or None, metrics): metrics are
    {"moe_aux": sum over the layers, "moe_dropped": mean over the layers}
    for MoE archs without caches, {} otherwise.

    positions: [B, S] or [S] RoPE positions (default ``arange(S)``).
    segment_ids [B, S]: packed-batch ids (int32); attention masks
    cross-segment pairs — pass per-segment ``positions`` alongside.
    paged: the routing of paged caches, passed to every layer
    (``layers.apply_attention``, ``rglru.apply_rglru``,
    ``mamba.apply_mamba``).
    rows: a bool mask [B, S]; only these rows go through the final norm
    (under ``seq``: after it) and the head, and the logits are [N, Vpad],
    the rows in row-major order.
    last: the caller reads the last position's logits only; under ``seq``
    only that row (the last ``model`` rank's) is gathered for the head,
    and the logits are [B, 1, Vpad].

    On a mesh whose plan lays the sequence out over ``model``
    (``ShardPlan.seq_rows`` of S) the blocks run under ``ctx.seq``: the
    embedding (or the frontend projection) ends in this rank's rows, the
    blocks take and give them, the final norm runs on them, and the rows
    are gathered before the vocab-parallel head, so the logits and the
    cross-entropy are those of every row (the loss as without ``seq``;
    the gather sums the head's partial input gradients over ``model``).
    """
    if (tokens is None) == (embeds is None):
        raise ValueError("forward takes tokens or embeds, one of the two")
    plan = ctx.plan
    s = (tokens if embeds is None else embeds).shape[1]
    seq = plan is not None and plan.seq_rows(s)
    if seq != ctx.seq:
        ctx = dataclasses.replace(ctx, seq=seq)
    if embeds is None:
        x = params.embed[tokens] if plan is None else plan.embed(params.embed,
                                                                 tokens, seq)
    elif cfg.frontend is None:
        raise ValueError(f"{cfg.name} has no frontend: it takes tokens")
    else:
        x = (plan.seq_part(embeds) if seq else embeds).to(
            params.frontend_proj.dtype) @ layers.weight(
                ctx, params.frontend_proj, "frontend_proj")
    if positions is None:
        positions = torch.arange(s, device=x.device)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    new_caches: Optional[List[dict]] = None if caches is None else []
    layer_metrics = []
    for i, blk in enumerate(params.blocks):
        if plan is not None:
            plan.log_rows("residual", x.shape[1])
        if remat:
            x, m = checkpoint(_train_block, blk, x, ctx, cfg, positions,
                              segment_ids, i * 1000003, use_reentrant=False)
        else:
            x, nc, m = _apply_block(blk, x, ctx, cfg, positions=positions,
                                    cache=None if caches is None else caches[i],
                                    layer_seed=i * 1000003,
                                    segment_ids=segment_ids, paged=paged)
            if new_caches is not None:
                new_caches.append(nc)
        if m:
            layer_metrics.append(m)
    metrics = {}
    if layer_metrics:
        metrics = {"moe_aux": sum(m["moe_aux"] for m in layer_metrics),
                   "moe_dropped": sum(m["moe_dropped"] for m in layer_metrics)
                   / len(layer_metrics)}
    if seq:        # the final norm on this rank's rows, then every row
        x = layers.rms_norm(x, layers.weight(ctx, params.final_norm,
                                             "final_norm"))
        x = plan.seq_last(x) if last else plan.gather_seq(x)
        if rows is not None:
            x = x[rows]
        return (x @ layers.weight(ctx, params.lm_head, "lm_head"), new_caches,
                metrics)
    if rows is not None:
        x = x[rows]
    x = layers.rms_norm(x, layers.weight(ctx, params.final_norm, "final_norm"))
    if plan is not None:
        return plan.logits(x, params.lm_head), new_caches, metrics
    return x @ params.lm_head, new_caches, metrics


def loss_fn(cfg, params: LM, batch, ctx: Ctx):
    """batch: {"tokens" [B, S] or "embeds" [B, S, FRONTEND_DIM], "labels"
    [B, S]} (+ optional "segment_ids", "positions" for packed batches),
    tensors on the params' device.
    Next-token CE for causal LMs, per-position CE for encoders; a packed
    batch gives no weight to a segment's last token (it must not predict
    the next segment) or to padding. MoE archs add ``MOE_AUX_WEIGHT ·
    moe_aux``. Returns (loss, {"ce", "loss"} and the forward's metrics).

    On a training mesh (``ctx.plan``) the batch is this rank's rows and the
    returned loss this rank's term of the global one (its weighted sum over
    the global weight sum, plus its share of ``MOE_AUX_WEIGHT · moe_aux``:
    the terms' gradients sum to the loss's); the metrics hold the global
    loss."""
    seg = batch.get("segment_ids")
    logits, _, metrics = forward(cfg, params, ctx, tokens=batch.get("tokens"),
                                 embeds=batch.get("embeds"),
                                 positions=batch.get("positions"),
                                 segment_ids=seg)
    labels = batch["labels"]
    weights = None
    if cfg.causal:
        logits, labels = logits[:, :-1], labels[:, 1:]
        if seg is not None:
            weights = ((seg[:, :-1] == seg[:, 1:]) & (seg[:, 1:] >= 0)).float()
    elif seg is not None:
        weights = (seg >= 0).float()
    if ctx.plan is not None:
        term, ce = ctx.plan.cross_entropy(logits, labels, cfg.vocab_size,
                                          weights)
        loss = ce
        if cfg.moe is not None:     # global, its gradient this rank's share
            term = term + MOE_AUX_WEIGHT * metrics["moe_aux"]
            loss = ce + MOE_AUX_WEIGHT * metrics["moe_aux"].detach()
        return term, dict(metrics, ce=ce, loss=loss)
    ce = layers.softmax_cross_entropy(logits, labels, cfg.vocab_size,
                                      weights=weights)
    loss = ce
    if cfg.moe is not None:
        loss = loss + MOE_AUX_WEIGHT * metrics["moe_aux"]
    return loss, dict(metrics, ce=ce, loss=loss)


def _state_channels(cfg, plan):
    """A recurrent layer's state channels on this rank: its ``rnn``
    channels where the plan splits them over ``model``."""
    if plan is None or not plan.rnn:
        return None
    width = cfg.rglru.d_rnn if cfg.rglru is not None else cfg.mamba.d_inner
    return width // plan.mesh.size("model")


def init_cache(cfg, batch: int, max_len: int, dtype=None, *, device="cuda",
               plan=None):
    """Per-layer contiguous caches: KV for attention layers (sliding-window
    archs keep only ``window`` slots), zero state rows for recurrent ones.

    On a serving mesh (``plan``, ``ShardPlan.serving``) each is this rank's
    shard: ``batch / (batch ranks)`` rows; kv heads over ``model`` where the
    plan splits them, else (``plan.kv_seq``) every kv head on ``cap /
    model`` of the cache's slots (``plan.kv_shards``), the dict then
    carrying ``"shards"``; recurrent state on the rank's channels."""
    dtype = dtype or cfg.dtype
    eff = max_len if cfg.attn_window is None else min(max_len, cfg.attn_window)
    hkv, shards = None, 1
    if plan is not None:
        n = plan.mesh.size(plan.batch)
        if batch % n:
            raise ValueError(f"a batch of {batch} rows does not split over "
                             f"the {n} ranks of the batch axes {plan.batch}")
        batch //= n
        if plan.kv:
            hkv = cfg.num_kv_heads // plan.mesh.size("model")
        shards = plan.kv_shards(eff)
    channels = _state_channels(cfg, plan)
    out = []
    for kind in block_kinds(cfg):
        if kind != "attn":
            out.append(_MIXERS[kind][2](cfg, batch, device, channels))
            continue
        cache = layers.init_attn_cache(cfg, batch, eff // shards, dtype,
                                       device, hkv)
        if shards > 1:
            cache["shards"] = shards
        out.append(cache)
    return out


def prefill(cfg, params: LM, ctx: Ctx, tokens=None, caches=None, *,
            embeds=None):
    """Run the full prompt, tokens [B, S] or ``embeds`` [B, S,
    FRONTEND_DIM], filling the caches in place. Returns (last-position
    logits [B, Vpad], caches)."""
    logits, caches, _ = forward(cfg, params, ctx, tokens=tokens,
                                embeds=embeds, caches=caches, last=True)
    return logits[:, -1], caches


def decode_step(cfg, params: LM, ctx: Ctx, token, caches, position: int):
    """One autoregressive step. token [B] int → (logits [B, Vpad], caches);
    the caches are updated in place."""
    ctx = dataclasses.replace(ctx, decode=True)
    positions = torch.full((token.shape[0], 1), position, dtype=torch.int32,
                           device=token.device)
    logits, caches, _ = forward(cfg, params, ctx, tokens=token[:, None],
                                caches=caches, positions=positions)
    return logits[:, 0], caches


# ---------------------------------------------------------------------------
# paged serving: page-pool cache / packed prefill / block-table decode
# ---------------------------------------------------------------------------

def init_paged_cache(cfg, paged_cfg, dtype=None, *, device="cuda",
                     plan=None):
    """Per-layer serving caches: attention layers get page pools
    ``{"k_pages", "v_pages"}`` [Hkv, num_pages, page_size, D] (no batch dim:
    sequences share the pool through block tables; host-side page lifecycle
    in ``serving/paged_cache.py``); with a serving ``plan`` whose ``model``
    axis has a process group (``TrainMesh.pool_shards``) they are this
    rank's shard,
    [Hkv, num_pages / N, page_size, D]. Recurrent layers get per-slot state
    rows ``{"h", "conv"}`` [max_batch + 1, ...]: slot i backs decode slot
    i, and the trailing trash row absorbs padding tokens' gathers and
    scatters (host-side slot lifecycle in ``serving/state_cache.py``).
    Under a mesh every rank keeps all of the rows, beside its shard of the
    pools: the slots are replicated over the mesh, so every rank's
    recurrent blocks see the same tokens; where the ``plan`` splits the
    ``rnn`` channels a row holds the rank's channels."""
    kinds = block_kinds(cfg)
    dtype = dtype or cfg.dtype
    pool = None if plan is None else plan.mesh.pool_shards
    local = (None if pool is None else
             pages_per_shard(paged_cfg.num_pages, pool.size))
    channels = _state_channels(cfg, plan)
    return [layers.init_paged_attn_cache(cfg, paged_cfg, dtype, device, local)
            if kind == "attn"
            else _MIXERS[kind][2](cfg, paged_cfg.max_batch + 1, device, channels)
            for kind in kinds]


def span_ends(ids):
    """``ids`` [B, S] naming each token's span (-1 padding) → a bool mask of
    the last token of each span: the rows whose logits the engine samples."""
    nxt = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -1)], dim=1)
    return (ids >= 0) & (ids != nxt)


def paged_prefill(cfg, params: LM, ctx: Ctx, tokens, segment_ids, positions,
                  dest, caches, state_slots=None):
    """Segment-aware packed prefill: many prompts in one forward.

    tokens/segment_ids/positions [B, S] (prompts packed along S, -1 = pad,
    per-prompt positions from 0); dest [B, S] flat page-pool token slots
    (``BlockTables.prefill_dest``). Fills the pools in place. Returns
    (logits [N, Vpad], caches): the rows that end a segment, the rows the
    engine samples, in row-major order (each prompt's last token).
    state_slots [B, S] (recurrent archs): each token's decode slot, -1 for
    padding; recurrent layers reset their scan at every span start and
    scatter span-end state into the slot's row. Prefill spans start at
    position 0, so the per-segment positions are the offsets in the span.
    """
    paged = {"dest": dest}
    if state_slots is not None:
        paged.update(state_slots=state_slots, state_local=positions)
    return forward(cfg, params, ctx, tokens=tokens, caches=caches,
                   positions=positions, segment_ids=segment_ids,
                   paged=paged, rows=span_ends(segment_ids))[:2]


def paged_chunk_prefill(cfg, params: LM, ctx: Ctx, tokens, positions, dest,
                        token_tables, token_kv_len, caches, state_slots,
                        state_local=None):
    """Chunked / suffix packed prefill: prompt spans whose earlier tokens
    already live in pages (prefix-cache hits, earlier chunks).

    tokens/positions [B, S] with global per-token positions; dest [B, S]
    flat pool slots (``BlockTables.span_dest``, padding → trash);
    token_tables [B, S, T] each token's block-table row; token_kv_len
    [B, S] = position + 1 for real tokens, 0 for padding. Each layer
    scatters the span's K/V first, then every token attends through its own
    table row. state_slots [B, S]: each token's decode slot (-1 padding);
    state_local [B, S] (recurrent archs): each token's offset in its span;
    a span whose global start (position - local) is past 0 resumes the
    slot's stored state. Returns (logits [N, Vpad], caches): the rows that
    end a span of ``state_slots``, in row-major order.
    """
    paged = {"dest": dest, "token_tables": token_tables,
             "token_kv_len": token_kv_len}
    if state_local is not None:
        paged.update(state_slots=state_slots, state_local=state_local)
    return forward(cfg, params, ctx, tokens=tokens, caches=caches,
                   positions=positions, paged=paged,
                   rows=span_ends(state_slots))[:2]


def paged_verify_step(cfg, params: LM, ctx: Ctx, tokens, positions, dest,
                      token_tables, token_kv_len, caches):
    """Speculative verify: score ``k + 1`` tokens per decode row in one
    forward (the row's last token and its ``k`` drafts), through the same
    per-token paged attention as :func:`paged_chunk_prefill` with
    ``[B = max_batch, W = k + 1]`` rows. Rejected drafts' K/V stay at
    positions ``>= kv_len``, which every read gates out, until the next
    verify rewrites them. Returns (logits [B, W, Vpad], caches)."""
    paged = {"dest": dest, "token_tables": token_tables,
             "token_kv_len": token_kv_len}
    return forward(cfg, params, ctx, tokens=tokens, caches=caches,
                   positions=positions, paged=paged)[:2]


def paged_decode_step(cfg, params: LM, ctx: Ctx, token, caches, block_tables,
                      kv_len):
    """One decode step over the paged cache. token [B], block_tables
    [B, T], kv_len [B] int32 (current lengths: the new token lands at
    position kv_len; the engine increments it host-side).
    → (logits [B, Vpad], caches)."""
    ctx = dataclasses.replace(ctx, decode=True)
    logits, caches, _ = forward(
        cfg, params, ctx, tokens=token[:, None], caches=caches,
        positions=kv_len[:, None],
        paged={"block_tables": block_tables, "kv_len": kv_len})
    return logits[:, 0], caches
