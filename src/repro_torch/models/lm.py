"""The decoder LM of the port (counterpart of ``repro.models.lm``): the dense
attention-only family, the hybrid one (recurrentgemma: RG-LRU blocks and
local attention blocks in ``cfg.block_pattern``, cycled over the layers) and
the MoE one (``cfg.moe``: every layer's FFN a mixture of experts,
``models/moe.py``).

The JAX package scans stacked superblock params; here the layers are an
``nn.ModuleList`` walked by a plain loop, layer ``i`` of kind
``block_pattern[i % period]``, with the same per-layer dropout seed offset
``i * 1000003`` (the sum wraps to int32, as JAX's does). With ``cfg.remat``
and autograd on, each layer runs under ``torch.utils.checkpoint`` (JAX
remats per superblock): only the layer inputs are kept, and the backward
recomputes the layer, attention kernel included. Serving caches are a list
of per-layer dicts: K/V (a ring of ``window`` slots, or page pools) for
attention layers, state rows ``{"h", "conv"}`` for recurrent ones. MoE
layers report ``moe_aux`` (summed over the layers) and ``moe_dropped``
(averaged) as JAX's forward does, in a forward without caches; the serving
steps, which drop them, do not compute them.

Public entry points:
  init_params(cfg, seed=, device=)                 → LM (random weights)
  forward(cfg, params, ctx, tokens=, caches=, ...) → (logits, caches, metrics)
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
from repro_torch.models import layers, moe, rglru
from repro_torch.models.layers import Ctx

#: the block kinds of ``cfg.block_pattern`` the port runs
KINDS = ("attn", "rec")
#: the weight of an MoE arch's load-balance loss in the training loss
#: (JAX ``loss_fn``'s default, the value every JAX caller uses)
MOE_AUX_WEIGHT = 0.01


def block_kinds(cfg) -> List[str]:
    """Each layer's kind: ``block_pattern`` cycled over the layers."""
    period = len(cfg.block_pattern)
    return [cfg.block_pattern[i % period] for i in range(cfg.num_layers)]


class Block(nn.Module):
    """One pre-norm block, a mixer (attention, or the RG-LRU for ``kind``
    "rec") and a gated MLP, or a :class:`~repro_torch.models.moe.MoE` when
    ``cfg.moe`` is set (JAX ``_init_block``'s leaves)."""

    def __init__(self, cfg, kind: str, dtype, device):
        super().__init__()
        self.kind = kind
        self.norm1 = layers._param((cfg.d_model,), dtype, device)
        self.mixer = (layers.Attention(cfg, dtype, device) if kind == "attn"
                      else rglru.RGLRU(cfg, dtype, device))
        self.norm2 = layers._param((cfg.d_model,), dtype, device)
        self.mlp = (moe.MoE(cfg, dtype, device) if cfg.moe is not None
                    else layers.MLP(cfg.d_model, cfg.d_ff, dtype, device))


class LM(nn.Module):
    """Parameters of the decoder: ``embed [Vpad, d]``, ``blocks``,
    ``final_norm [d]`` and ``lm_head [d, Vpad]``, allocated uninitialised
    on ``device``; :func:`init_params` or ``convert.convert_params`` fill them."""

    def __init__(self, cfg, vocab_padded: int, *, device, dtype=None):
        super().__init__()
        if (cfg.family not in ("dense", "hybrid", "moe")
                or (cfg.family == "moe") != (cfg.moe is not None)
                or cfg.frontend is not None or cfg.mlp_type != "gated_silu"
                or not set(cfg.block_pattern) <= set(KINDS)
                or ("rec" in cfg.block_pattern) != (cfg.rglru is not None)):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not yet ported to "
                f"repro_torch (dense, RG-LRU hybrid and MoE archs only)")
        dtype = dtype or cfg.dtype
        self.embed = layers._param((vocab_padded, cfg.d_model), dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, kind, dtype, device)
                                    for kind in block_kinds(cfg))
        self.final_norm = layers._param((cfg.d_model,), dtype, device)
        self.lm_head = layers._param((cfg.d_model, vocab_padded), dtype, device)


@torch.no_grad()
def init_params(cfg, *, seed: int = 0, device="cuda") -> LM:
    """Random weights with the JAX package's shapes and scales (normal ·
    d_in**-0.5 matrices, 0.02 embedding, unit norms), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``. The draws differ
    from JAX's; ``convert.convert_params`` carries JAX weights over."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = LM(cfg, cfg.vocab_size, device=device)
    for blk in model.blocks:
        blk.norm1.fill_(1.0)
        blk.norm2.fill_(1.0)
        blk.mixer = (layers.init_attention(gen, cfg, cfg.dtype)
                     if blk.kind == "attn"
                     else rglru.init_rglru(gen, cfg, cfg.dtype))
        blk.mlp = (moe.init_moe(gen, cfg, cfg.dtype) if cfg.moe is not None
                   else layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype))
    model.embed.copy_(layers.dense_init(gen, cfg.vocab_size, cfg.d_model,
                                        cfg.dtype, scale=0.02))
    model.final_norm.fill_(1.0)
    model.lm_head.copy_(layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                          cfg.dtype))
    return model


def _apply_block(p: Block, x, ctx: Ctx, cfg, *, positions, cache, layer_seed,
                 segment_ids=None, paged=None):
    """→ (x, new_cache, metrics: the MoE's without a cache, or {})."""
    h = layers.rms_norm(x, p.norm1)
    if p.kind == "attn":
        mixed, new_cache = layers.apply_attention(
            p.mixer, h, ctx, cfg, positions=positions, cache=cache,
            layer_seed=layer_seed, segment_ids=segment_ids, paged=paged)
    else:
        # the recurrence carries state across a whole row whatever its
        # segments (packing is an attention-family feature, as in JAX)
        mixed, new_cache = rglru.apply_rglru(p.mixer, h, ctx, cfg, cache=cache,
                                             positions=positions, paged=paged)
    x = x + mixed
    h = layers.rms_norm(x, p.norm2)
    if cfg.moe is not None:
        out, metrics = moe.apply_moe(p.mlp, h, ctx, cfg,
                                     metrics=cache is None)
        return x + out, new_cache, metrics
    return x + layers.apply_mlp(p.mlp, h), new_cache, {}


def _train_block(p: Block, x, ctx: Ctx, cfg, positions, segment_ids,
                 layer_seed: int):
    """One layer without a cache: what ``checkpoint`` recomputes.
    → (x, metrics)."""
    x, _, metrics = _apply_block(p, x, ctx, cfg, positions=positions,
                                 cache=None, layer_seed=layer_seed,
                                 segment_ids=segment_ids)
    return x, metrics


def forward(cfg, params: LM, ctx: Ctx, *, tokens, caches=None,
            positions=None, segment_ids=None, paged=None):
    """tokens [B, S] int → (logits [B, S, Vpad], new_caches or None,
    metrics): metrics are {"moe_aux": sum over the layers, "moe_dropped":
    mean over the layers} for MoE archs without caches, {} otherwise.

    positions: [B, S] or [S] RoPE positions (default ``arange(S)``).
    segment_ids [B, S]: packed-batch ids (int32); attention masks
    cross-segment pairs — pass per-segment ``positions`` alongside.
    paged: the routing of paged caches, passed to every layer
    (``layers.apply_attention``, ``rglru.apply_rglru``).
    """
    x = params.embed[tokens]
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    new_caches: Optional[List[dict]] = None if caches is None else []
    layer_metrics = []
    for i, blk in enumerate(params.blocks):
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
    x = layers.rms_norm(x, params.final_norm)
    return x @ params.lm_head, new_caches, metrics


def loss_fn(cfg, params: LM, batch, ctx: Ctx):
    """batch: {"tokens", "labels"} [B, S] (+ optional "segment_ids",
    "positions" for packed batches), tensors on the params' device.
    Next-token CE for causal LMs, per-position CE for encoders; a packed
    batch gives no weight to a segment's last token (it must not predict
    the next segment) or to padding. MoE archs add ``MOE_AUX_WEIGHT ·
    moe_aux``. Returns (loss, {"ce", "loss"} and the forward's metrics)."""
    seg = batch.get("segment_ids")
    logits, _, metrics = forward(cfg, params, ctx, tokens=batch["tokens"],
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
    ce = layers.softmax_cross_entropy(logits, labels, cfg.vocab_size,
                                      weights=weights)
    loss = ce
    if cfg.moe is not None:
        loss = loss + MOE_AUX_WEIGHT * metrics["moe_aux"]
    return loss, dict(metrics, ce=ce, loss=loss)


def init_cache(cfg, batch: int, max_len: int, dtype=None, *, device="cuda"):
    """Per-layer contiguous caches: KV for attention layers (sliding-window
    archs keep only ``window`` slots), zero state rows for recurrent ones."""
    dtype = dtype or cfg.dtype
    eff = max_len if cfg.attn_window is None else min(max_len, cfg.attn_window)
    return [layers.init_attn_cache(cfg, batch, eff, dtype, device)
            if kind == "attn" else rglru.init_rglru_cache(cfg, batch, device)
            for kind in block_kinds(cfg)]


def prefill(cfg, params: LM, ctx: Ctx, tokens, caches):
    """Run the full prompt, filling the caches in place. Returns
    (last-position logits [B, Vpad], caches)."""
    logits, caches, _ = forward(cfg, params, ctx, tokens=tokens, caches=caches)
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

def init_paged_cache(cfg, paged_cfg, dtype=None, *, device="cuda", mesh=None):
    """Per-layer serving caches: attention layers get page pools
    ``{"k_pages", "v_pages"}`` [Hkv, num_pages, page_size, D] (no batch dim:
    sequences share the pool through block tables; host-side page lifecycle
    in ``serving/paged_cache.py``); with a pool ``mesh`` they are this
    rank's shard, [Hkv, num_pages / N, page_size, D]. Recurrent layers get
    per-slot state rows ``{"h", "conv"}`` [max_batch + 1, ...]: slot i backs
    decode slot i, and the trailing trash row absorbs padding tokens'
    gathers and scatters (host-side slot lifecycle in
    ``serving/state_cache.py``). The recurrent rows over a mesh are not yet
    ported."""
    kinds = block_kinds(cfg)
    if mesh is not None and "rec" in kinds:
        raise NotImplementedError(
            f"{cfg.name}: serving recurrent blocks over a pool mesh is not "
            f"yet ported")
    dtype = dtype or cfg.dtype
    n = 1 if mesh is None else mesh.size
    local = pages_per_shard(paged_cfg.num_pages, n) if n > 1 else None
    return [layers.init_paged_attn_cache(cfg, paged_cfg, dtype, device, local)
            if kind == "attn"
            else rglru.init_rglru_cache(cfg, paged_cfg.max_batch + 1, device)
            for kind in kinds]


def paged_prefill(cfg, params: LM, ctx: Ctx, tokens, segment_ids, positions,
                  dest, caches, state_slots=None):
    """Segment-aware packed prefill: many prompts in one forward.

    tokens/segment_ids/positions [B, S] (prompts packed along S, -1 = pad,
    per-prompt positions from 0); dest [B, S] flat page-pool token slots
    (``BlockTables.prefill_dest``). Fills the pools in place. Returns
    (logits [B, S, Vpad], caches); the engine reads each prompt's last row.
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
                   paged=paged)[:2]


def paged_chunk_prefill(cfg, params: LM, ctx: Ctx, tokens, positions, dest,
                        token_tables, token_kv_len, caches, state_slots=None,
                        state_local=None):
    """Chunked / suffix packed prefill: prompt spans whose earlier tokens
    already live in pages (prefix-cache hits, earlier chunks).

    tokens/positions [B, S] with global per-token positions; dest [B, S]
    flat pool slots (``BlockTables.span_dest``, padding → trash);
    token_tables [B, S, T] each token's block-table row; token_kv_len
    [B, S] = position + 1 for real tokens, 0 for padding. Each layer
    scatters the span's K/V first, then every token attends through its own
    table row. Returns (logits [B, S, Vpad], caches). state_slots /
    state_local [B, S] (recurrent archs): each token's decode slot (-1
    padding) and offset in its span; a span whose global start (position -
    local) is past 0 resumes the slot's stored state.
    """
    paged = {"dest": dest, "token_tables": token_tables,
             "token_kv_len": token_kv_len}
    if state_slots is not None:
        paged.update(state_slots=state_slots, state_local=state_local)
    return forward(cfg, params, ctx, tokens=tokens, caches=caches,
                   positions=positions, paged=paged)[:2]


def paged_verify_step(cfg, params: LM, ctx: Ctx, tokens, positions, dest,
                      token_tables, token_kv_len, caches):
    """Speculative verify: score ``k + 1`` tokens per decode row in one
    forward (the row's last token and its ``k`` drafts), through the same
    per-token paged attention as :func:`paged_chunk_prefill` with
    ``[B = max_batch, W = k + 1]`` rows. Rejected drafts' K/V stay at
    positions ``>= kv_len``, which every read gates out, until the next
    verify rewrites them. Returns (logits [B, W, Vpad], caches)."""
    return paged_chunk_prefill(cfg, params, ctx, tokens, positions, dest,
                               token_tables, token_kv_len, caches)


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
