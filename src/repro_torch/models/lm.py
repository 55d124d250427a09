"""The decoder LM of the port (counterpart of ``repro.models.lm``), dense
attention-only family.

The JAX package scans stacked superblock params; here the layers are an
``nn.ModuleList`` walked by a plain loop, with the same per-layer dropout
seed offset ``i * 1000003`` (the sum wraps to int32, as JAX's does). With
``cfg.remat`` and autograd on, each layer runs under
``torch.utils.checkpoint`` (JAX remats per superblock, and a superblock of
an attention-only arch is one layer): only the layer inputs are kept, and
the backward recomputes the layer, attention kernel included. Serving caches
are a list of per-layer dicts.

Public entry points:
  init_params(cfg, seed=, device=)                 → LM (random weights)
  forward(cfg, params, ctx, tokens=, caches=, ...) → (logits, caches)
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

from repro_torch.models import layers
from repro_torch.models.layers import Ctx


class Block(nn.Module):
    """One pre-norm attention + gated-MLP block (JAX ``_init_block``'s leaves)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.norm1 = layers._param((cfg.d_model,), dtype, device)
        self.mixer = layers.Attention(cfg, dtype, device)
        self.norm2 = layers._param((cfg.d_model,), dtype, device)
        self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dtype, device)


class LM(nn.Module):
    """Parameters of the decoder: ``embed [Vpad, d]``, ``blocks``,
    ``final_norm [d]`` and ``lm_head [d, Vpad]``, allocated uninitialised
    on ``device``; :func:`init_params` or ``convert.convert_params`` fill them."""

    def __init__(self, cfg, vocab_padded: int, *, device, dtype=None):
        super().__init__()
        if (cfg.family != "dense" or cfg.moe is not None
                or cfg.frontend is not None or cfg.mlp_type != "gated_silu"
                or set(cfg.block_pattern) != {"attn"}):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not yet ported to "
                f"repro_torch (dense attention-only archs only)")
        dtype = dtype or cfg.dtype
        self.embed = layers._param((vocab_padded, cfg.d_model), dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
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
        blk.mixer = layers.init_attention(gen, cfg, cfg.dtype)
        blk.mlp = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype)
    model.embed.copy_(layers.dense_init(gen, cfg.vocab_size, cfg.d_model,
                                        cfg.dtype, scale=0.02))
    model.final_norm.fill_(1.0)
    model.lm_head.copy_(layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                          cfg.dtype))
    return model


def _apply_block(p: Block, x, ctx: Ctx, cfg, *, positions, cache, layer_seed,
                 segment_ids=None, paged=None):
    h = layers.rms_norm(x, p.norm1)
    mixed, new_cache = layers.apply_attention(
        p.mixer, h, ctx, cfg, positions=positions, cache=cache,
        layer_seed=layer_seed, segment_ids=segment_ids, paged=paged)
    x = x + mixed
    return x + layers.apply_mlp(p.mlp, layers.rms_norm(x, p.norm2)), new_cache


def _train_block(p: Block, x, ctx: Ctx, cfg, positions, segment_ids,
                 layer_seed: int):
    """One layer without a cache: what ``checkpoint`` recomputes."""
    return _apply_block(p, x, ctx, cfg, positions=positions, cache=None,
                        layer_seed=layer_seed, segment_ids=segment_ids)[0]


def forward(cfg, params: LM, ctx: Ctx, *, tokens, caches=None,
            positions=None, segment_ids=None, paged=None):
    """tokens [B, S] int → (logits [B, S, Vpad], new_caches or None).

    positions: [B, S] or [S] RoPE positions (default ``arange(S)``).
    segment_ids [B, S]: packed-batch ids (int32); attention masks
    cross-segment pairs — pass per-segment ``positions`` alongside.
    paged: the routing of paged caches, passed to every attention layer
    (``layers.apply_attention``).
    """
    x = params.embed[tokens]
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    new_caches: Optional[List[dict]] = None if caches is None else []
    for i, blk in enumerate(params.blocks):
        if remat:
            x = checkpoint(_train_block, blk, x, ctx, cfg, positions,
                           segment_ids, i * 1000003, use_reentrant=False)
            continue
        x, nc = _apply_block(blk, x, ctx, cfg, positions=positions,
                             cache=None if caches is None else caches[i],
                             layer_seed=i * 1000003, segment_ids=segment_ids,
                             paged=paged)
        if new_caches is not None:
            new_caches.append(nc)
    x = layers.rms_norm(x, params.final_norm)
    return x @ params.lm_head, new_caches


def loss_fn(cfg, params: LM, batch, ctx: Ctx):
    """batch: {"tokens", "labels"} [B, S] (+ optional "segment_ids",
    "positions" for packed batches), tensors on the params' device.
    Next-token CE for causal LMs, per-position CE for encoders; a packed
    batch gives no weight to a segment's last token (it must not predict
    the next segment) or to padding. Returns (loss, {"ce", "loss"})."""
    seg = batch.get("segment_ids")
    logits, _ = forward(cfg, params, ctx, tokens=batch["tokens"],
                        positions=batch.get("positions"), segment_ids=seg)
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
    return ce, {"ce": ce, "loss": ce}


def init_cache(cfg, batch: int, max_len: int, dtype=None, *, device="cuda"):
    """Per-layer contiguous KV caches (sliding-window archs keep only
    ``window`` slots)."""
    dtype = dtype or cfg.dtype
    eff = max_len if cfg.attn_window is None else min(max_len, cfg.attn_window)
    return [layers.init_attn_cache(cfg, batch, eff, dtype, device)
            for _ in range(cfg.num_layers)]


def prefill(cfg, params: LM, ctx: Ctx, tokens, caches):
    """Run the full prompt, filling the caches in place. Returns
    (last-position logits [B, Vpad], caches)."""
    logits, caches = forward(cfg, params, ctx, tokens=tokens, caches=caches)
    return logits[:, -1], caches


def decode_step(cfg, params: LM, ctx: Ctx, token, caches, position: int):
    """One autoregressive step. token [B] int → (logits [B, Vpad], caches);
    the caches are updated in place."""
    ctx = dataclasses.replace(ctx, decode=True)
    positions = torch.full((token.shape[0], 1), position, dtype=torch.int32,
                           device=token.device)
    logits, caches = forward(cfg, params, ctx, tokens=token[:, None],
                             caches=caches, positions=positions)
    return logits[:, 0], caches


# ---------------------------------------------------------------------------
# paged serving: page-pool cache / packed prefill / block-table decode
# ---------------------------------------------------------------------------

def init_paged_cache(cfg, paged_cfg, dtype=None, *, device="cuda"):
    """Per-layer page pools ``{"k_pages", "v_pages"}`` [Hkv, num_pages,
    page_size, D] (no batch dim: sequences share the pool through block
    tables; host-side page lifecycle in ``serving/paged_cache.py``). The
    recurrent families' per-slot state rows are not yet ported."""
    if set(cfg.block_pattern) != {"attn"}:
        raise NotImplementedError(
            f"{cfg.name}: paged serving of recurrent blocks is not yet ported")
    dtype = dtype or cfg.dtype
    return [layers.init_paged_attn_cache(cfg, paged_cfg, dtype, device)
            for _ in range(cfg.num_layers)]


def paged_prefill(cfg, params: LM, ctx: Ctx, tokens, segment_ids, positions,
                  dest, caches, state_slots=None):
    """Segment-aware packed prefill: many prompts in one forward.

    tokens/segment_ids/positions [B, S] (prompts packed along S, -1 = pad,
    per-prompt positions from 0); dest [B, S] flat page-pool token slots
    (``BlockTables.prefill_dest``). Fills the pools in place. Returns
    (logits [B, S, Vpad], caches); the engine reads each prompt's last row.
    state_slots (the recurrent families' per-slot routing, JAX's signature)
    is unused by the attention-only archs.
    """
    return forward(cfg, params, ctx, tokens=tokens, caches=caches,
                   positions=positions, segment_ids=segment_ids,
                   paged={"dest": dest})


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
    state_local are unused by the attention-only archs, as in
    :func:`paged_prefill`.
    """
    return forward(cfg, params, ctx, tokens=tokens, caches=caches,
                   positions=positions,
                   paged={"dest": dest, "token_tables": token_tables,
                          "token_kv_len": token_kv_len})


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
    logits, caches = forward(
        cfg, params, ctx, tokens=token[:, None], caches=caches,
        positions=kv_len[:, None],
        paged={"block_tables": block_tables, "kv_len": kv_len})
    return logits[:, 0], caches
