"""Model building blocks of the port (counterpart of ``repro.models.layers``).

Parameters live in ``nn.Module``s as plain ``nn.Parameter``s in the JAX
orientation ``[d_in, d_out]``, applied as ``x @ w``, so weights carry over
from the JAX package by a plain unstack. The ``apply_*`` functions take the
module holding the parameters, as the JAX functions take the param pytree.
Parameters are trainable (``requires_grad``); the initialisers fill them
under ``torch.no_grad``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.attention import (spark_attention, spark_decode,
                                       spark_decode_partials,
                                       spark_paged_decode)
from repro_torch.core.online_softmax import NEG_INF
from repro_torch.distributed import paged as dpaged
from repro_torch.kernels import rng


@dataclasses.dataclass
class Ctx:
    """Per-call context: attention impl, mode flags, dropout seed and the
    shard plan of a mesh (training or serving)."""
    impl: str = "kernel"             # attention impl (core.attention.IMPLS)
    deterministic: bool = True       # disables dropout
    seed: int = 0                    # dropout seed (an int32 value)
    decode: bool = False             # single-token decode step
    torch_chunk: int = 1024          # KV chunk of impl="torch"
    num_splits: int = 1              # split-KV decode slices per (B, Hkv) row
    acc_dtype: Any = torch.float32   # forward product rounding (bf16-ACC)
    bwd_acc_dtype: Any = torch.float32   # backward product rounding
    plan: Any = None                 # distributed.parallel.ShardPlan: the
                                     # params are a mesh rank's shards
    seq: bool = False                # the residual stream holds this rank's
                                     # rows (ShardPlan.seq_rows; lm.forward)


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """``N(0, 1) · d_in**-0.5`` weights ``[d_in, d_out]`` drawn in f32 on the
    generator's device, then cast to ``dtype``."""
    scale = (d_in ** -0.5) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


@torch.no_grad()
def fill_(module: nn.Module, draws, keep=None) -> nn.Module:
    """Fill ``module``'s parameters from ``draws``, (name, full tensor)
    pairs made one at a time in the initialiser's order, each cast to its
    parameter's dtype. ``keep(name, full) → tensor`` (a module built on
    "meta"): each parameter becomes what ``keep`` returns for its full
    tensor, which is dropped before the next is made."""
    for name, full in draws:
        w = module.get_parameter(name)
        full = full.to(w.dtype)
        if keep is None:
            w.copy_(full)
        else:
            mod, _, attr = name.rpartition(".")
            setattr(module.get_submodule(mod) if mod else module, attr,
                    nn.Parameter(keep(name, full)))
        del full
    return module


@torch.no_grad()
def init_dense_(module: nn.Module, gen: torch.Generator,
                keep=None) -> nn.Module:
    """Fill every parameter in place: norm weights (1-D) with ones, matrices
    ``[d_in, d_out]`` with :func:`dense_init` (``keep``: as
    :func:`fill_`'s)."""
    def draw(w):
        if w.dim() == 1:
            return torch.ones(w.shape, dtype=w.dtype, device=gen.device)
        return dense_init(gen, w.shape[0], w.shape[1], w.dtype)

    return fill_(module, ((name, draw(w)) for name, w in
                          list(module.named_parameters())), keep)


# ---------------------------------------------------------------------------
# primitive ops
# ---------------------------------------------------------------------------

def weight(ctx: Optional[Ctx], w, key: str):
    """Parameter ``w`` (named ``key`` in its block, a mixer's leaf with the
    block's kind, as ``attn:mixer.wq`` or ``mlp.wi``, or at the top, as
    ``embed``) as the layer computes with it: itself on one device, the
    shard plan's view of it on a training mesh."""
    return w if ctx is None or ctx.plan is None else ctx.plan.weight(w, key)


def kv_weight(ctx: Ctx, w, key: str):
    """``wk``/``wv`` as :func:`weight` gives them, cut on a training mesh
    to the columns of the kv heads this rank's q heads read."""
    return w if ctx.plan is None else ctx.plan.kv_weight(w, key)


def rms_norm(x, w, eps: float = 1e-6):
    """RMSNorm over the last dim, computed in f32, returned in x.dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rope(x, positions, *, base: float = 10000.0):
    """Rotary embedding. x: [B, S, H, D] (D even), positions: [B, S] or [S]."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions.float()[:, :, None] * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]          # [B, S, 1, half]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softmax_cross_entropy(logits, labels, vocab_size: int, weights=None):
    """Mean CE over positions. logits [B,S,V] (V may be padded), labels [B,S].

    Vocab padding (columns ≥ ``vocab_size``) is masked to ``NEG_INF``.
    weights: optional [B,S] per-position weights — a weighted mean over
    positions (packed batches mask segment boundaries)."""
    logits = logits.float()
    if logits.shape[-1] > vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = lse - gold
    if weights is None:
        return ce.mean()
    w = weights.float()
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


# ---------------------------------------------------------------------------
# MLP (dense FFN)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Dense FFN weights: gated-SiLU ``wi [d_model, 2·d_ff]`` (gate | up),
    or ungated GELU ``wi [d_model, d_ff]`` (the encoder family's
    ``mlp_type`` "gelu"), and ``wo [d_ff, d_model]``."""

    def __init__(self, d_model: int, d_ff: int, dtype, device,
                 gated: bool = True):
        super().__init__()
        self.gated = gated
        self.wi = _param((d_model, (2 if gated else 1) * d_ff), dtype, device)
        self.wo = _param((d_ff, d_model), dtype, device)


def init_mlp(gen, d_model, d_ff, dtype, gated: bool = True,
             keep=None) -> MLP:
    """An :class:`MLP` with ``dense_init`` weights on the generator's device
    (``keep``: as :func:`init_dense_`'s)."""
    device = gen.device if keep is None else "meta"
    return init_dense_(MLP(d_model, d_ff, dtype, device, gated), gen, keep)


def apply_mlp(p: MLP, x, ctx: Optional[Ctx] = None, key: str = "mlp."):
    """Gated-SiLU FFN ``(silu(x @ wi_gate) * (x @ wi_up)) @ wo``, or the
    ungated ``gelu(x @ wi) @ wo`` with GELU's tanh form, which is
    ``jax.nn.gelu``'s default. On a training mesh whose ``model`` axis
    splits the FFN, ``wi`` holds this rank's slice of each half and the
    partial ``@ wo`` is summed over ``model``: under ``ctx.seq`` the rows
    are gathered before ``wi`` and the sum reduce-scattered to the rank's
    rows; an FFN that ``model`` does not split runs on the rank's rows.
    ``key``: the leaves' prefix in the block (``mlp.shared.`` for the MoE's
    shared experts)."""
    plan = None if ctx is None else ctx.plan
    split = plan is not None and plan.splits(key + "wi", 1)
    if split:
        x = plan.enter(x, True, ctx.seq)
    h = x @ weight(ctx, p.wi, key + "wi")
    if p.gated:
        g, u = h.chunk(2, dim=-1)
        h = F.silu(g) * u
    else:
        h = F.gelu(h, approximate="tanh")
    out = h @ weight(ctx, p.wo, key + "wo")
    return plan.leave(out, True, ctx.seq) if split else out


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Attention weights ``wq/wk/wv [d, H·hd]``, ``wo [Hq·hd, d]`` and, for
    qk-norm archs, ``q_norm``/``k_norm [hd]``."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.wq = _param((d, hq * hd), dtype, device)
        self.wk = _param((d, hkv * hd), dtype, device)
        self.wv = _param((d, hkv * hd), dtype, device)
        self.wo = _param((hq * hd, d), dtype, device)
        if cfg.qk_norm:
            self.q_norm = _param((hd,), dtype, device)
            self.k_norm = _param((hd,), dtype, device)


def paged_decode_window(cfg) -> Optional[int]:
    """The sliding window the *paged* attention masks with (None = full
    attention). One source for the attention below and the serving engine's
    out-of-window page reclamation: the engine frees exactly the pages whose
    every position this mask excludes, so the two must agree. (The
    contiguous decode keeps a ring of ``window`` slots instead and needs no
    mask.)"""
    return cfg.attn_window


def init_attention(gen, cfg, dtype, keep=None) -> Attention:
    """An :class:`Attention` with ``dense_init`` weights and unit norms
    (``keep``: as :func:`init_dense_`'s)."""
    device = gen.device if keep is None else "meta"
    return init_dense_(Attention(cfg, dtype, device), gen, keep)


def init_attn_cache(cfg, batch: int, max_len: int, dtype, device,
                    kv_heads: Optional[int] = None):
    """One layer's contiguous cache: k/v [B, Hkv, max_len, D] zeros and the
    host-side write index (``kv_heads`` in place of Hkv: a mesh rank's
    share of them)."""
    shape = (batch, kv_heads or cfg.num_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def init_paged_attn_cache(cfg, paged_cfg, dtype, device, num_pages=None):
    """One layer's page pool: k_pages/v_pages [Hkv, num_pages, page_size, D]
    zeros, shared by all sequences (page 0 is the trash page, see
    ``serving/paged_cache.py``). ``num_pages`` (default the config's) is a
    shard's page count when the pool is sharded."""
    shape = (cfg.num_kv_heads, num_pages or paged_cfg.num_pages,
             paged_cfg.page_size, cfg.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def _scatter_pages(pages, dest, vals):
    """Write token rows into the page pool in place. pages [Hkv, P, ps, D];
    dest [N] flat token slots ``page * ps + offset`` (duplicates only ever
    target the trash page); vals [Hkv, N, D]."""
    hkv, n_pages, ps, d = pages.shape
    pages.view(hkv, n_pages * ps, d)[:, dest.long()] = vals.to(pages.dtype)


def apply_attention(p: Attention, x, ctx: Ctx, cfg, *, positions=None,
                    cache=None, layer_seed: int = 0, segment_ids=None,
                    paged=None):
    """x: [B, S, d]. Returns (out, new_cache).

    segment_ids [B, S]: packed-batch ids (training, and packed prefill into a
    paged cache) — attention stays within a segment; pair them with
    per-segment ``positions`` so RoPE restarts at each packed sequence.

    cache: a contiguous cache dict (k/v [B, Hkv, S_max, D], int ``index``) or
    a paged one (k_pages/v_pages [Hkv, P, page_size, D], a pool shared by
    all sequences). Unlike the JAX version, which returns new arrays, the
    cache's tensors are updated **in place** and the returned dict shares
    them.

    paged: the routing of a paged cache —
      decode: {"block_tables": [B, T], "kv_len": [B]};
      packed prefill: {"dest": [B, S]} flat pool slots per token (padding →
      the trash page);
      chunked/suffix prefill and speculative verify add {"token_tables":
      [B, S, T], "token_kv_len": [B, S]}: each token then attends through
      its own block-table row (history pages and same-row predecessors)
      instead of the in-row segment mask; positions are global per token.

    * decode (``ctx.decode``): append this token at slot ``index`` (sliding-
      window archs use the cache as a ring of ``window`` slots, so no window
      mask is needed), then flash-decode over ``kv_len = min(index+1, cap)``.
    * prefill (cache given, not decode): fill the cache from position 0 — a
      windowed ring keeps the last ``cap`` tokens by slot — then fused
      attention over the prompt.
    * on a mesh (``ctx.plan``): this rank's q heads (all of them where
      ``model`` does not split the heads) and the kv heads they read, the
      kernel told the global coordinates of its first batch row and q head
      (dropout draws the single-device masks), ``wo`` row-parallel and
      summed over ``model``. Serving: a cache whose kv heads split holds the
      rank's; one whose kv heads do not (``plan.kv_seq``) holds every kv
      head on the rank's ``cap / model`` slots (``cache["shards"]``):
      prefill writes the rank's range of the ring, decode gathers q over
      ``model`` (every head), writes the new token's K/V on the rank that
      owns slot ``index % cap``, attends over the rank's slots
      (``spark_decode_partials``, its count of valid slots
      ``clamp(min(index + 1, cap) - r·cap/M, 0, cap/M)``) and merges the
      partials over ``model``; ``wo`` then takes the rank's heads' columns.
    * under ``ctx.seq`` (``x`` this rank's rows of the residual stream,
      ``positions`` and ``segment_ids`` the whole sequence's): heads split
      over ``model`` gather the rows before ``wq/wk/wv`` and reduce-scatter
      ``wo``'s partial sums to the rank's rows; heads that ``model`` does
      not split, under ``plan.ctx`` (``seq_full``), compute every head for
      the rank's query rows ``[a, b)`` (RoPE at their global positions),
      gather K/V over ``model`` (a cache is filled from the gathered K/V)
      and attend against K/V cut to ``[0, b)``, q their suffix, so the
      masks and the dropout hash see global positions; ``wo`` then gives
      the rank's rows with no sum. Without ``seq_full`` such heads run on
      the gathered rows, replicated, and keep the rank's rows.
    """
    plan = ctx.plan
    # context parallel (seq_full): every head on this rank's query rows
    rows = plan is not None and ctx.seq and plan.ctx
    if plan is not None and not rows:
        x = plan.enter(x, plan.heads, ctx.seq)
    b, s, _ = x.shape
    hd = cfg.head_dim
    if positions is None:
        positions = torch.arange(s * plan.mesh.size("model") if rows else s,
                                 device=x.device)
    pos = plan.seq_part(positions, positions.dim() - 1) if rows else positions
    pool = cache is not None and "k_pages" in cache
    # serving on a mesh: a page pool, and a contiguous cache whose kv heads
    # do not split, hold every kv head; decode over either (and the pool's
    # chunk and verify rows) attends with every q head
    every_kv = plan is not None and cache is not None and (pool or not plan.kv)
    every_q = plan is not None and cache is not None and (
        (pool and (ctx.decode or "token_tables" in (paged or {})))
        or (ctx.decode and not plan.kv))
    q = x @ weight(ctx, p.wq, "attn:mixer.wq")
    if every_kv and not plan.kv:
        k = x @ weight(ctx, p.wk, "attn:mixer.wk")
        v = x @ weight(ctx, p.wv, "attn:mixer.wv")
    else:
        k = x @ kv_weight(ctx, p.wk, "attn:mixer.wk")
        v = x @ kv_weight(ctx, p.wv, "attn:mixer.wv")
    if every_q and plan.heads:
        q = plan.gather_model(q)
    if every_kv and plan.kv:
        k, v = plan.gather_model(k), plan.gather_model(v)
    q, k, v = (t.view(b, s, -1, hd) for t in (q, k, v))
    if cfg.qk_norm:
        q = rms_norm(q, weight(ctx, p.q_norm, "attn:mixer.q_norm"))
        k = rms_norm(k, weight(ctx, p.k_norm, "attn:mixer.k_norm"))
    q = rope(q, pos).transpose(1, 2)
    k = rope(k, pos).transpose(1, 2)
    v = v.transpose(1, 2)
    if rows:                   # every rank's K/V rows: the whole sequence's
        k, v = plan.gather_seq(torch.stack([k, v]), 3).unbind(0)
    if plan is not None and not ctx.decode:
        plan.log_rows("query", s)

    def project_out(o):
        """o [B, S, H·D] (every head where ``every_q``) → ``@ wo``."""
        if every_q:
            o = plan.own_heads(o)
        out = o @ weight(ctx, p.wo, "attn:mixer.wo")
        if plan is None or rows:
            return out
        return plan.leave(out, plan.heads, ctx.seq)

    if pool:
        o = _apply_paged(q, k, v, ctx, cfg, cache, paged, segment_ids,
                         every_q, rows)
        return project_out(o.reshape(b, s, -1)), cache
    new_cache = None
    if ctx.decode:
        if s != 1 or cache is None or segment_ids is not None:
            raise ValueError("decode takes one token per row, a cache and "
                             "no segment ids")
        idx = cache["index"]
        ck, cv = cache["k"], cache["v"]
        local, cap, lo = _ring_range(cache, plan)
        slot = idx % cap if cfg.attn_window is not None else idx
        if slot >= cap:
            raise ValueError(f"cache full: position {idx} >= max_len {cap}")
        if lo <= slot < lo + local:
            ck[:, :, slot - lo] = k[:, :, 0].to(ck.dtype)
            cv[:, :, slot - lo] = v[:, :, 0].to(cv.dtype)
        n = min(max(min(idx + 1, cap) - lo, 0), local)
        kv_len = torch.full((b,), n, dtype=torch.int32, device=x.device)
        if local < cap:
            acc, m, l = spark_decode_partials(q[:, :, 0], ck, cv, impl=ctx.impl,
                                              kv_len=kv_len,
                                              num_splits=ctx.num_splits)
            o = dpaged.merge_partials(acc, m, l, plan.mesh.pool,
                                      out_dtype=q.dtype)[:, :, None]
        else:
            o = spark_decode(q[:, :, 0], ck, cv, impl=ctx.impl, kv_len=kv_len,
                             window=None,
                             num_splits=ctx.num_splits)[:, :, None]
        new_cache = dict(cache, index=idx + 1)
    else:
        if cache is not None:
            if segment_ids is not None:
                raise ValueError("the contiguous cache stores no segments: "
                                 "packed prefill needs a paged cache")
            _fill_ring(cache, k, v, plan)
            new_cache = dict(cache, index=cache["index"] + k.shape[2])
            if every_kv:           # the kv heads this rank's q heads read
                k, v = plan.kv_heads_of(k), plan.kv_heads_of(v)
        if rows:                   # K/V up to the last query row: q a suffix
            k, v, segment_ids = _kv_upto(plan, k, v, segment_ids)
        drop = 0.0 if ctx.deterministic else cfg.dropout_rate
        o = spark_attention(q, k, v, impl=ctx.impl,
                            seed=rng.int32(ctx.seed + layer_seed),
                            causal=cfg.causal, window=cfg.attn_window,
                            dropout_rate=drop, segment_ids=segment_ids,
                            acc_dtype=ctx.acc_dtype,
                            bwd_acc_dtype=ctx.bwd_acc_dtype,
                            torch_chunk=ctx.torch_chunk,
                            batch_offset=0 if plan is None else plan.batch_offset(b),
                            head_offset=0 if plan is None else plan.head_offset)
    return project_out(o.transpose(1, 2).reshape(b, s, -1)), new_cache


def _kv_upto(plan, k, v, segment_ids):
    """k/v [B, Hkv, S, D] and segment ids [B, S] of the whole sequence cut
    to ``[0, b)``, b the end of this rank's query rows: the query rows are
    then their suffix (the kernels' ``q_offset = Skv - Sq`` is the rows'
    first position). Never cut at the front: the window and the dropout
    hash read key positions from ``k[0]``."""
    end = plan.seq_span(k.shape[2])[1]
    return (k[:, :, :end], v[:, :, :end],
            None if segment_ids is None else segment_ids[:, :end])


def _ring_range(cache, plan):
    """A contiguous cache's (slots held here, slots in all, the first slot
    held here): a cache sharded along its sequence (``cache["shards"]``)
    holds this rank's range of the ring, ``[r·cap/M, (r+1)·cap/M)``."""
    local = cache["k"].shape[2]
    shards = cache.get("shards", 1)
    lo = plan.mesh.index("model") * local if shards > 1 else 0
    return local, local * shards, lo


def _fill_ring(cache, k, v, plan) -> None:
    """Prefill's write of k/v [B, Hkv, S, D] into a contiguous cache from
    position 0, in place: a windowed ring keeps the last ``cap`` tokens by
    slot (position ``p`` at slot ``p % cap``), a sequence-sharded cache
    its range of them (:func:`_ring_range`)."""
    local, cap, lo = _ring_range(cache, plan)
    s = k.shape[2]
    for c, t in ((cache["k"], k), (cache["v"], v)):
        if s >= cap:       # windowed ring: keep the last `cap` tokens, by slot
            ring = torch.roll(t[:, :, s - cap:], (s - cap) % cap, dims=2)
            c.copy_(ring[:, :, lo:lo + local])
        else:
            n = min(max(s - lo, 0), local)
            c[:, :, :n] = t[:, :, lo:lo + n]


def _apply_paged(q, k, v, ctx: Ctx, cfg, cache, paged, segment_ids,
                 every_q: bool, rows: bool = False):
    """The paged branches of :func:`apply_attention` (q [B,Hq,S,D], k/v
    [B,Hkv,S,D] after RoPE), mirroring JAX's arms. Returns the attention
    output o [B, S, Hq, D] before ``wo``; the pool is updated in place.

    * decode: append this token's K/V at position ``kv_len`` (the slot the
      row's table names), then paged flash-decode over ``kv_len + 1``.
      Inactive slots carry the trash table and kv_len 0: their write lands
      in the trash page and their output is ignored by the engine.
    * packed prefill: scatter every token's K/V to its ``dest`` slot, then
      fused attention inside each segment.
    * chunked prefill / verify: scatter first, then each token is a decode
      row of its own (``token_tables``, ``token_kv_len`` = position + 1, 0
      for padding, which gives exact zeros): one paged-decode launch over
      B·S rows, told that they come S to a batch row (``row_tokens``), so
      the kernel folds each page once for the consecutive rows that share a
      table.

    On a serving mesh whose ``model`` axis has a process group
    (``TrainMesh.pool_shards`` of ``ctx.plan``'s mesh) the cache is this rank's shard of the pool and every arm goes through
    ``distributed/paged.py``: the scatter keeps the writes this shard owns,
    and attention is local partials merged across ranks. On a serving mesh
    (``ctx.plan``) k/v hold every kv head; q holds every
    head where ``every_q`` (decode, chunk and verify rows), else this
    rank's, and the packed prefill attends on those heads. ``rows``
    (``seq_full``): q holds this rank's rows of the sequence, k/v every
    row; the scatter writes every row, and the rank's rows attend (the
    packed prefill against K/V cut to its last row, the chunk and verify
    rows through their own tables).
    """
    plan = ctx.plan
    pool = None if plan is None else plan.mesh.pool_shards
    b, hq, s, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    ck, cv = cache["k_pages"], cache["v_pages"]
    window = paged_decode_window(cfg)
    if paged is None:
        raise ValueError("a paged cache needs its routing (paged=)")
    if ctx.decode:
        if s != 1 or segment_ids is not None:
            raise ValueError("decode takes one token per row and no segment ids")
        bt, kvl = paged["block_tables"], paged["kv_len"]
        if pool is not None:
            # sharded pool: local scatter + local partials, merged across
            # ranks (distributed/paged.py)
            o = dpaged.paged_append_decode_sharded(
                q[:, :, 0], k[:, :, 0], v[:, :, 0], ck, cv, bt, kvl,
                mesh=pool, impl=ctx.impl, window=window,
                num_splits=ctx.num_splits)
        else:
            ps = ck.shape[2]
            page = bt.gather(1, (kvl // ps)[:, None].long())[:, 0]
            dest = page * ps + kvl % ps                       # [B] token slots
            _scatter_pages(ck, dest, k[:, :, 0].transpose(0, 1))
            _scatter_pages(cv, dest, v[:, :, 0].transpose(0, 1))
            # no ring buffer: a sliding window masks inside the kernel, and
            # the engine frees pages wholly out of it (their entries revert
            # to the trash page, which the same gate never reads)
            o = spark_paged_decode(q[:, :, 0], ck, cv, bt, kvl + 1,
                                   impl=ctx.impl, window=window,
                                   num_splits=ctx.num_splits)
        o = o[:, None]                                        # [B, 1, Hq, D]
    else:
        if "dest" not in paged:
            raise ValueError("prefill onto a paged cache needs dest token slots")
        dest = paged["dest"].reshape(-1)                      # [B*Skv]
        scatter = (_scatter_pages if pool is None else
                   functools.partial(dpaged.scatter_pages_sharded, mesh=pool))
        scatter(ck, dest, k.transpose(0, 1).reshape(hkv, b * skv, hd))
        scatter(cv, dest, v.transpose(0, 1).reshape(hkv, b * skv, hd))
        if "token_tables" in paged:
            tables, kv_len = paged["token_tables"], paged["token_kv_len"]
            if rows:
                tables, kv_len = plan.seq_part(tables), plan.seq_part(kv_len)
            q_tok = q.transpose(1, 2).reshape(b * s, hq, hd)
            decode = (spark_paged_decode if pool is None else
                      functools.partial(dpaged.paged_decode_sharded,
                                        mesh=pool))
            o = decode(
                q_tok, ck, cv, tables.reshape(b * s, -1),
                kv_len.reshape(b * s), impl=ctx.impl,
                window=window, num_splits=ctx.num_splits,
                row_tokens=s).view(b, s, hq, hd)
        else:
            if plan is not None:       # the kv heads its q heads read
                k, v = plan.kv_heads_of(k), plan.kv_heads_of(v)
            if rows:
                k, v, segment_ids = _kv_upto(plan, k, v, segment_ids)
            o = spark_attention(q, k, v, impl=ctx.impl, causal=cfg.causal,
                                window=cfg.attn_window, segment_ids=segment_ids,
                                acc_dtype=ctx.acc_dtype,
                                torch_chunk=ctx.torch_chunk,
                                head_offset=0 if plan is None
                                else plan.head_offset).transpose(1, 2)
    return o

