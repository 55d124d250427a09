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
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.attention import spark_attention, spark_decode
from repro_torch.core.online_softmax import NEG_INF
from repro_torch.kernels import rng


@dataclasses.dataclass
class Ctx:
    """Per-call context: attention impl, mode flags and dropout seed."""
    impl: str = "kernel"             # attention impl (core.attention.IMPLS)
    deterministic: bool = True       # disables dropout
    seed: int = 0                    # dropout seed (an int32 value)
    decode: bool = False             # single-token decode step
    torch_chunk: int = 1024          # KV chunk of impl="torch"
    num_splits: int = 1              # split-KV decode slices per (B, Hkv) row
    acc_dtype: Any = torch.float32   # forward product rounding (bf16-ACC)
    bwd_acc_dtype: Any = torch.float32   # backward product rounding


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
def init_dense_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every parameter in place: norm weights (1-D) with ones, matrices
    ``[d_in, d_out]`` with :func:`dense_init`."""
    for w in module.parameters():
        if w.dim() == 1:
            w.fill_(1.0)
        else:
            w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype))
    return module


# ---------------------------------------------------------------------------
# primitive ops
# ---------------------------------------------------------------------------

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
    """Gated-SiLU FFN weights: ``wi [d_model, 2·d_ff]`` (gate | up) and
    ``wo [d_ff, d_model]``. The ungated GELU FFN comes with the encoder
    family."""

    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.wi = _param((d_model, 2 * d_ff), dtype, device)
        self.wo = _param((d_ff, d_model), dtype, device)


def init_mlp(gen, d_model, d_ff, dtype) -> MLP:
    """An :class:`MLP` with ``dense_init`` weights on the generator's device."""
    return init_dense_(MLP(d_model, d_ff, dtype, gen.device), gen)


def apply_mlp(p: MLP, x):
    """Gated-SiLU FFN: ``(silu(x @ wi_gate) * (x @ wi_up)) @ wo``."""
    g, u = (x @ p.wi).chunk(2, dim=-1)
    return (F.silu(g) * u) @ p.wo


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


def init_attention(gen, cfg, dtype) -> Attention:
    """An :class:`Attention` with ``dense_init`` weights and unit norms."""
    return init_dense_(Attention(cfg, dtype, gen.device), gen)


def init_attn_cache(cfg, batch: int, max_len: int, dtype, device):
    """One layer's contiguous cache: k/v [B, Hkv, max_len, D] zeros and the
    host-side write index."""
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def apply_attention(p: Attention, x, ctx: Ctx, cfg, *, positions=None,
                    cache=None, layer_seed: int = 0, segment_ids=None):
    """x: [B, S, d]. Returns (out, new_cache).

    segment_ids [B, S]: packed-batch ids (training and prefill without a
    cache) — attention stays within a segment; pair them with per-segment
    ``positions`` so RoPE restarts at each packed sequence.

    cache: a contiguous cache dict (k/v [B, Hkv, S_max, D], int ``index``).
    Unlike the JAX version, which returns new arrays, the cache's k/v tensors
    are updated **in place** and the returned dict shares them.

    * decode (``ctx.decode``): append this token at slot ``index`` (sliding-
      window archs use the cache as a ring of ``window`` slots, so no window
      mask is needed), then flash-decode over ``kv_len = min(index+1, cap)``.
    * prefill (cache given, not decode): fill the cache from position 0 — a
      windowed ring keeps the last ``cap`` tokens by slot — then fused
      attention over the prompt.
    """
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)

    q = (x @ p.wq).view(b, s, hq, hd)
    k = (x @ p.wk).view(b, s, hkv, hd)
    v = (x @ p.wv).view(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    q = rope(q, positions).transpose(1, 2)
    k = rope(k, positions).transpose(1, 2)
    v = v.transpose(1, 2)

    new_cache = None
    if ctx.decode:
        if s != 1 or cache is None or segment_ids is not None:
            raise ValueError("decode takes one token per row, a cache and "
                             "no segment ids")
        idx = cache["index"]
        cap = cache["k"].shape[2]
        slot = idx % cap if cfg.attn_window is not None else idx
        if slot >= cap:
            raise ValueError(f"cache full: position {idx} >= max_len {cap}")
        ck, cv = cache["k"], cache["v"]
        ck[:, :, slot] = k[:, :, 0].to(ck.dtype)
        cv[:, :, slot] = v[:, :, 0].to(cv.dtype)
        kv_len = torch.full((b,), min(idx + 1, cap), dtype=torch.int32,
                            device=x.device)
        o = spark_decode(q[:, :, 0], ck, cv, impl=ctx.impl, kv_len=kv_len,
                         window=None, num_splits=ctx.num_splits)[:, :, None]
        new_cache = {"k": ck, "v": cv, "index": idx + 1}
    else:
        if cache is not None:
            if segment_ids is not None:
                raise ValueError("the contiguous cache stores no segments: "
                                 "packed prefill needs a paged cache")
            ck, cv = cache["k"], cache["v"]
            cap = ck.shape[2]
            if s >= cap:       # windowed ring: keep the last `cap` tokens, by slot
                shift = (s - cap) % cap
                ck.copy_(torch.roll(k[:, :, s - cap:], shift, dims=2))
                cv.copy_(torch.roll(v[:, :, s - cap:], shift, dims=2))
            else:
                ck[:, :, :s] = k
                cv[:, :, :s] = v
            new_cache = {"k": ck, "v": cv, "index": cache["index"] + s}
        drop = 0.0 if ctx.deterministic else cfg.dropout_rate
        o = spark_attention(q, k, v, impl=ctx.impl,
                            seed=rng.int32(ctx.seed + layer_seed),
                            causal=cfg.causal, window=cfg.attn_window,
                            dropout_rate=drop, segment_ids=segment_ids,
                            acc_dtype=ctx.acc_dtype,
                            bwd_acc_dtype=ctx.bwd_acc_dtype,
                            torch_chunk=ctx.torch_chunk)

    out = o.transpose(1, 2).reshape(b, s, hq * hd) @ p.wo
    return out, new_cache
