"""Public attention ops over the kernels (counterpart of ``repro.kernels.ops``).

``mha`` is the trainable fused attention, a ``torch.autograd.Function``
(JAX's ``custom_vjp``): forward = ``flash_fwd``, backward = ``flash_bwd``
(the fused backward kernel, recomputing P from the saved lse) — the CUDA
kernels on a CUDA tensor, their plain versions on a CPU tensor.
``mha_reference`` is the unfused oracle and ``mha_torch`` the chunked
plain-torch algorithm (the counterpart of ``mha_xla``); both differentiate
too. ``decode`` and ``decode_reference`` are the single-token pair over a
contiguous cache, ``paged_decode`` and ``paged_decode_reference`` the pair
over a page pool, ``paged_decode_partials`` the gated form for one shard of
a page-sharded pool.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode import (flash_decode, flash_decode_partials,
                                       flash_paged_decode,
                                       flash_paged_decode_partials,
                                       gather_pages)
from repro_torch.kernels.flash_bwd import flash_bwd
from repro_torch.kernels.flash_fwd import flash_fwd


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """Static attention options.

    The JAX config's ``block_q``/``block_kv`` tile options are gone: the CUDA
    kernels fix their tiles (``flash_fwd.TILE``, ``decode.TILE``) and their
    plain versions fold the same tiles.
    """
    causal: bool = False
    window: Optional[int] = None
    scale: Optional[float] = None
    dropout_rate: float = 0.0
    acc_dtype: Any = torch.float32       # bf16-ACC / f32-ACC (paper §3.1)
    bwd_acc_dtype: Any = torch.float32   # the backward's product rounding


class _MHA(torch.autograd.Function):
    """Forward ``flash_fwd``; backward ``flash_bwd``. Saves q, k, v, o, lse
    and the seed: S and P are recomputed, never stored (paper §3.3)."""

    @staticmethod
    def forward(ctx, q, k, v, seed, segment_ids, config, offsets):
        o, lse = flash_fwd(q, k, v, causal=config.causal, window=config.window,
                           scale=config.scale, dropout_rate=config.dropout_rate,
                           dropout_seed=seed, segment_ids=segment_ids,
                           acc_dtype=config.acc_dtype, batch_offset=offsets[0],
                           head_offset=offsets[1])
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.seed, ctx.config, ctx.offsets = seed, config, offsets
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        cfg = ctx.config
        # the incoming gradient is a transposed view (layers.apply_attention
        # reshapes o.transpose(1, 2)); the kernels read it row-major
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               causal=cfg.causal, window=cfg.window,
                               scale=cfg.scale, dropout_rate=cfg.dropout_rate,
                               dropout_seed=ctx.seed, segment_ids=segment_ids,
                               acc_dtype=cfg.bwd_acc_dtype,
                               batch_offset=ctx.offsets[0],
                               head_offset=ctx.offsets[1])
        return dq, dk, dv, None, None, None, None


def mha(q, k, v, *, seed=0, segment_ids=None,
        config: AttnConfig = AttnConfig(), batch_offset: int = 0,
        head_offset: int = 0):
    """Fused multi-head attention, differentiable. q [B,Hq,Sq,D], k/v
    [B,Hkv,Skv,D] → o [B,Hq,Sq,D]. segment_ids: optional [B, Skv] int32
    packed-batch ids; seed: the int dropout seed (wrapped to int32);
    batch_offset / head_offset: the global coordinates of ``q[0, 0]`` that
    the dropout mask hashes (``flash_fwd``), in both directions."""
    return _MHA.apply(q.contiguous(), k.contiguous(), v.contiguous(), int(seed),
                      segment_ids, config, (int(batch_offset), int(head_offset)))


def mha_reference(q, k, v, *, seed=0, segment_ids=None,
                  config: AttnConfig = AttnConfig(), batch_offset: int = 0,
                  head_offset: int = 0):
    """The unfused oracle with identical semantics."""
    return ref.naive_mha(q, k, v, causal=config.causal, window=config.window,
                         scale=config.scale, dropout_rate=config.dropout_rate,
                         dropout_seed=seed, segment_ids=segment_ids,
                         batch_offset=batch_offset, head_offset=head_offset)


def mha_torch(q, k, v, *, seed=0, segment_ids=None,
              config: AttnConfig = AttnConfig(), chunk: int = 1024,
              batch_offset: int = 0, head_offset: int = 0):
    """The fused algorithm in plain torch ops, chunked over KV, with the
    chunked recompute backward. Products in f32, as JAX's ``mha_xla``."""
    return ref.online_mha(q, k, v, causal=config.causal, window=config.window,
                          scale=config.scale, dropout_rate=config.dropout_rate,
                          dropout_seed=seed, segment_ids=segment_ids,
                          chunk=chunk, batch_offset=batch_offset,
                          head_offset=head_offset)


def decode(q, k, v, *, kv_len=None, window=None, scale=None,
           num_splits: int = 1):
    """Single-token flash-decode. q [B, Hq, D], k/v [B, Hkv, S, D], kv_len
    [B] int32. ``num_splits > 1`` folds that many KV slices in parallel and
    merges their partial states in f32."""
    return flash_decode(q.contiguous(), k.contiguous(), v.contiguous(),
                        kv_len=kv_len, window=window, scale=scale,
                        num_splits=num_splits)


def decode_partials(q, k, v, *, kv_len=None, window=None, scale=None,
                    num_splits: int = 1):
    """Single-token flash-decode over one shard of a sequence-sharded cache,
    stopping at the f32 ``(acc, m, l)`` state (``kv_len`` counts the
    shard's valid slots, its first ones)."""
    return flash_decode_partials(q.contiguous(), k.contiguous(), v.contiguous(),
                                 kv_len=None if kv_len is None
                                 else kv_len.contiguous(),
                                 window=window, scale=scale,
                                 num_splits=num_splits)


def decode_reference(q, k, v, *, kv_len=None, window=None, scale=None):
    """Oracle for decode: each row through the naive oracle over its own
    ``kv_len`` positions (a row with kv_len == 0 gives zeros)."""
    if kv_len is None:
        return ref.naive_mha(q[:, :, None, :], k, v, causal=True,
                             window=window, scale=scale)[:, :, 0, :]
    outs = []
    for i, n in enumerate(kv_len.tolist()):
        if n == 0:
            outs.append(torch.zeros_like(q[i:i + 1]))
            continue
        outs.append(ref.naive_mha(q[i:i + 1, :, None, :], k[i:i + 1, :, :n],
                                  v[i:i + 1, :, :n], causal=True,
                                  window=window, scale=scale)[:, :, 0, :])
    return torch.cat(outs, dim=0)


def paged_decode(q, k_pages, v_pages, block_tables, kv_len, *, window=None,
                 scale=None, num_splits: int = 1, row_tokens: int = 1):
    """Single-token flash-decode over a paged KV cache. q [B, Hq, D];
    k_pages/v_pages [Hkv, P, page_size, D]; block_tables [B, T] int32 (the
    trash page past each row's allocation); kv_len [B] int32; ``row_tokens``
    the kernel's launch hint (``kernels/decode.py``)."""
    return flash_paged_decode(q.contiguous(), k_pages.contiguous(),
                              v_pages.contiguous(), block_tables.contiguous(),
                              kv_len.contiguous(), window=window, scale=scale,
                              num_splits=num_splits, row_tokens=row_tokens)


def paged_decode_partials(q, k_pages, v_pages, block_tables, kv_len, *,
                          block_valid=None, window=None, scale=None,
                          num_splits: int = 1, row_tokens: int = 1):
    """Paged flash-decode stopping at the f32 ``(acc, m, l)`` state.

    ``block_valid [B, T]`` (0/1, any integer or bool dtype) gates table
    entries: a shard of a page-sharded pool passes its ownership mask, so
    entries it does not own (remapped to its local trash page) are never
    read. States of different shards merge with the online-softmax algebra
    and finalise once (``distributed/paged.py``); ``num_splits`` splits
    within the shard first, and the returned triple is the same either way.
    """
    if block_valid is not None:
        block_valid = block_valid.to(torch.int32).contiguous()
    return flash_paged_decode_partials(
        q.contiguous(), k_pages.contiguous(), v_pages.contiguous(),
        block_tables.contiguous(), kv_len.contiguous(),
        block_valid=block_valid, window=window, scale=scale,
        num_splits=num_splits, row_tokens=row_tokens)


def paged_decode_reference(q, k_pages, v_pages, block_tables, kv_len, *,
                           window=None, scale=None):
    """Oracle: gather the pages contiguously, then the contiguous oracle."""
    return decode_reference(q, gather_pages(k_pages, block_tables),
                            gather_pages(v_pages, block_tables),
                            kv_len=kv_len, window=window, scale=scale)
