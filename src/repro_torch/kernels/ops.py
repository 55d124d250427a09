"""Public attention ops over the kernels (counterpart of ``repro.kernels.ops``).

``mha`` is the fused forward (the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor); in this slice it is forward-only, for serving —
its ``torch.autograd.Function`` with the backward kernels comes with the
training path. ``mha_reference`` is the unfused oracle and ``mha_torch`` the
chunked plain-torch algorithm (the counterpart of ``mha_xla``). ``decode``
and ``decode_reference`` are the single-token pair.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode import flash_decode
from repro_torch.kernels.flash_fwd import flash_fwd


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """Static attention options.

    The JAX config's ``block_q``/``block_kv`` tile options are gone: the CUDA
    kernels fix their tiles (``flash_fwd.TILE``, ``decode.TILE``) and their
    plain versions fold the same tiles. ``bwd_acc_dtype`` comes with the
    backward kernels.
    """
    causal: bool = False
    window: Optional[int] = None
    scale: Optional[float] = None
    dropout_rate: float = 0.0
    acc_dtype: Any = torch.float32     # bf16-ACC is not ported yet


def mha(q, k, v, *, seed=0, segment_ids=None,
        config: AttnConfig = AttnConfig()):
    """Fused multi-head attention, forward. q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D]
    → o [B,Hq,Sq,D]. segment_ids: optional [B, Skv] int32 packed-batch ids."""
    o, _ = flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                     causal=config.causal, window=config.window,
                     scale=config.scale, dropout_rate=config.dropout_rate,
                     dropout_seed=seed, segment_ids=segment_ids,
                     acc_dtype=config.acc_dtype)
    return o


def mha_reference(q, k, v, *, seed=0, segment_ids=None,
                  config: AttnConfig = AttnConfig()):
    """The unfused oracle with identical semantics."""
    return ref.naive_mha(q, k, v, causal=config.causal, window=config.window,
                         scale=config.scale, dropout_rate=config.dropout_rate,
                         dropout_seed=seed, segment_ids=segment_ids)


def mha_torch(q, k, v, *, seed=0, segment_ids=None,
              config: AttnConfig = AttnConfig(), chunk: int = 1024):
    """The fused algorithm in plain torch ops, chunked over KV."""
    return ref.online_mha(q, k, v, causal=config.causal, window=config.window,
                          scale=config.scale, dropout_rate=config.dropout_rate,
                          dropout_seed=seed, segment_ids=segment_ids,
                          chunk=chunk)


def decode(q, k, v, *, kv_len=None, window=None, scale=None,
           num_splits: int = 1):
    """Single-token flash-decode. q [B, Hq, D], k/v [B, Hkv, S, D], kv_len
    [B] int32. ``num_splits > 1`` folds that many KV slices in parallel and
    merges their partial states in f32."""
    return flash_decode(q.contiguous(), k.contiguous(), v.contiguous(),
                        kv_len=kv_len, window=window, scale=scale,
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
