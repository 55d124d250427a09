"""SparkAttention public API of the port (counterpart of ``repro.core.attention``).

One entry point, three interchangeable execution paths:

* ``impl="kernel"`` — the hand-written CUDA kernels on a CUDA tensor (their
  plain-torch versions on a CPU tensor).
* ``impl="torch"``  — the same online-softmax algorithm as a chunked loop in
  plain torch; O(chunk) memory (the counterpart of ``impl="xla"``).
* ``impl="naive"``  — the unfused baseline; O(N²) memory.

All paths are numerically interchangeable and differentiable (the tests
assert it).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import online_softmax as osm
from repro_torch.core.online_softmax import NEG_INF
from repro_torch.kernels import ops
from repro_torch.kernels.ops import AttnConfig
from repro_torch.kernels.ref import _expand_kv

IMPLS = ("kernel", "torch", "naive")


def spark_attention(q, k, v, *, impl: str = "kernel", seed=0,
                    causal: bool = False, window: Optional[int] = None,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    segment_ids=None, acc_dtype=torch.float32,
                    bwd_acc_dtype=torch.float32, torch_chunk: int = 1024):
    """Fused MHA. q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] → [B,Hq,Sq,D].

    segment_ids: optional [B, Skv] int32 per-token segment ids for packed
    batches — attention never crosses a segment boundary, negative ids mark
    padding tokens that attend to nothing. ``acc_dtype`` / ``bwd_acc_dtype``
    (bf16-ACC) reach the kernels' forward and backward; the plain paths
    compute in f32, as JAX's.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    cfg = AttnConfig(causal=causal, window=window, scale=scale,
                     dropout_rate=dropout_rate, acc_dtype=acc_dtype,
                     bwd_acc_dtype=bwd_acc_dtype)
    if impl == "kernel":
        return ops.mha(q, k, v, seed=seed, segment_ids=segment_ids, config=cfg)
    if impl == "torch":
        return ops.mha_torch(q, k, v, seed=seed, segment_ids=segment_ids,
                             config=cfg, chunk=torch_chunk)
    return ops.mha_reference(q, k, v, seed=seed, segment_ids=segment_ids,
                             config=cfg)


def spark_decode(q, k, v, *, impl: str = "kernel", kv_len=None,
                 window: Optional[int] = None, scale: Optional[float] = None,
                 num_splits: int = 1):
    """Single-token decode against a KV cache. q [B,Hq,D] → [B,Hq,D].

    ``num_splits > 1`` runs the split-KV scheme on every impl: the KV axis is
    cut into that many slices whose un-normalised (acc, m, l) states merge in
    f32 (``online_softmax.merge_many``).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel":
        return ops.decode(q, k, v, kv_len=kv_len, window=window, scale=scale,
                          num_splits=num_splits)
    # plain path: one query row, so the direct masked form is already
    # O(S) memory; splits mirror the kernel's partial-state algebra
    if num_splits > 1:
        acc, m, l = _torch_split_decode_partials(
            q, k, v, kv_len=kv_len, window=window, scale=scale,
            num_splits=num_splits)
        o, _ = osm.finalize(osm.SoftmaxState(m=m, l=l, acc=acc),
                            out_dtype=q.dtype)
        return o
    return _torch_masked_decode(q, k, v, kv_len=kv_len, window=window,
                                scale=scale)


def _torch_masked_decode(q, k, v, *, kv_len=None, window=None, scale=None):
    acc, m, l = _torch_masked_decode_partials(q, k, v, kv_len=kv_len,
                                              window=window, scale=scale)
    o, _ = osm.finalize(osm.SoftmaxState(m=m, l=l, acc=acc), out_dtype=q.dtype)
    return o


def _torch_masked_decode_partials(q, k, v, *, kv_len=None, window=None,
                                  scale=None, kv_start=0):
    """Masked single-query decode, stopping at the un-normalised state
    (acc, m, l) over this slice's positions. ``kv_start`` offsets the slice's
    global positions (``kv_len``/``window`` stay global). Fully-masked rows
    keep ``m == NEG_INF, l == 0, acc == 0``."""
    b, hq, d = q.shape
    skv = k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bhd,bhkd->bhk", q.float(),
                     _expand_kv(k, hq).float()) * scale
    kp = kv_start + torch.arange(skv, device=q.device)[None, None, :]
    if kv_len is None:
        kv_len = torch.full((b,), kv_start + skv, dtype=torch.int32,
                            device=q.device)
    L = kv_len.to(torch.int64)[:, None, None]
    allowed = kp < L
    if window is not None:
        allowed &= kp > (L - 1) - window
    s = torch.where(allowed, s, NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.where(m == NEG_INF, torch.zeros_like(m), m)
    p = torch.where(allowed, torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhk,bhkd->bhd", p, _expand_kv(v, hq).float())
    return acc, m, l


def _torch_split_decode_partials(q, k, v, *, kv_len=None, window=None,
                                 scale=None, num_splits=2):
    """Split-KV decode in plain torch: the KV axis is cut into ``num_splits``
    contiguous slices, each slice's state comes from
    :func:`_torch_masked_decode_partials` at its global offset, and the
    stacked states merge with ``online_softmax.merge_many``."""
    b = q.shape[0]
    skv = k.shape[2]
    num_splits = max(1, min(num_splits, skv))
    chunk = -(-skv // num_splits)
    if kv_len is None:
        kv_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)
    parts = []
    for lo in range(0, skv, chunk):
        hi = min(lo + chunk, skv)
        acc, m, l = _torch_masked_decode_partials(
            q, k[:, :, lo:hi], v[:, :, lo:hi], kv_len=kv_len, window=window,
            scale=scale, kv_start=lo)
        parts.append(osm.SoftmaxState(m=m, l=l, acc=acc))
    state = osm.merge_many(osm.SoftmaxState(
        m=torch.stack([p.m for p in parts]), l=torch.stack([p.l for p in parts]),
        acc=torch.stack([p.acc for p in parts])), axis=0)
    return state.acc, state.m, state.l
