"""Compulsory HBM-traffic model, per device and step (counterpart of
``repro.perf.memory_model``, line for line: its numbers equal JAX's).

A count of every operand of every op (JAX's XLA ``bytes accessed``, the
port's ``roofline.Roofline.hlo_bytes_per_dev``) is fusion-blind and
overstates the traffic. The roofline's *memory term* is the compulsory
traffic a perfectly fused program still has to move:

  * every weight read once per use (fwd + dgrad), optimizer state round-trip,
  * every matmul boundary tensor written/read once (intra-chain elementwise
    ops fuse; matmul outputs must materialise),
  * saved remat residuals written (fwd) + read (bwd) + one recompute pass,
  * logits / KV-cache / recurrent-state streams.

Backward matmul traffic ≈ 2× forward (dgrad + wgrad each re-read one side).
Remat recompute ≈ +1× forward activation traffic.

All dims are divided by the mesh shards that actually shard them (tokens by
DP; features by TP where the rule engine shards them). The same fallback
rules as ``distributed/sharding.py`` apply (non-divisible → replicated).
It models JAX's layout in bf16 (``BF16``, ``F32``: bytes an element)
whatever a config's dtype, as JAX's does; ``launch/dryrun.py`` reports it
beside the bytes the port's rank holds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.distributed.sharding import uses_fsdp_profile

BF16 = 2
F32 = 4


def _div(n: int, by: int, divisible_required: bool = True) -> float:
    if by <= 1:
        return float(n)
    if n % by == 0:
        return n / by
    return float(n)  # sharding fallback: replicated


@dataclasses.dataclass
class Traffic:
    """Compulsory HBM bytes for one step, broken down by tensor family."""
    weights: float = 0.0
    optimizer: float = 0.0
    activations: float = 0.0
    logits: float = 0.0
    cache: float = 0.0

    @property
    def total(self) -> float:
        """Sum of every traffic family (the roofline memory numerator)."""
        return (self.weights + self.optimizer + self.activations
                + self.logits + self.cache)

    def as_dict(self):
        """Flat dict form (artifact/JSON friendly), including the total."""
        return {"weights": self.weights, "optimizer": self.optimizer,
                "activations": self.activations, "logits": self.logits,
                "cache": self.cache, "total": self.total}


def _layer_param_bytes(cfg, kind: str, tp: int) -> float:
    d = cfg.d_model
    p = 0.0
    if kind == "attn":
        p += _div(cfg.num_heads * cfg.head_dim, tp) * d * 2   # wq, wo
        p += _div(cfg.num_kv_heads * cfg.head_dim, tp) * d * 2
    if kind in ("attn", "rec") and cfg.d_ff:
        if cfg.moe is not None:
            m = cfg.moe
            p += _div(m.num_experts, tp) * 3 * d * m.d_ff_expert
            p += d * m.num_experts                            # router
            p += m.num_shared_experts * 3 * d * m.d_ff_expert
        else:
            p += 3 * d * _div(cfg.d_ff, tp)
    if kind == "rec":
        dr = cfg.rglru.d_rnn
        p += 3 * d * _div(dr, tp) + 2 * _div(dr, tp) * dr
    if kind == "ssm":
        mc = cfg.mamba
        di = _div(mc.d_inner, tp)
        p += 3 * d * di + di * (2 * mc.ssm_state + 2 * mc.dt_rank)
    return p * BF16


def _layer_act_bytes(cfg, kind: str, tokens_local: float, tp: int,
                     seq_kv: Optional[float] = None) -> float:
    """Matmul-boundary tensors per layer, forward, bytes (written + read)."""
    d = cfg.d_model
    t = tokens_local
    a = 2 * t * d                                  # block input read + out write
    if kind == "attn":
        heads_io = (_div(cfg.num_heads * cfg.head_dim, tp)
                    + 2 * _div(cfg.num_kv_heads * cfg.head_dim, tp))
        a += 2 * t * heads_io                      # qkv write+read
        a += 2 * t * _div(cfg.num_heads * cfg.head_dim, tp)  # attn out
    if kind in ("attn", "rec") and cfg.d_ff:
        if cfg.moe is not None:
            m = cfg.moe
            cap_blowup = m.top_k * m.capacity_factor
            a += 2 * t * cap_blowup * (d + _div(m.d_ff_expert, 1))
            a += 2 * t * m.num_shared_experts * m.d_ff_expert
        else:
            a += 2 * t * 2 * _div(cfg.d_ff, tp)    # gated hidden write+read
    if kind == "rec":
        a += 6 * t * _div(cfg.rglru.d_rnn, tp)
    if kind == "ssm":
        a += 8 * t * _div(cfg.mamba.d_inner, tp)
    return a * BF16


def train_traffic(cfg, shape, *, dp: int, tp: int, fsdp: bool) -> Traffic:
    """Per-device compulsory bytes for one train step (module docstring)."""
    t = Traffic()
    tokens_local = shape.global_batch * shape.seq_len / dp
    storage_shards = tp * (dp if fsdp else 1)
    vocab_local = _div(cfg.vocab_size, tp)
    period = len(cfg.block_pattern)

    total_params_local = 0.0
    for i in range(cfg.num_layers):
        kind = cfg.block_pattern[i % period]
        lp = _layer_param_bytes(cfg, kind, tp)
        total_params_local += lp
        # fwd read + dgrad read + wgrad write(grad, f32-equiv ≈ 2×bf16)
        t.weights += 2 * lp + 2 * lp
        act = _layer_act_bytes(cfg, kind, tokens_local, tp)
        # fwd + bwd(2×) + remat recompute(1×) + saved residual round-trip
        t.activations += act * (1 + 2 + (1 if cfg.remat else 0))
    t.activations += cfg.num_layers * tokens_local * cfg.d_model * BF16 * 2
    emb = vocab_local * cfg.d_model * BF16 * 2     # embed + head
    t.weights += 3 * emb
    # optimizer: m, v, master read+write f32 + grad read f32 + param write
    params_storage = (total_params_local + emb) * (tp / storage_shards)
    t.optimizer += params_storage / BF16 * (6 * F32 + F32 + BF16)
    # logits fwd write+read + bwd
    t.logits += 4 * tokens_local * vocab_local * BF16
    return t


def prefill_traffic(cfg, shape, *, dp: int, tp: int) -> Traffic:
    """Per-device compulsory bytes for one prefill pass (incl. cache write)."""
    t = Traffic()
    tokens_local = shape.global_batch * shape.seq_len / dp
    period = len(cfg.block_pattern)
    vocab_local = _div(cfg.vocab_size, tp)
    for i in range(cfg.num_layers):
        kind = cfg.block_pattern[i % period]
        t.weights += _layer_param_bytes(cfg, kind, tp)
        t.activations += _layer_act_bytes(cfg, kind, tokens_local, tp)
        if kind == "attn":
            win = cfg.attn_window or shape.seq_len
            kv = (shape.global_batch / dp) * min(win, shape.seq_len) \
                * _div(cfg.num_kv_heads * cfg.head_dim, tp) * 2
            t.cache += kv * BF16                   # cache write
    t.weights += 2 * vocab_local * cfg.d_model * BF16
    t.logits += 2 * tokens_local * vocab_local * BF16
    return t


def decode_traffic(cfg, shape, *, dp: int, tp: int) -> Traffic:
    """One token for every sequence in the batch."""
    t = Traffic()
    b_local = shape.global_batch / dp
    period = len(cfg.block_pattern)
    vocab_local = _div(cfg.vocab_size, tp)
    for i in range(cfg.num_layers):
        kind = cfg.block_pattern[i % period]
        t.weights += _layer_param_bytes(cfg, kind, tp)
        t.activations += _layer_act_bytes(cfg, kind, b_local, tp)
        if kind == "attn":
            win = cfg.attn_window or shape.seq_len
            eff = min(win, shape.seq_len)
            kvh = _div(cfg.num_kv_heads, tp)
            seq_shard = tp if (cfg.num_kv_heads % tp) else 1
            t.cache += (b_local * kvh * (eff / seq_shard)
                        * cfg.head_dim * 2 * BF16)   # read K and V
        if kind == "rec":
            t.cache += 2 * b_local * _div(cfg.rglru.d_rnn, tp) * F32
        if kind == "ssm":
            mc = cfg.mamba
            t.cache += (2 * b_local * _div(mc.d_inner, tp)
                        * mc.ssm_state * F32)
    t.weights += 2 * vocab_local * cfg.d_model * BF16
    t.logits += 2 * b_local * vocab_local * BF16
    return t


def storage_for(cfg, shape, *, dp: int, tp: int, fsdp: bool) -> dict:
    """Per-device resident HBM bytes (analytic): params + optimizer (train) +
    saved remat residuals + KV-cache/states + a transient working-set term
    (the dry run holds its total against a card's memory, ``fits_analytic``,
    beside the bytes the port's rank holds)."""
    period = len(cfg.block_pattern)
    storage_shards = tp * (dp if fsdp else 1)
    params_local = 0.0
    for i in range(cfg.num_layers):
        kind = cfg.block_pattern[i % period]
        params_local += _layer_param_bytes(cfg, kind, tp)
    vocab_local = _div(cfg.vocab_size, tp)
    params_local += 2 * vocab_local * cfg.d_model * BF16
    params_store = params_local * (tp / storage_shards)
    out = {"params": params_store}
    tokens_local = shape.global_batch * shape.seq_len / dp
    if shape.kind == "train":
        out["optimizer"] = params_store / BF16 * 3 * F32  # m, v, master f32
        out["grads"] = params_store / BF16 * F32
        # saved residuals at superblock boundaries (seq additionally sharded
        # by TP under the SP layout)
        seq_shard = tp if (not uses_fsdp_profile(cfg)
                           and shape.seq_len % max(tp, 1) == 0) else 1
        out["residuals"] = (cfg.num_layers * tokens_local * cfg.d_model
                            * BF16 / seq_shard)
        out["logits_buffer"] = tokens_local * vocab_local * F32
        # transient: one superblock's recompute working set
        out["transient"] = _layer_act_bytes(cfg, cfg.block_pattern[0],
                                            tokens_local, tp) * period
    else:
        b_local = shape.global_batch / dp
        cache = 0.0
        for i in range(cfg.num_layers):
            kind = cfg.block_pattern[i % period]
            if kind == "attn":
                win = cfg.attn_window or shape.seq_len
                eff = min(win, shape.seq_len)
                kvh = _div(cfg.num_kv_heads, tp)
                seq_shard = tp if (cfg.num_kv_heads % max(tp, 1)) else 1
                cache += (b_local * kvh * eff / seq_shard * cfg.head_dim
                          * 2 * BF16)
            elif kind == "rec":
                cache += b_local * _div(cfg.rglru.d_rnn, tp) * 4 * F32
            elif kind == "ssm":
                mc = cfg.mamba
                cache += (b_local * _div(mc.d_inner, tp)
                          * (mc.ssm_state + mc.conv_kernel) * F32)
        out["cache"] = cache
        out["transient"] = _layer_act_bytes(
            cfg, cfg.block_pattern[0],
            tokens_local if shape.kind == "prefill" else b_local, tp)
    out["total"] = sum(out.values())
    return out


def traffic_for(cfg, shape, *, dp: int, tp: int, fsdp: bool) -> Traffic:
    """Dispatch to the train/prefill/decode traffic model by shape.kind."""
    if shape.kind == "train":
        return train_traffic(cfg, shape, dp=dp, tp=tp, fsdp=fsdp)
    if shape.kind == "prefill":
        return prefill_traffic(cfg, shape, dp=dp, tp=tp)
    return decode_traffic(cfg, shape, dp=dp, tp=tp)
