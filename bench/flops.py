"""Operations and bytes: the model flops of a step, a prefill and a decode
step, and the roofline bound of each attention call. It imports nothing of
the program.

The peaks are one NVIDIA H100 SXM's, NVIDIA's data sheet, dense, at 700 W:
495 TFLOP/s on TF32 tensor cores (the fastest f32-input math the chip
does; a 3xTF32 product at full f32 precision still runs there) and 3.35
TB/s of HBM3 (as ``perf/roofline.py`` and ``chip_smoke.bounds`` have them).

Model flops count every weight that a token meets in a matrix product (the
output head and a frontend's projection count, the embedding gather does
not; each configuration's reference module, ``bench/reference/<name>.py``,
counts its own model's in ``matmul_weights`` and ``attention_layers``) at
2 flops a weight a token forward and 6 forward and backward, plus
attention's 4·D flops a (query, key) pair a head forward (QK^T and PV) and
8·D backward, over the pairs inside the mask. Remat's recompute is not
counted. A kernel's bound counts its call: 4·D a pair a head forward, 10·D
backward (the fused backward recomputes S and P: S, dP, dV, dK and dQ, 2·D
each), each input read once and each output written once.
"""

from __future__ import annotations

from typing import Iterable, Tuple

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the chip could take: operations over the peak or
    bytes over HBM's rate, whichever is longer."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def causal_pairs(n: int) -> int:
    """(query, key) pairs of a causal mask over n positions."""
    return n * (n + 1) // 2


def pairs(s: int, causal: bool) -> int:
    return causal_pairs(s) if causal else s * s


def _reference(c: dict):
    from bench import spec
    return spec.reference(c)


def body_weights(c: dict) -> int:
    """Every matrix-product weight a token meets but the output head's, as
    the configuration's reference module counts them
    (``matmul_weights(c)``): a sparse model counts the experts a token is
    routed to."""
    return _reference(c).matmul_weights(c)[0]


def head_weights(c: dict) -> int:
    return _reference(c).matmul_weights(c)[1]


def attn_flops_per_pair(c: dict) -> int:
    """Forward flops of one (query, key) pair over every attention layer's
    heads (the reference module's ``attention_layers(c)``)."""
    return 4 * c["head_dim"] * c["num_heads"] * _reference(c).attention_layers(c)


def train_step_flops(c: dict, batch: int, seq: int) -> float:
    """6·N·T plus attention's 12·D a pair a head, forward and backward."""
    n = body_weights(c) + head_weights(c)
    return (6.0 * n * batch * seq
            + 3.0 * attn_flops_per_pair(c) * batch * pairs(seq, c["causal"]))


def prefill_flops(c: dict, spans: Iterable[Tuple[int, int]]) -> float:
    """Forward flops of prompt spans prefilled, each tokens [start, end) of
    one prompt (a whole prompt is (0, n); a chunk or the suffix after a
    cached prefix starts later): every token through the body, its causal
    pairs over the whole prefix, and one head row a span (its last
    token's)."""
    total = 0.0
    for a, b in spans:
        total += (2.0 * body_weights(c) * (b - a)
                  + attn_flops_per_pair(c) * (causal_pairs(b) - causal_pairs(a))
                  + 2.0 * head_weights(c))
    return total


def decode_flops(c: dict, kv_lens: Iterable[int]) -> float:
    """Forward flops of decode tokens, each attending over kv_len + 1
    positions (its cache and itself)."""
    total = 0.0
    for kv in kv_lens:
        total += (2.0 * (body_weights(c) + head_weights(c))
                  + attn_flops_per_pair(c) * (kv + 1))
    return total


def attn_fwd_cost(b, hq, hkv, sq, skv, d, n_pairs, el=4, seg_rows=0):
    """(ops, bytes) of one forward attention call over ``n_pairs`` pairs a
    (batch row, head): q, k, v read, o and the f32 lse written, and
    ``seg_rows`` int32 segment ids read."""
    ops = 4.0 * b * hq * d * n_pairs
    nbytes = el * (2 * b * hq * sq * d + 2 * b * hkv * skv * d) + 4 * b * hq * sq \
        + 4 * seg_rows
    return ops, nbytes


def attn_bwd_cost(b, hq, hkv, sq, skv, d, n_pairs, el=4):
    """(ops, bytes) of one backward call: q, k, v, o, do and lse read, dq,
    dk and dv written."""
    ops = 10.0 * b * hq * d * n_pairs
    nbytes = el * (4 * b * hq * sq * d + 4 * b * hkv * skv * d) + 4 * b * hq * sq
    return ops, nbytes


def paged_decode_cost(b, hq, hkv, d, kv_rows, table_width, el=4):
    """(ops, bytes) of one paged decode call whose rows read ``kv_rows``
    distinct K/V positions in all: q read, o written, K and V of each
    position, the block tables and the lengths."""
    ops = 4.0 * hq * d * kv_rows
    nbytes = el * (2 * b * hq * d + 2 * hkv * d * kv_rows) + 4 * b * table_width + 4 * b
    return ops, nbytes
