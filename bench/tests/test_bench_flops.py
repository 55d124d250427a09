"""``flops.py`` against hand counts and against the kernel bounds of
PERF.md §6 (its table of the port's kernels, f32 on TF32 tensor cores)."""

import pytest

from bench import flops, spec

GRANITE = spec.config("granite-3-2b")
HUBERT = spec.config("hubert-xlarge")


def _ms(cost):
    return 1e3 * flops.bound_s(*cost)


@pytest.mark.parametrize("cost,want", [
    # granite training shape, B 4, 32/8 heads, S 2048, D 64, causal: row 1
    (flops.attn_fwd_cost(4, 32, 8, 2048, 2048, 64, flops.causal_pairs(2048)), 0.13890),
    # rows 2-3 at the same shape
    (flops.attn_bwd_cost(4, 32, 8, 2048, 2048, 64, flops.causal_pairs(2048)), 0.34724),
    # hubert training, B 8, 16/16 heads, S 1024, D 80, not causal: rows 2-3
    (flops.attn_bwd_cost(8, 16, 16, 1024, 1024, 80, 1024 * 1024), 0.21692),
])
def test_kernel_bounds_are_perf_mds(cost, want):
    assert _ms(cost) == pytest.approx(want, abs=5e-6)


def test_hand_counts():
    assert flops.causal_pairs(4) == 10 and flops.pairs(4, False) == 16
    ops, nbytes = flops.attn_fwd_cost(1, 2, 1, 3, 3, 8, 6, seg_rows=3)
    assert ops == 4 * 2 * 8 * 6
    assert nbytes == 4 * (2 * 2 * 3 * 8 + 2 * 1 * 3 * 8) + 4 * 2 * 3 + 4 * 3
    ops, nbytes = flops.paged_decode_cost(2, 4, 2, 16, kv_rows=10, table_width=5)
    assert ops == 4 * 4 * 16 * 10
    assert nbytes == 4 * (2 * 2 * 4 * 16 + 2 * 2 * 16 * 10) + 4 * 2 * 5 + 4 * 2
    # the bound is the longer of the two
    assert flops.bound_s(495e12, 0) == 1.0 and flops.bound_s(0, 3.35e12) == 1.0


def test_model_flops_of_the_configurations():
    # granite: 40 layers of 2·2048² + 2·2048·512 + 3·2048·8192 weights, and
    # the head; 6·N·T plus the causal attention's 12·D a pair a head
    n = 40 * (2 * 2048 * 2048 + 2 * 2048 * 512 + 3 * 2048 * 8192) + 2048 * 49155
    assert flops.body_weights(GRANITE) + flops.head_weights(GRANITE) == n
    want = 6 * n * 8192 + 12 * 64 * 32 * 40 * 2 * flops.causal_pairs(4096)
    assert flops.train_step_flops(GRANITE, 2, 4096) == pytest.approx(want)
    assert want == pytest.approx(1.41e14, rel=0.01)
    # hubert: the frame projection counts, attention is not causal
    n = 48 * (4 * 1280 * 1280 + 2 * 1280 * 5120) + 1024 * 1280 + 1280 * 504
    want = 6 * n * 8192 + 12 * 80 * 16 * 48 * 8 * 1024 * 1024
    assert flops.train_step_flops(HUBERT, 8, 1024) == pytest.approx(want)
    assert want == pytest.approx(5.27e13, rel=0.01)


def test_serving_flops():
    body = flops.body_weights(GRANITE)
    head = flops.head_weights(GRANITE)
    per_pair = 4 * 64 * 32 * 40
    assert flops.prefill_flops(GRANITE, [(0, 3), (0, 5)]) == pytest.approx(
        2 * body * 8 + per_pair * (6 + 15) + 2 * 2 * head)
    # a span after a cached prefix or an earlier chunk: its tokens through
    # the body, their pairs over the whole prefix, one head row
    assert flops.prefill_flops(GRANITE, [(3, 5)]) == pytest.approx(
        2 * body * 2 + per_pair * (4 + 5) + 2 * head)
    assert flops.decode_flops(GRANITE, [9, 0]) == pytest.approx(
        2 * 2 * (body + head) + per_pair * (10 + 1))
