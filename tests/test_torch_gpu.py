"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; the ``cuda`` fixture skips them where no card is present
(this is decided when a test runs, never at import or collection). On the
card: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
The same checks, at the serving and training paths' full shapes, are in
``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import decode as kdecode  # noqa: E402
from repro_torch.kernels import flash_bwd as kbwd  # noqa: E402
from repro_torch.kernels import flash_fwd as kfwd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.steps import (make_serve_steps, make_train_step,  # noqa: E402
                                       place_batch)
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.serving import (PagedCacheConfig, ServingEngine,  # noqa: E402
                                 TRASH_PAGE)

pytestmark = pytest.mark.gpu

# kernel vs plain version: f32 sums in another order (the JAX suite's f32
# tolerance); bf16: two bf16 ulps at |o| <= 1 (P and o rounded on both sides)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
# backward kernel vs plain version, relative to max(1, max|plain|): f32 the
# JAX suite's gradient tolerance (dK/dV sum over every q row and the group);
# bf16 inputs or bf16-ACC two bf16 ulps (P~, dS, the tile products and the
# outputs are rounded to bf16 on both sides, and an f32 sum in another order
# can land a product on the other side of a rounding boundary)
BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2.0 ** -6}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


FWD = {
    # b, hq, hkv, sq, skv, d, kwargs
    "causal": (2, 8, 2, 200, 200, 64, dict(causal=True)),
    "window": (2, 8, 2, 200, 200, 64, dict(causal=True, window=50)),
    "segments": (2, 4, 4, 160, 160, 32, dict(causal=True, segments=True)),
    "dropout": (1, 4, 2, 130, 130, 64, dict(dropout_rate=0.4, dropout_seed=-3)),
    "q_suffix": (2, 4, 1, 40, 190, 16, dict(causal=True)),
    "d128_gqa5": (1, 10, 2, 96, 96, 128, dict(causal=True)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(FWD))
def test_flash_fwd_kernel_matches_plain(cuda, name, dtype):
    b, hq, hkv, sq, skv, d, kw = FWD[name]
    kw = dict(kw)
    q = _rand(cuda, (b, hq, sq, d), dtype)
    k = _rand(cuda, (b, hkv, skv, d), dtype)
    v = _rand(cuda, (b, hkv, skv, d), dtype)
    if kw.pop("segments", False):
        seg = torch.arange(skv, device="cuda", dtype=torch.int32) // 50
        seg = seg.repeat(b, 1)
        seg[:, -9:] = -1
        kw["segment_ids"] = seg
    before = kfwd.launches
    o, lse = kfwd.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kfwd.launches == before + 1
    o_ref, lse_ref = kfwd.flash_fwd_torch(q, k, v, **kw)
    assert _err(o, o_ref) <= TOL[dtype]
    assert _err(lse, lse_ref) <= 1e-4
    if "segment_ids" in kw:
        assert float(o[:, :, -9:].abs().max()) == 0.0
    if dtype == torch.float32:
        o_naive = ref.naive_mha(q, k, v, **kw)
        assert _err(o, o_naive) <= TOL[dtype]


def _fwd_check(gen, b, hq, hkv, sq, skv, d, dtype, acc=torch.float32, **kw):
    """The forward kernel against its plain version (and, for f32, the
    naive oracle) on one case, launched twice: the two launches bit-equal.
    Returns (o, lse)."""
    q = _rand(gen, (b, hq, sq, d), dtype)
    k = _rand(gen, (b, hkv, skv, d), dtype)
    v = _rand(gen, (b, hkv, skv, d), dtype)
    o, lse = kfwd.flash_fwd(q, k, v, acc_dtype=acc, **kw)
    o2, lse2 = kfwd.flash_fwd(q, k, v, acc_dtype=acc, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_ref, lse_ref = kfwd.flash_fwd_torch(q, k, v, acc_dtype=acc, **kw)
    bf16 = torch.bfloat16 in (dtype, acc)
    assert _err(o, o_ref) <= TOL[torch.bfloat16 if bf16 else torch.float32]
    # bf16-ACC rounds the scores to bf16 before the softmax (as in
    # test_flash_fwd_bf16_acc_kernel_matches_plain)
    assert _err(lse, lse_ref) <= (2e-3 if acc == torch.bfloat16 else 1e-4)
    if not bf16:
        assert _err(o, ref.naive_mha(q, k, v, **kw)) <= TOL[torch.float32]
    return o, lse


@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", kfwd.HEAD_DIMS)
def test_flash_fwd_head_dims(cuda, d, dtype, acc):
    """Every head dim the kernel is built for, f32 and bf16 inputs, f32 and
    bf16 accumulation: causal GQA, q a ragged suffix of kv."""
    _fwd_check(cuda, 2, 8, 2, 150, 230, d, dtype, acc, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq", [1, 63, 65, 127])
def test_flash_fwd_short_q_over_long_kv(cuda, sq, dtype):
    """A few q rows (less than one block, one warp and a row, a block less
    one row) as the suffix of 1000 kv rows, causal."""
    _fwd_check(cuda, 2, 8, 2, sq, 1000, 64, dtype, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [20, 64, 128])
def test_flash_fwd_window_edges(cuda, window, dtype):
    """A window inside one KV tile, and windows at one and two tiles, where
    tiles pass between the unmasked and the masked path."""
    _fwd_check(cuda, 2, 8, 2, 300, 300, 64, dtype, causal=True, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_dropout_window_segments(cuda, dtype):
    """Dropout, a window and packed segments together on a q suffix: rows
    of padding (segment -1) are exact zeros with lse NEG_INF."""
    skv, sq = 260, 200
    seg = (torch.arange(skv, device="cuda", dtype=torch.int32) // 70).repeat(2, 1)
    seg[:, -30:] = -1
    o, lse = _fwd_check(cuda, 2, 8, 2, sq, skv, 64, dtype, causal=True,
                        window=70, segment_ids=seg, dropout_rate=0.2,
                        dropout_seed=-5)
    assert float(o[:, :, -30:].abs().max()) == 0.0
    assert bool((lse[:, :, -30:] == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("hq,d,window", [(8, 64, None), (8, 64, 300),
                                         (10, 128, None), (4, 16, None)])
def test_flash_decode_kernel_matches_plain(cuda, hq, d, window, num_splits,
                                           dtype):
    b, hkv, s = 4, 2, 1000
    q = _rand(cuda, (b, hq, d), dtype)
    k = _rand(cuda, (b, hkv, s, d), dtype)
    v = _rand(cuda, (b, hkv, s, d), dtype)
    kv_len = torch.tensor([1000, 0, 129, 700], dtype=torch.int32, device="cuda")
    before = kdecode.launches
    o = kdecode.flash_decode(q, k, v, kv_len=kv_len, window=window,
                             num_splits=num_splits)
    torch.cuda.synchronize()
    assert kdecode.launches == before + 1
    o_ref = kdecode.flash_decode_torch(q, k, v, kv_len=kv_len, window=window,
                                       num_splits=num_splits)
    assert _err(o, o_ref) <= TOL[dtype]
    assert float(o[1].abs().max()) == 0.0
    if dtype == torch.float32:
        o_naive = ops.decode_reference(q, k, v, kv_len=kv_len, window=window)
        assert _err(o, o_naive) <= TOL[dtype]


def _paged(gen, b, hq, hkv, d, ps, t, dtype, extra=3):
    """q, a pool of 1 + b*t + extra pages and shuffled int32 tables."""
    n_pages = 1 + b * t + extra
    q = _rand(gen, (b, hq, d), dtype)
    kp = _rand(gen, (hkv, n_pages, ps, d), dtype)
    vp = _rand(gen, (hkv, n_pages, ps, d), dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = perm[:b * t].view(b, t).to(torch.int32).contiguous()
    return q, kp, vp, bt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("hq,ps,window", [(8, 16, None), (10, 4, 45),
                                          (8, 32, 200), (8, 64, None)])
def test_flash_paged_decode_kernel_matches_plain(cuda, hq, ps, window,
                                                 num_splits, dtype):
    b, hkv, d, t = 4, 2, 64, 640 // ps
    q, kp, vp, bt = _paged(cuda, b, hq, hkv, d, ps, t, dtype)
    kv_len = torch.tensor([t * ps, 0, 129, 333], dtype=torch.int32,
                          device="cuda")
    before = kdecode.launches_paged
    o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, window=window,
                                   num_splits=num_splits)
    torch.cuda.synchronize()
    assert kdecode.launches_paged == before + 1
    o_ref = kdecode.flash_paged_decode_torch(q, kp, vp, bt, kv_len=kv_len,
                                             window=window,
                                             num_splits=num_splits)
    assert _err(o, o_ref) <= TOL[dtype]
    assert float(o[1].abs().max()) == 0.0
    # the contiguous kernel on the gathered pages walks the same tiles
    o_contig = kdecode.flash_decode(q, kdecode.gather_pages(kp, bt),
                                    kdecode.gather_pages(vp, bt), kv_len=kv_len,
                                    window=window, num_splits=num_splits)
    assert _err(o, o_contig) == 0.0
    if dtype == torch.float32:
        o_naive = ops.paged_decode_reference(q, kp, vp, bt, kv_len,
                                             window=window)
        assert _err(o, o_naive) <= TOL[dtype]


@pytest.mark.parametrize("window", [None, 40])
def test_flash_paged_decode_poisoned_trash_is_inert(cuda, window):
    b, hq, hkv, d, ps, t = 3, 8, 2, 64, 16, 12
    q, kp, vp, bt = _paged(cuda, b, hq, hkv, d, ps, t, torch.float32)
    kv_len = torch.tensor([19, 100, 0], dtype=torch.int32, device="cuda")
    bt[0, 2:] = TRASH_PAGE                   # past each row's allocation
    bt[1, 7:] = TRASH_PAGE
    bt[2] = TRASH_PAGE
    if window is not None:
        bt[1, :3] = TRASH_PAGE               # reclaimed: out of the window
    clean = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, window=window)
    kp[:, TRASH_PAGE] = 1e6
    vp[:, TRASH_PAGE] = 1e6
    poisoned = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, window=window)
    torch.cuda.synchronize()
    assert _err(clean, poisoned) == 0.0
    assert float(poisoned[2].abs().max()) == 0.0


def test_flash_paged_decode_token_rows(cuda):
    """Chunked prefill's shape: B·S token rows through one launch, padding
    rows with kv_len 0 exact zeros."""
    hq, hkv, d, ps, t = 8, 2, 64, 16, 40
    q1, kp, vp, bt = _paged(cuda, 1, hq, hkv, d, ps, t, torch.float32)
    n = 300
    q = _rand(cuda, (n, hq, d), torch.float32)
    tables = bt.expand(n, t).contiguous()
    kv_len = (torch.arange(n, device="cuda", dtype=torch.int32) + 200)
    kv_len[250:] = 0
    o = kdecode.flash_paged_decode(q, kp, vp, tables, kv_len, num_splits=2,
                                   row_tokens=n)
    o_ref = kdecode.flash_paged_decode_torch(q, kp, vp, tables, kv_len=kv_len,
                                             num_splits=2)
    assert _err(o, o_ref) <= TOL[torch.float32]
    assert float(o[250:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv", [(8, 32, 8), (16, 64, 16), (32, 32, 8),
                                      (64, 32, 8)])
def test_flash_paged_decode_clusters(cuda, b, hq, hkv, dtype):
    """The decode shape below and above one cluster a SM: B·Hkv 64 takes
    clusters that put a block on every SM, 256 and 512 one block a cluster,
    and a decode of more than 16 slots (each its own table) still one row
    a block; all against the plain version, kv_len 0 rows exact zeros, two
    launches bit-equal, the paged kernel equal to the contiguous one."""
    d, ps, t = 64, 16, 37
    q, kp, vp, bt = _paged(cuda, b, hq, hkv, d, ps, t, dtype)
    kv_len = torch.randint(528, 577, (b,), generator=cuda, device="cuda",
                           dtype=torch.int32)
    kv_len[1] = 0
    geo = kdecode.launch_geometry(b, hq, hkv, t * ps)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert geo["rows_per_block"] == 1 and geo["blocks"] >= sms
    assert (geo["cluster"] > 1) == (b * hkv < sms)
    o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len)
    again = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len)
    torch.cuda.synchronize()
    assert _err(o, again) == 0.0
    assert _err(o, kdecode.flash_paged_decode_torch(q, kp, vp, bt,
                                                    kv_len=kv_len)) <= TOL[dtype]
    assert float(o[1].abs().max()) == 0.0
    o_contig = kdecode.flash_decode(q, kdecode.gather_pages(kp, bt),
                                    kdecode.gather_pages(vp, bt), kv_len=kv_len)
    assert _err(o, o_contig) == 0.0


def _token_rows(gen, hq, hkv, d, ps, spans, pads, dtype):
    """Token rows of several sequences through one pool, as a packed chunk
    row or a verify launch holds them: ``spans`` (history, new tokens) per
    sequence, each its own table, a row a new token reading ``position +
    1`` keys; then ``pads`` rows of the trash table with kv_len 0. The
    trash page holds 1e6."""
    t = max(-(-(h + n) // ps) for h, n in spans) + 1
    _, kp, vp, bt = _paged(gen, len(spans), hq, hkv, d, ps, t, dtype)
    kp[:, TRASH_PAGE] = vp[:, TRASH_PAGE] = 1e6
    tables, kv_len = [], []
    for i, (h, n) in enumerate(spans):
        table = bt[i].clone()
        table[-(-(h + n) // ps):] = TRASH_PAGE
        tables += [table] * n
        kv_len += list(range(h + 1, h + n + 1))
    tables += [torch.full_like(bt[0], TRASH_PAGE)] * pads
    kv_len += [0] * pads
    q = _rand(gen, (len(kv_len), hq, d), dtype)
    return (q, kp, vp, torch.stack(tables).contiguous(),
            torch.tensor(kv_len, dtype=torch.int32, device="cuda"))


# (spans, pads, row_tokens): a packed chunk row of three sequences and
# padding (one batch row of 24 tokens); verify over four slots of 5 rows,
# one idle; one long run over 256 rows
TOKEN_ROWS = {
    "chunk": ([(40, 9), (0, 7), (70, 5)], 3, 24),
    "verify": ([(33, 5), (60, 5), (11, 5)], 5, 5),
    "one_table": ([(300, 256)], 0, 256),
}
# (hq, hkv, d): GQA groups of 4 and 5 (qwen3-14b's D 128 with G 5: 12 token
# rows a block, 60 query rows)
TILE_HEADS = [(8, 2, 64), (8, 2, 32), (10, 2, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("hq,hkv,d", TILE_HEADS)
@pytest.mark.parametrize("shape", list(TOKEN_ROWS))
def test_flash_paged_decode_query_tiles(cuda, shape, hq, hkv, d, window, dtype):
    """Launches that say their rows are token rows of one batch row
    (row_tokens) fold each tile once for every run of rows with one table:
    rows of mixed tables against the plain version (padding rows exact
    zeros) and against the one-row path, the contiguous kernel on the
    gathered pages bit for bit, two launches bit-equal, launches counted."""
    ps = 16
    spans, pads, rt = TOKEN_ROWS[shape]
    q, kp, vp, bt, kv_len = _token_rows(cuda, hq, hkv, d, ps, spans, pads, dtype)
    geo = kdecode.launch_geometry(q.shape[0], hq, hkv, bt.shape[1] * ps,
                                  row_tokens=rt, head_dim=d, dtype=dtype)
    assert geo["rows_per_block"] == min(rt, 16, 64 // (hq // hkv))
    before = kdecode.launches_paged
    o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, window=window,
                                   row_tokens=rt)
    again = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, window=window,
                                       row_tokens=rt)
    one_row = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, window=window)
    torch.cuda.synchronize()
    assert kdecode.launches_paged == before + 3
    assert _err(o, again) == 0.0
    o_ref = kdecode.flash_paged_decode_torch(q, kp, vp, bt, kv_len=kv_len,
                                             window=window)
    assert _err(o, o_ref) <= TOL[dtype]
    assert _err(one_row, o_ref) <= TOL[dtype]
    if bool((kv_len == 0).any()):
        assert float(o[kv_len == 0].abs().max()) == 0.0
    o_contig = kdecode.flash_decode(q, kdecode.gather_pages(kp, bt),
                                    kdecode.gather_pages(vp, bt), kv_len=kv_len,
                                    window=window, row_tokens=rt)
    assert _err(o, o_contig) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", [(10, 2, 64), (8, 2, 32), (10, 2, 128)])
@pytest.mark.parametrize("shape", list(TOKEN_ROWS))
def test_flash_paged_decode_partials_query_tiles(cuda, shape, hq, hkv, d, dtype):
    """The gated kernel at the same token rows, one shard's view: a table's
    foreign entries name the trash page with valid 0, so rows of one
    sequence share table and ownership; padding rows keep the empty
    state."""
    ps = 16
    spans, pads, rt = TOKEN_ROWS[shape]
    q, kp, vp, bt, kv_len = _token_rows(cuda, hq, hkv, d, ps, spans, pads, dtype)
    valid = ((bt < kp.shape[1] // 2) | (bt == TRASH_PAGE)).to(torch.int32)
    bt = torch.where(valid == 1, bt, TRASH_PAGE).to(torch.int32).contiguous()
    before = kdecode.launches_paged_valid
    acc, m, l = kdecode.flash_paged_decode_partials(q, kp, vp, bt, kv_len,
                                                    block_valid=valid,
                                                    row_tokens=rt)
    torch.cuda.synchronize()
    assert kdecode.launches_paged_valid == before + 1
    ref = kdecode.flash_paged_decode_partials_torch(q, kp, vp, bt, kv_len=kv_len,
                                                    block_valid=valid)
    (o, lse), (o_ref, lse_ref) = _state_out(acc, m, l), _state_out(*ref)
    assert _err(o, o_ref) <= TOL[dtype]
    read = ref[2] > 0
    assert _err(lse[read], lse_ref[read]) <= 1e-4
    if bool((~read).any()):
        assert float(acc[~read].abs().max()) == 0.0
        assert bool((m[~read] == -1e30).all())


def _state_out(acc, m, l):
    """The normalised output and log-sum-exp of a partial state."""
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return acc / l_safe[..., None], m + torch.log(l_safe)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("hq,ps,window", [(8, 16, None), (10, 4, 45),
                                          (8, 32, 200)])
def test_flash_paged_decode_partials_kernel_matches_plain(cuda, hq, ps, window,
                                                          num_splits, dtype):
    """The gated kernel against its plain version: about half of the table
    entries are not owned and still name their pages, which hold 1e6, as
    does the trash page; a row owning nothing keeps the empty state."""
    b, hkv, d, t = 4, 2, 64, 640 // ps
    q, kp, vp, bt = _paged(cuda, b, hq, hkv, d, ps, t, dtype)
    valid = (torch.rand((b, t), generator=cuda, device="cuda") < 0.5).to(torch.int32)
    valid[2] = 0
    foreign = bt[valid == 0].long()
    for pool in (kp, vp):
        pool[:, foreign] = 1e6
        pool[:, TRASH_PAGE] = 1e6
    kv_len = torch.tensor([t * ps, 0, 333, 129], dtype=torch.int32, device="cuda")
    before = kdecode.launches_paged_valid
    acc, m, l = kdecode.flash_paged_decode_partials(
        q, kp, vp, bt, kv_len, block_valid=valid, window=window,
        num_splits=num_splits)
    torch.cuda.synchronize()
    assert kdecode.launches_paged_valid == before + 1
    ref = kdecode.flash_paged_decode_partials_torch(
        q, kp, vp, bt, kv_len=kv_len, block_valid=valid, window=window,
        num_splits=num_splits)
    (o, lse), (o_ref, lse_ref) = _state_out(acc, m, l), _state_out(*ref)
    assert _err(o, o_ref) <= TOL[dtype]
    assert _err(lse, lse_ref) <= 1e-4
    for row in (1, 2):                      # reads nothing / owns nothing
        assert float(acc[row].abs().max()) == 0.0 and float(l[row].max()) == 0.0
        assert bool((m[row] == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_shards_of_the_gated_kernel_equal_the_paged_kernel(cuda, dtype):
    """The pool cut into two shards, each with its tables remapped to local
    ids and its trash page poisoned: the merged partials are the ungated
    paged kernel on the whole pool."""
    from repro_torch.core import online_softmax as osm
    from repro_torch.distributed.paged import _local_ids

    b, hq, hkv, d, ps, t = 4, 8, 2, 64, 16, 24
    n_local = 1 + b * t // 2
    q = _rand(cuda, (b, hq, d), dtype)
    kp = _rand(cuda, (hkv, 2 * n_local, ps, d), dtype)
    vp = _rand(cuda, (hkv, 2 * n_local, ps, d), dtype)
    usable = torch.tensor([p for p in range(2 * n_local) if p % n_local],
                          device="cuda")
    perm = torch.randperm(usable.numel(), generator=cuda, device="cuda")
    bt = usable[perm].view(b, t).to(torch.int32).contiguous()
    kv_len = torch.tensor([t * ps, 200, 0, 31], dtype=torch.int32, device="cuda")
    whole = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, num_splits=2)
    states = []
    for s in range(2):
        kl = kp[:, s * n_local:(s + 1) * n_local].clone()
        vl = vp[:, s * n_local:(s + 1) * n_local].clone()
        kl[:, 0] = vl[:, 0] = 1e6
        bt_local, valid = _local_ids(bt, n_local, s)
        acc, m, l = kdecode.flash_paged_decode_partials(
            q, kl, vl, bt_local.contiguous(), kv_len,
            block_valid=valid.contiguous(), num_splits=2)
        states.append(osm.SoftmaxState(m=m, l=l, acc=acc))
    o, _ = osm.finalize(osm.merge(*states), out_dtype=dtype)
    torch.cuda.synchronize()
    assert _err(o, whole) <= TOL[dtype]
    assert float(o[2].abs().max()) == 0.0


def _sharded_engine_rank(mesh, device, cfg, pcfg, reqs):
    """A rank of the sharded SMOKE engine test: its tokens and launches."""
    params = lm.init_params(cfg, seed=0, device=device)
    eng = ServingEngine(cfg, pcfg, params, impl="kernel", device=device,
                        mesh=mesh, prefill_len=64, lazy=True, prefill_chunk=32)
    before = (kdecode.launches_paged, kdecode.launches_paged_valid)
    out, stats = eng.run(list(reqs))        # logits reach the host each step
    return out, stats, (kdecode.launches_paged - before[0],
                        kdecode.launches_paged_valid - before[1])


def test_sharded_paged_engine_on_the_card(cuda):
    """Two gloo ranks sharing the card serve a SMOKE model through the gated
    kernel (never the ungated one) and generate what one device does."""
    from repro_torch.launch.mesh import run_ranks

    cfg = dataclasses.replace(configs.smoke_config("granite_3_2b"),
                              dtype=torch.float32)
    rs = np.random.RandomState(0)
    reqs = [(rs.randint(0, cfg.vocab_size, size=n), g)
            for n, g in ((40, 12), (25, 20), (33, 8), (50, 16), (12, 10))]
    pcfg = PagedCacheConfig(page_size=8, num_pages=24, max_batch=3,
                            max_pages_per_seq=10)
    params = lm.init_params(cfg, seed=0, device="cuda")
    want, _ = ServingEngine(cfg, pcfg, params, impl="kernel", device="cuda",
                            prefill_len=64, lazy=True, prefill_chunk=32).run(list(reqs))
    ranks = run_ranks(_sharded_engine_rank, 2,
                      (cfg, dataclasses.replace(pcfg, num_pages=24, num_shards=2),
                       reqs), backend="gloo", device_type="cuda", timeout_s=600)
    for out, stats, (ungated, gated) in ranks:
        assert ungated == 0 and gated > 0 and gated % cfg.num_layers == 0
        assert stats["outcomes"]["completed"] == len(reqs)
        for rid in want:
            assert (out[rid] == want[rid]).all(), rid
    # NCCL needs a card a rank: on one card, a mesh of one rank still runs
    # its init, collectives and object broadcast
    (out, stats, (ungated, gated)), = run_ranks(
        _sharded_engine_rank, 1, (cfg, pcfg, reqs), backend="nccl",
        device_type="cuda", timeout_s=600)
    assert ungated == 0 and gated > 0
    for rid in want:
        assert (out[rid] == want[rid]).all(), rid


def test_paged_engine_kernel_matches_torch(cuda):
    """A SMOKE paged engine (lazy, chunked prefill, speculation) with
    impl="kernel" generates what impl="torch" does, and its paged attention
    went through the kernel once a layer per decode / chunk / verify call."""
    cfg = dataclasses.replace(configs.smoke_config("granite_3_2b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device="cuda")
    rs = np.random.RandomState(0)
    reqs = [(rs.randint(0, cfg.vocab_size, size=n), g)
            for n, g in ((40, 12), (25, 20), (33, 8), (50, 16), (12, 10))]
    pcfg = PagedCacheConfig(page_size=8, num_pages=24, max_batch=3,
                            max_pages_per_seq=10)
    outs = {}
    for impl in ("kernel", "torch"):
        eng = ServingEngine(cfg, pcfg, params, impl=impl, device="cuda",
                            prefill_len=64, lazy=True, prefill_chunk=32,
                            speculate_k=2)
        before = (kfwd.launches, kdecode.launches_paged)
        outs[impl], stats = eng.run(list(reqs))
        torch.cuda.synchronize()
        launched = (kfwd.launches - before[0],
                    kdecode.launches_paged - before[1])
        if impl == "kernel":
            assert launched[1] > 0 and launched[1] % cfg.num_layers == 0
        else:
            assert launched == (0, 0)
        assert stats["outcomes"]["completed"] == len(reqs)
    for rid in outs["torch"]:
        assert (outs["kernel"][rid] == outs["torch"][rid]).all(), rid


def test_autotuned_engine_on_the_card(cuda, tmp_path, monkeypatch):
    """A SMOKE engine built with autotune=True on the card serves the tokens
    of num_splits=1, and the plan it persisted names the card; a cached plan
    of three splits is taken and serves them too."""
    import json

    from repro_torch.perf.autotune import AutotuneCache, DecodeShape, LaunchPlan

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    cfg = dataclasses.replace(configs.smoke_config("granite_3_2b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device="cuda")
    rs = np.random.RandomState(0)
    reqs = [(rs.randint(0, cfg.vocab_size, size=n), g)
            for n, g in ((140, 12), (25, 20), (133, 8), (150, 16), (12, 10))]
    pcfg = PagedCacheConfig(page_size=8, num_pages=72, max_batch=3,
                            max_pages_per_seq=22)
    kw = dict(impl="kernel", device="cuda", prefill_len=176)
    want, _ = ServingEngine(cfg, pcfg, params, num_splits=1, **kw).run(list(reqs))
    name = torch.cuda.get_device_name(0)
    shape = DecodeShape(batch=3, hkv=cfg.num_kv_heads,
                        group=cfg.num_heads // cfg.num_kv_heads, kv_len=176,
                        head_dim=cfg.head_dim, page_size=8, dtype_bytes=4)
    eng = ServingEngine(cfg, pcfg, params, autotune=True, **kw)
    raw = json.loads((tmp_path / "at.json").read_text())
    assert raw[shape.key()]["device"] == name
    assert raw[shape.key()]["num_splits"] == eng.num_splits
    cache = AutotuneCache(device=name)
    cache.put(shape, LaunchPlan(num_splits=3, block_kv=64, time_s=1e-5))
    cache.save()
    eng_3 = ServingEngine(cfg, pcfg, params, autotune=True, **kw)
    assert eng_3.num_splits == 3
    for e in (eng, eng_3):
        before = kdecode.launches_paged
        out, stats = e.run(list(reqs))
        assert kdecode.launches_paged > before
        assert stats["outcomes"]["completed"] == len(reqs)
        for rid in want:
            assert (out[rid] == want[rid]).all(), rid


# ---- recurrentgemma-2b's attention: head dim 256, 10 query heads on one kv
# head, a sliding window; the kernels take 32-row ring tiles there ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["window", "segments", "suffix"])
def test_flash_fwd_head_dim_256_group_10(cuda, case, dtype):
    """The forward at the hybrid's geometry: causal with a window shorter
    than the sequence (whole tiles behind every row's window), packed
    segments with padding, and a q suffix."""
    b, hq, hkv, d = 2, 10, 1, 256
    if case == "window":
        _fwd_check(cuda, b, hq, hkv, 700, 700, d, dtype, causal=True, window=200)
    elif case == "suffix":
        _fwd_check(cuda, b, hq, hkv, 90, 333, d, dtype, causal=True, window=120)
    else:
        seg = (torch.arange(400, device="cuda", dtype=torch.int32) // 130).repeat(b, 1)
        seg[:, -20:] = -1
        o, _ = _fwd_check(cuda, b, hq, hkv, 400, 400, d, dtype, causal=True,
                          window=100, segment_ids=seg)
        assert float(o[:, :, -20:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_splits", [1, 3])
def test_flash_decode_head_dim_256_group_10(cuda, num_splits, dtype):
    """The contiguous decode over a ring of 300 slots at 10/1 heads, D 256:
    ragged lengths with 0 against the plain version and the oracle."""
    b, hq, hkv, s, d = 4, 10, 1, 300, 256
    q = _rand(cuda, (b, hq, d), dtype)
    k = _rand(cuda, (b, hkv, s, d), dtype)
    v = _rand(cuda, (b, hkv, s, d), dtype)
    kv_len = torch.tensor([300, 0, 33, 257], dtype=torch.int32, device="cuda")
    o = kdecode.flash_decode(q, k, v, kv_len=kv_len, num_splits=num_splits)
    again = kdecode.flash_decode(q, k, v, kv_len=kv_len, num_splits=num_splits)
    torch.cuda.synchronize()
    assert _err(o, again) == 0.0
    o_ref = kdecode.flash_decode_torch(q, k, v, kv_len=kv_len,
                                       num_splits=num_splits)
    assert _err(o, o_ref) <= TOL[dtype]
    assert float(o[1].abs().max()) == 0.0
    if dtype == torch.float32:
        assert _err(o, ops.decode_reference(q, k, v, kv_len=kv_len)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("hq,d", [(10, 256), (4, 64)])
def test_flash_decode_partials_kernel_matches_plain(cuda, hq, d, num_splits,
                                                    dtype):
    """Row 4's shard-partials mode (one shard of a sequence-sharded cache,
    ``kv_cache_seq``): the raw f32 (acc, m, l) against the plain version at
    kv_len 0, inside the shard and on a full shard; m NEG_INF and l, acc 0
    where kv_len is 0; bit-equal across launches; finalised, the contiguous
    decode of the same slots."""
    from repro_torch.core import online_softmax as osm
    b, hkv, s = 4, 1 if hq == 10 else 2, 1024
    q = _rand(cuda, (b, hq, d), dtype)
    k = _rand(cuda, (b, hkv, s, d), dtype)
    v = _rand(cuda, (b, hkv, s, d), dtype)
    kv_len = torch.tensor([0, 1, 700, 1024], dtype=torch.int32, device="cuda")
    before = kdecode.launches_partials
    got = kdecode.flash_decode_partials(q, k, v, kv_len=kv_len,
                                        num_splits=num_splits)
    again = kdecode.flash_decode_partials(q, k, v, kv_len=kv_len,
                                          num_splits=num_splits)
    torch.cuda.synchronize()
    assert kdecode.launches_partials == before + 2
    want = kdecode.flash_decode_partials(q.cpu(), k.cpu(), v.cpu(),
                                         kv_len=kv_len.cpu(),
                                         num_splits=num_splits)
    acc, m, l = got
    assert all(_err(a, b_) == 0.0 for a, b_ in zip(got, again))
    assert bool((m[0] == osm.NEG_INF).all())
    assert float(l[0].abs().max()) == 0.0 == float(acc[0].abs().max())
    live = kv_len.cpu() > 0
    tol = TOL[dtype]
    assert _err(m.cpu()[live], want[1][live]) <= tol * max(
        1.0, float(want[1][live].abs().max()))
    o, _ = osm.finalize(osm.SoftmaxState(m=m, l=l, acc=acc), out_dtype=q.dtype)
    o_ref = kdecode.flash_decode(q, k, v, kv_len=kv_len, num_splits=num_splits)
    assert _err(o, o_ref) <= tol
    o_plain, _ = osm.finalize(osm.SoftmaxState(m=want[1], l=want[2],
                                               acc=want[0]), out_dtype=q.dtype)
    assert _err(o.cpu(), o_plain) <= tol


def _mesh_serve_rank(pool, device, shape, arch):
    """A rank of a contiguous serving mesh on the card: its tokens and the
    launches of the forward and of row 4 (whole and shard partials)."""
    from repro_torch.distributed.mesh import join_train_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = join_train_mesh(shape)
    cfg = dataclasses.replace(configs.smoke_config(arch), dtype=torch.float32)
    arts = make_serve_steps(cfg, max_len=48, batch=4, torch_chunk=16,
                            device=device, mesh=mesh)
    params = arts.init_fn(0)
    prompt = torch.arange(4 * 40, device=device).view(4, 40) % cfg.vocab_size
    kfwd.launches = kdecode.launches = kdecode.launches_partials = 0
    res = greedy_generate(arts, params, prompt, 8, cfg.vocab_size)
    return {"tokens": res.tokens.cpu().numpy(),
            "launches": (kfwd.launches, kdecode.launches,
                         kdecode.launches_partials)}


@pytest.mark.parametrize("arch,shape", [("granite_3_2b", {"data": 2, "model": 2}),
                                        ("recurrentgemma_2b", {"model": 2}),
                                        ("recurrentgemma_2b", {"model": 4})])
def test_contiguous_mesh_serving_on_the_card(cuda, arch, shape):
    """Gloo ranks sharing the card serve on the contiguous cache: tokens of
    one card; granite decodes its heads with row 4, the hybrid's ring is
    sharded over model (row 4's shard partials, merged). The 40-row prompt
    prefills under ``seq`` (20 or 10 rows a rank); on model 4 the hybrid's
    2 heads take ``seq_full``, 10 query rows a rank."""
    from repro_torch.launch.mesh import run_ranks
    size = int(np.prod(list(shape.values())))
    ranks = run_ranks(_mesh_serve_rank, size, (shape, arch), backend="gloo",
                      device_type="cuda", timeout_s=600)
    cfg = dataclasses.replace(configs.smoke_config(arch), dtype=torch.float32)
    arts = make_serve_steps(cfg, max_len=48, batch=4, torch_chunk=16,
                            device="cuda")
    prompt = torch.arange(4 * 40, device="cuda").view(4, 40) % cfg.vocab_size
    want = greedy_generate(arts, arts.init_fn(0), prompt, 8, cfg.vocab_size)
    attn = lm.block_kinds(cfg).count("attn")
    for r in ranks:
        np.testing.assert_array_equal(r["tokens"], want.tokens.cpu().numpy())
        fwd, dec, part = r["launches"]
        assert fwd == attn
        assert (dec, part) == ((0, 7 * attn) if arch == "recurrentgemma_2b"
                               else (7 * attn, 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", list(TOKEN_ROWS) + ["decode"])
def test_flash_paged_decode_head_dim_256_group_10(cuda, shape, dtype):
    """The paged decode at the hybrid's geometry with a window: decode rows
    (one row a block, 16 query rows) and token rows (query tiles of 6 token
    rows), against the plain version, the one-row path and the contiguous
    kernel on the gathered pages; the gated kernel at the same rows with
    about half the entries foreign."""
    hq, hkv, d, ps, window = 10, 1, 256, 16, 48
    if shape == "decode":
        b, t = 4, 12
        q, kp, vp, bt = _paged(cuda, b, hq, hkv, d, ps, t, dtype)
        kv_len = torch.tensor([t * ps, 0, 17, 100], dtype=torch.int32,
                              device="cuda")
        rt = 1
    else:
        spans, pads, rt = TOKEN_ROWS[shape]
        q, kp, vp, bt, kv_len = _token_rows(cuda, hq, hkv, d, ps, spans, pads,
                                            dtype)
    geo = kdecode.launch_geometry(q.shape[0], hq, hkv, bt.shape[1] * ps,
                                  row_tokens=rt, head_dim=d, dtype=dtype)
    assert geo["rows_per_block"] == (1 if rt == 1 else min(rt, 6))
    o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, window=window,
                                   row_tokens=rt)
    one_row = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, window=window)
    torch.cuda.synchronize()
    o_ref = kdecode.flash_paged_decode_torch(q, kp, vp, bt, kv_len=kv_len,
                                             window=window)
    assert _err(o, o_ref) <= TOL[dtype]
    assert _err(one_row, o_ref) <= TOL[dtype]
    if bool((kv_len == 0).any()):
        assert float(o[kv_len == 0].abs().max()) == 0.0
    o_contig = kdecode.flash_decode(q, kdecode.gather_pages(kp, bt),
                                    kdecode.gather_pages(vp, bt), kv_len=kv_len,
                                    window=window, row_tokens=rt)
    assert _err(o, o_contig) == 0.0
    valid = ((bt < kp.shape[1] // 2) | (bt == TRASH_PAGE)).to(torch.int32)
    bt = torch.where(valid == 1, bt, TRASH_PAGE).to(torch.int32).contiguous()
    acc, m, l = kdecode.flash_paged_decode_partials(
        q, kp, vp, bt, kv_len, block_valid=valid, window=window, row_tokens=rt)
    torch.cuda.synchronize()
    ref = kdecode.flash_paged_decode_partials_torch(
        q, kp, vp, bt, kv_len=kv_len, block_valid=valid, window=window)
    (og, _), (og_ref, _) = _state_out(acc, m, l), _state_out(*ref)
    assert _err(og, og_ref) <= TOL[dtype]


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = _rand(cuda, (1, 4, 64, 64), torch.float32)
    k = _rand(cuda, (1, 2, 64, 64), torch.float32)
    with pytest.raises(ValueError):
        kfwd.flash_fwd(q.transpose(2, 3), k, k)           # not contiguous
    with pytest.raises(TypeError):
        kfwd.flash_fwd(q.half(), k.half(), k.half())      # no fp16 kernel
    with pytest.raises(ValueError):
        kfwd.flash_fwd(q[..., :48].contiguous(), k[..., :48].contiguous(),
                       k[..., :48].contiguous())         # head_dim 48
    with pytest.raises(TypeError):
        kdecode.flash_decode(q[:, :, 0].contiguous(), k, k,
                             kv_len=torch.tensor([3], device="cuda"))  # int64
    with pytest.raises(ValueError):
        kdecode.flash_decode(_rand(cuda, (1, 18, 64), torch.float32), k, k)
    pool = _rand(cuda, (2, 5, 16, 64), torch.float32)
    kv_len = torch.tensor([3], dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):                        # int64 table
        kdecode.flash_paged_decode(q[:, :, 0].contiguous(), pool, pool,
                                   torch.tensor([[1, 2]], device="cuda"), kv_len)
    with pytest.raises(TypeError):                        # int64 block_valid
        kdecode.flash_paged_decode_partials(
            q[:, :, 0].contiguous(), pool, pool,
            torch.tensor([[1, 2]], dtype=torch.int32, device="cuda"), kv_len,
            block_valid=torch.tensor([[1, 0]], device="cuda"))
    odd = torch.zeros(pool.numel() + 1, device="cuda")[1:].view(pool.shape)
    with pytest.raises(ValueError, match="aligned"):      # 4-byte offset, D 64
        kdecode.flash_paged_decode(q[:, :, 0].contiguous(), odd, odd,
                                   torch.tensor([[1, 2]], dtype=torch.int32,
                                                device="cuda"), kv_len)


def test_serve_slice_kernel_matches_torch(cuda):
    cfg = dataclasses.replace(configs.smoke_config("qwen3_14b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=cuda,
                           device="cuda")
    def run(impl, feed=None):
        arts = make_serve_steps(cfg, impl=impl, max_len=50, batch=2,
                                device="cuda")
        return greedy_generate(arts, params, prompt, 8, cfg.vocab_size,
                               feed=feed)

    before = (kfwd.launches, kdecode.launches)
    rk = run("kernel")
    assert (kfwd.launches, kdecode.launches) == (before[0] + 2,
                                                 before[1] + 2 * 7)
    rt = run("torch", feed=rk.tokens)
    for lk, lt in zip(rk.logits, rt.logits):
        assert _err(lk, lt) <= 1e-4
    assert torch.equal(rk.tokens, rt.tokens)


def test_hybrid_full_width_serving_kernel_matches_torch(cuda):
    """recurrentgemma-2b at full width and depth (f32, random weights) on
    the contiguous cache: a 2100-token prompt past the 2048-token window
    (the ring rolls), 8 tokens; the kernel impl's greedy tokens equal the
    torch impl's, logits within 1e-3 of max|logit|, one forward launch an
    attention layer and one decode launch a layer a step."""
    cfg = dataclasses.replace(configs.get_config("recurrentgemma_2b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device="cuda")
    n_attn = lm.block_kinds(cfg).count("attn")
    prompt = torch.randint(0, cfg.vocab_size, (2, 2100), generator=cuda,
                           device="cuda")

    def run(impl, feed=None):
        arts = make_serve_steps(cfg, impl=impl, max_len=2108, batch=2,
                                torch_chunk=2100, device="cuda")
        return greedy_generate(arts, params, prompt, 8, cfg.vocab_size,
                               feed=feed)

    before = (kfwd.launches, kdecode.launches)
    rk = run("kernel")
    assert (kfwd.launches, kdecode.launches) == (before[0] + n_attn,
                                                 before[1] + n_attn * 7)
    rt = run("torch", feed=rk.tokens)
    for lk, lt in zip(rk.logits, rt.logits):
        assert _err(lk, lt) <= 1e-3 * float(lt.abs().max())
    assert torch.equal(rk.tokens, rt.tokens)


def _bwd_inputs(gen, b, hq, hkv, sq, skv, d, dtype):
    return (_rand(gen, (b, hq, sq, d), dtype), _rand(gen, (b, hkv, skv, d), dtype),
            _rand(gen, (b, hkv, skv, d), dtype), _rand(gen, (b, hq, sq, d), dtype))


@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(FWD))
def test_flash_bwd_kernels_match_plain(cuda, name, dtype, acc):
    b, hq, hkv, sq, skv, d, kw = FWD[name]
    kw = dict(kw)
    q, k, v, do = _bwd_inputs(cuda, b, hq, hkv, sq, skv, d, dtype)
    if kw.pop("segments", False):
        seg = torch.arange(skv, device="cuda", dtype=torch.int32) // 50
        seg = seg.repeat(b, 1)
        seg[:, -9:] = -1
        kw["segment_ids"] = seg
    o, lse = kfwd.flash_fwd(q, k, v, acc_dtype=acc, **kw)
    before = kbwd.launches_bwd
    grads = kbwd.flash_bwd(q, k, v, o, lse, do, acc_dtype=acc, **kw)
    again = kbwd.flash_bwd(q, k, v, o, lse, do, acc_dtype=acc, **kw)
    torch.cuda.synchronize()
    assert kbwd.launches_bwd == before + 2
    plain = kbwd.flash_bwd_torch(q, k, v, lse, do, kbwd.row_delta(o, do),
                                 acc_dtype=acc, **kw)
    tol = BWD_TOL[torch.bfloat16 if torch.bfloat16 in (dtype, acc) else dtype]
    for g, gp, x in zip(grads, plain, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert bool(torch.isfinite(g).all())
        assert _err(g, gp) <= tol * max(1.0, float(gp.abs().max()))
    # dK and dV are summed in a fixed order; dQ's atomic adds are not
    assert torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])
    assert _err(grads[0], again[0]) <= tol * max(1.0, float(plain[0].abs().max()))
    if "segment_ids" in kw:                    # padding: exact zero gradient
        assert float(grads[0][:, :, -9:].abs().max()) == 0.0
        assert float(grads[1][:, :, -9:].abs().max()) == 0.0


def _bwd_check(gen, b, hq, hkv, sq, skv, d, dtype, acc=torch.float32, **kw):
    """The backward kernel against its plain version on one case, launched
    twice (dK, dV bit-equal; dQ, summed by atomics, within the tolerance);
    padding tokens (segment id < 0) get exact zero gradients."""
    q, k, v, do = _bwd_inputs(gen, b, hq, hkv, sq, skv, d, dtype)
    o, lse = kfwd.flash_fwd(q, k, v, acc_dtype=acc, **kw)
    before = kbwd.launches_bwd
    grads = kbwd.flash_bwd(q, k, v, o, lse, do, acc_dtype=acc, **kw)
    again = kbwd.flash_bwd(q, k, v, o, lse, do, acc_dtype=acc, **kw)
    torch.cuda.synchronize()
    assert kbwd.launches_bwd == before + 2
    plain = kbwd.flash_bwd_torch(q, k, v, lse, do, kbwd.row_delta(o, do),
                                 acc_dtype=acc, **kw)
    tol = BWD_TOL[torch.bfloat16 if torch.bfloat16 in (dtype, acc) else dtype]
    for g, gp, x in zip(grads, plain, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert bool(torch.isfinite(g).all())
        assert _err(g, gp) <= tol * max(1.0, float(gp.abs().max()))
    assert torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])
    assert _err(grads[0], again[0]) <= tol * max(1.0, float(plain[0].abs().max()))
    seg = kw.get("segment_ids")
    if seg is not None:
        pad = seg[0] < 0
        assert float(grads[1][:, :, pad].abs().max()) == 0.0
        assert float(grads[2][:, :, pad].abs().max()) == 0.0
        assert float(grads[0][:, :, pad[skv - sq:]].abs().max()) == 0.0


@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", kbwd.HEAD_DIMS)
def test_flash_bwd_head_dims(cuda, d, dtype, acc):
    """Every head dim the backward kernel is built for, f32 and bf16 inputs,
    f32 and bf16 accumulation: causal GQA, q a ragged suffix of kv."""
    _bwd_check(cuda, 2, 8, 2, 150, 230, d, dtype, acc, causal=True)


@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["window_dropout", "segments", "suffix"])
def test_flash_bwd_head_dim_256_group_10(cuda, case, dtype, acc):
    """The backward at the hybrid's geometry (10 q heads on one kv head, D
    256): a window shorter than the sequence with dropout 0.1, packed
    segments with padding under a window, and a q suffix whose window
    starts inside a 32-row kv tile."""
    b, hq, hkv, d = 1, 10, 1, 256
    if case == "window_dropout":
        _bwd_check(cuda, b, hq, hkv, 700, 700, d, dtype, acc, causal=True,
                   window=200, dropout_rate=0.1, dropout_seed=17)
    elif case == "suffix":
        _bwd_check(cuda, b, hq, hkv, 90, 333, d, dtype, acc, causal=True,
                   window=120)
    else:
        seg = (torch.arange(400, device="cuda", dtype=torch.int32) // 130).repeat(b, 1)
        seg[:, -20:] = -1
        _bwd_check(cuda, b, hq, hkv, 400, 400, d, dtype, acc, causal=True,
                   window=100, segment_ids=seg)


def test_flash_fwd_bf16_acc_kernel_matches_plain(cuda):
    q, k, v, _ = _bwd_inputs(cuda, 2, 8, 2, 200, 200, 64, torch.bfloat16)
    o, lse = kfwd.flash_fwd(q, k, v, causal=True, acc_dtype=torch.bfloat16)
    o_ref, lse_ref = kfwd.flash_fwd_torch(q, k, v, causal=True,
                                          acc_dtype=torch.bfloat16)
    assert _err(o, o_ref) <= TOL[torch.bfloat16]
    assert _err(lse, lse_ref) <= 2e-3          # scores rounded to bf16


def test_mha_autograd_on_cuda_matches_naive(cuda):
    """ops.mha's backward launches the fused kernel and matches autograd of
    the naive oracle (f32, causal GQA with dropout and a q suffix)."""
    q, k, v, do = _bwd_inputs(cuda, 2, 8, 2, 96, 160, 64, torch.float32)
    cfg = ops.AttnConfig(causal=True, dropout_rate=0.1)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (kfwd.launches, kbwd.launches_bwd)
    ops.mha(*xs, seed=-7, config=cfg).backward(do)
    torch.cuda.synchronize()
    assert (kfwd.launches, kbwd.launches_bwd) == (before[0] + 1, before[1] + 1)
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    ref.naive_mha(*ys, causal=True, dropout_rate=0.1, dropout_seed=-7).backward(do)
    for x, y in zip(xs, ys):
        assert _err(x.grad, y.grad) <= 5e-5 * max(1.0, float(y.grad.abs().max()))


def test_train_step_kernel_matches_torch(cuda):
    """A SMOKE training step (packed batch, dropout 0.1, remat) through the
    kernels against impl="torch" from one state: loss, grad norm and every
    gradient leaf agree, and the kernels launch once a layer forward, once
    more in the recompute, and the backward kernel once a layer."""
    cfg = dataclasses.replace(configs.smoke_config("granite_3_2b"),
                              dtype=torch.float32, dropout_rate=0.1)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=96, global_batch=4,
                    seed=3, pack=True)
    batch = place_batch(make_batch(dc, 0), "cuda")
    n = cfg.num_layers
    out = {}
    for impl in ("kernel", "torch"):
        arts = make_train_step(cfg, opt=AdamWConfig(lr=1e-3), impl=impl,
                               torch_chunk=32, device="cuda")
        params, opt = arts.init_fn(5)
        ctx = Ctx(impl=impl, deterministic=False, seed=-99, torch_chunk=32)
        before = (kfwd.launches, kbwd.launches_bwd)
        lm.loss_fn(cfg, params, batch, ctx)[0].backward()
        grads = [p.grad.clone() for p in params.parameters()]
        params.zero_grad(set_to_none=True)
        _, _, m = arts.step_fn(params, opt, batch, 4)
        torch.cuda.synchronize()
        after = (kfwd.launches, kbwd.launches_bwd)
        want = (4 * n, 2 * n) if impl == "kernel" else (0, 0)
        assert tuple(a - b for a, b in zip(after, before)) == want
        out[impl] = (float(m["loss"]), float(m["grad_norm"]), grads)
    (lk, gk, dk), (lt, gt, dt) = out["kernel"], out["torch"]
    assert abs(lk - lt) <= 1e-5 * abs(lt)
    assert abs(gk - gt) <= 1e-4 * gt
    for a, b in zip(dk, dt):
        assert _err(a, b) <= 1e-4 * float(b.abs().max())


def test_hybrid_full_width_train_pass_kernel_matches_torch(cuda):
    """recurrentgemma-2b at full width and depth (26 layers, f32, random
    weights, remat, dropout 0.1) over 2100 tokens, past the 2048 window:
    one loss-and-grad pass through the kernels against impl="torch" on the
    same params and batch. The forward kernel launches twice an attention
    layer (forward and remat recompute), the backward kernel once (D 256,
    10/1 heads); loss, grad norm and the attention and RG-LRU leaves agree."""
    from repro_torch.optim import global_norm

    cfg = dataclasses.replace(configs.get_config("recurrentgemma_2b"),
                              dtype=torch.float32, dropout_rate=0.1, remat=True)
    params = lm.init_params(cfg, seed=0, device="cuda")
    n_attn = lm.block_kinds(cfg).count("attn")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=2100, global_batch=1,
                    seed=0)
    batch = place_batch(make_batch(dc, 0), "cuda")
    leaves = ("blocks.2.mixer.wq", "blocks.2.mixer.wk", "blocks.2.mixer.wv",
              "blocks.0.mixer.w_rec")
    out = {}
    for impl in ("kernel", "torch"):
        ctx = Ctx(impl=impl, deterministic=False, seed=-5, torch_chunk=512)
        before = (kfwd.launches, kbwd.launches_bwd)
        loss = lm.loss_fn(cfg, params, batch, ctx)[0]
        loss.backward()
        torch.cuda.synchronize()
        launched = (kfwd.launches - before[0], kbwd.launches_bwd - before[1])
        assert launched == ((2 * n_attn, n_attn) if impl == "kernel" else (0, 0))
        named = dict(params.named_parameters())
        out[impl] = (float(loss.detach()), float(global_norm(p.grad for p in params.parameters())),
                     {n: named[n].grad.clone() for n in leaves})
        params.zero_grad(set_to_none=True)
    (lk, gk, dk), (lt, gt, dt) = out["kernel"], out["torch"]
    assert abs(lk - lt) <= 1e-5 * abs(lt)
    assert abs(gk - gt) <= 1e-4 * gt
    for n in leaves:
        assert _err(dk[n], dt[n]) <= 1e-3 * float(dt[n].abs().max()), n


def test_trainer_resume_on_the_card_matches_straight(cuda, tmp_path):
    """4 steps straight ≡ 2 steps, a preemption and a resume to 4 on the
    card (SMOKE granite, packed batch, dropout 0.1, the kernels): every
    parameter within the reference's 1e-6 (tests/test_fault_tolerance.py
    test_resume_determinism), although the backward sums dQ by atomics."""
    cfg = dataclasses.replace(configs.smoke_config("granite_3_2b"),
                              dtype=torch.float32, dropout_rate=0.1)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=4,
                    seed=1, pack=True)

    def trainer(path):
        arts = make_train_step(cfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                               device="cuda")
        return Trainer(arts=arts, data_cfg=dc, tcfg=TrainerConfig(
            ckpt_dir=str(path), ckpt_every=100, log_every=1000))

    straight = trainer(tmp_path / "a").run(4)
    first = trainer(tmp_path / "b")
    first.hooks["pre_step"] = lambda s: first.request_preemption() if s == 1 else None
    stopped = first.run(4)
    assert stopped["preempted"] and stopped["stop_step"] == 2
    resumed = trainer(tmp_path / "b").run(4)
    assert resumed["stop_step"] == 4
    for a, b in zip(straight["params"].parameters(), resumed["params"].parameters()):
        assert _err(a.detach(), b.detach()) <= 1e-6


@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_flash_bwd_head_dim_128_group_1(cuda, dropout, dtype, acc):
    """deepseek-moe-16b's attention geometry in training (16/16 heads, D
    128, a GQA group of 1, causal, dropout 0.1 on its path) at 512 tokens:
    the backward kernel against its plain version."""
    _bwd_check(cuda, 2, 16, 16, 512, 512, 128, dtype, acc, causal=True,
               dropout_rate=dropout, dropout_seed=17)


def test_moe_full_width_layer_train_pass_kernel_matches_torch(cuda):
    """One deepseek-moe-16b layer at full width (d 2048, 16/16 heads, D 128,
    64 experts top 6 and 2 shared, f32, remat, dropout 0.1) over 2 × 1024
    tokens: a loss-and-grad pass through the kernels against impl="torch",
    the torch pass routed as the kernel pass was (a choice flipped by 1e-6
    in attention is counted, at most 1e-3 of the decisions). Loss, grad
    norm and the attention, router and expert leaves agree; the kernels
    launch 2 forward (with the recompute) and 1 backward."""
    from repro_torch.models.moe_routes import RouteRecorder
    from repro_torch.optim import global_norm

    cfg = dataclasses.replace(configs.get_config("deepseek_moe_16b"),
                              num_layers=1, dtype=torch.float32,
                              dropout_rate=0.1, remat=True)
    params = lm.init_params(cfg, seed=0, device="cuda")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, global_batch=2,
                    seed=0)
    batch = place_batch(make_batch(dc, 0), "cuda")
    leaves = ("blocks.0.mixer.wq", "blocks.0.mlp.router", "blocks.0.mlp.wi",
              "blocks.0.mlp.wo", "blocks.0.mlp.shared.wi", "lm_head")
    out, recorded = {}, None
    for impl in ("kernel", "torch"):
        ctx = Ctx(impl=impl, deterministic=False, seed=-5, torch_chunk=512)
        before = (kfwd.launches, kbwd.launches_bwd)
        with RouteRecorder(recorded) as rec:
            loss, met = lm.loss_fn(cfg, params, batch, ctx)
            loss.backward()
        torch.cuda.synchronize()
        launched = (kfwd.launches - before[0], kbwd.launches_bwd - before[1])
        assert launched == ((2, 1) if impl == "kernel" else (0, 0))
        assert len(rec.calls) == 2           # the forward and its recompute
        assert torch.equal(rec.calls[0], rec.calls[1])
        named = dict(params.named_parameters())
        out[impl] = (float(loss.detach()),
                     float(global_norm(p.grad for p in params.parameters())),
                     {n: named[n].grad.clone() for n in leaves})
        params.zero_grad(set_to_none=True)
        recorded = rec.calls
    assert rec.flips <= 1e-3 * rec.decisions
    (lk, gk, dk), (lt, gt, dt) = out["kernel"], out["torch"]
    assert abs(lk - lt) <= 1e-5 * abs(lt)
    assert abs(gk - gt) <= 1e-4 * gt
    for n in leaves:
        assert _err(dk[n], dt[n]) <= 1e-3 * float(dt[n].abs().max()), n


def test_mamba_full_width_scan_matches_the_step_loop(cuda):
    """One falcon-mamba-7b layer at full width (d 4096, Di 8192, N 16) on
    the card, batch 1 x 512 (two scan chunks, the state carried between
    them): the output and every input and weight gradient of the chunked
    scan within 5e-5 of each leaf's max of the sequential ``_ssm_step``
    loop's (the JAX suite's f32 gradient tolerance)."""
    from repro_torch.models import mamba

    cfg = dataclasses.replace(configs.get_config("falcon_mamba_7b"),
                              dtype=torch.float32)
    layer = mamba.init_mamba(cuda, cfg, torch.float32)
    x = torch.randn((1, 512, cfg.d_model), generator=cuda, device="cuda")
    w = torch.randn(x.shape, generator=cuda, device="cuda")

    def grads():
        xg = x.clone().requires_grad_()
        out = mamba.apply_mamba(layer, xg, Ctx(impl="kernel"), cfg)[0]
        (out * w).sum().backward()
        g = {n: q.grad for n, q in layer.named_parameters()}
        layer.zero_grad(set_to_none=True)
        return dict(g, out=out.detach(), x=xg.grad)

    chunked = grads()
    scan = mamba._ssm_scan
    mamba._ssm_scan = mamba._ssm_steps
    try:
        steps = grads()
    finally:
        mamba._ssm_scan = scan
    for name, want in steps.items():
        assert _err(chunked[name], want) <= 5e-5 * float(want.abs().max()), name


def test_mamba_paged_engine_on_the_card(cuda):
    """falcon-mamba-7b SMOKE through the paged engine on the card (lazy on
    a tight pool with poisoned released rows, chunked prefill): every
    request's tokens equal its single-sequence greedy run on the contiguous
    path; no page pool is allocated."""
    cfg = dataclasses.replace(configs.smoke_config("falcon_mamba_7b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device="cuda")
    rs = np.random.RandomState(0)
    reqs = [(rs.randint(0, cfg.vocab_size, size=n), g)
            for n, g in ((40, 12), (25, 20), (33, 8), (50, 16), (12, 10))]
    want = {}
    for rid, (toks, g) in enumerate(reqs):
        arts = make_serve_steps(cfg, impl="kernel", max_len=len(toks) + g,
                                batch=1, device="cuda")
        want[rid] = greedy_generate(arts, params, torch.as_tensor(
            toks, device="cuda")[None], g, cfg.vocab_size).tokens[0].cpu().numpy()
    pcfg = PagedCacheConfig(page_size=8, num_pages=12, max_batch=3,
                            max_pages_per_seq=10)
    eng = ServingEngine(cfg, pcfg, params, impl="kernel", device="cuda",
                        prefill_len=72, lazy=True, poison_reclaimed=True,
                        prefill_chunk=32)
    assert eng._pools() == []
    out, stats = eng.run(list(reqs))
    assert stats["outcomes"]["completed"] == len(reqs)
    assert stats["state_releases"] == len(reqs) + stats["preemptions"]
    for rid in want:
        assert (out[rid] == want[rid]).all(), rid


@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["full", "kv_longer", "dropout_segments"])
def test_flash_fwd_d80_non_causal(cuda, case, dtype, acc):
    """hubert-xlarge's attention (D 80, 16/16 heads, non-causal) at 300
    tokens: every kv tile read by every row, a ragged q suffix of a longer
    kv, and dropout with packed segments and padding."""
    if case == "full":
        _fwd_check(cuda, 2, 16, 16, 300, 300, 80, dtype, acc)
    elif case == "kv_longer":
        _fwd_check(cuda, 2, 16, 16, 130, 301, 80, dtype, acc)
    else:
        seg = (torch.arange(300, device="cuda", dtype=torch.int32) // 90).repeat(2, 1)
        seg[:, -25:] = -1
        o, lse = _fwd_check(cuda, 2, 16, 16, 300, 300, 80, dtype, acc,
                            segment_ids=seg, dropout_rate=0.1, dropout_seed=9)
        assert float(o[:, :, -25:].abs().max()) == 0.0
        assert bool((lse[:, :, -25:] == -1e30).all())


@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["full", "kv_longer", "dropout_segments"])
def test_flash_bwd_d80_non_causal(cuda, case, dtype, acc):
    """The backward at hubert-xlarge's geometry (D 80, non-causal): 64-row
    f32 / 128-row bf16 kv blocks, the dQ atomics at columns 0 and 40."""
    if case == "full":
        _bwd_check(cuda, 2, 16, 16, 300, 300, 80, dtype, acc)
    elif case == "kv_longer":
        _bwd_check(cuda, 2, 16, 16, 130, 301, 80, dtype, acc)
    else:
        seg = (torch.arange(300, device="cuda", dtype=torch.int32) // 90).repeat(2, 1)
        seg[:, -25:] = -1
        _bwd_check(cuda, 2, 16, 16, 300, 300, 80, dtype, acc, segment_ids=seg,
                   dropout_rate=0.1, dropout_seed=9)


def test_flash_bwd_d80_matches_naive_autograd(cuda):
    """ops.mha at D 80, non-causal, dropout 0.1 and a q suffix: the fused
    backward kernel against autograd of the naive oracle."""
    q, k, v, do = _bwd_inputs(cuda, 2, 4, 4, 70, 150, 80, torch.float32)
    cfg = ops.AttnConfig(causal=False, dropout_rate=0.1)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    ops.mha(*xs, seed=3, config=cfg).backward(do)
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    ref.naive_mha(*ys, causal=False, dropout_rate=0.1,
                  dropout_seed=3).backward(do)
    for x, y in zip(xs, ys):
        assert _err(x.grad, y.grad) <= 5e-5 * max(1.0, float(y.grad.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_splits", [1, 3])
def test_flash_decode_llava_g7(cuda, num_splits, dtype):
    """llava-next-34b's decode geometry (56/8 heads, a GQA group of 7, D
    128): the contiguous cache with ragged lengths and a 0, and the paged
    cache on a poisoned trash page, against their plain versions."""
    b, hq, hkv, s, d = 3, 56, 8, 300, 128
    q = _rand(cuda, (b, hq, d), dtype)
    k = _rand(cuda, (b, hkv, s, d), dtype)
    v = _rand(cuda, (b, hkv, s, d), dtype)
    kv_len = torch.tensor([300, 0, 129], dtype=torch.int32, device="cuda")
    o = kdecode.flash_decode(q, k, v, kv_len=kv_len, num_splits=num_splits)
    torch.cuda.synchronize()
    assert _err(o, kdecode.flash_decode_torch(q, k, v, kv_len=kv_len,
                                              num_splits=num_splits)) <= TOL[dtype]
    assert float(o[1].abs().max()) == 0.0
    q, kp, vp, bt = _paged(cuda, 4, hq, hkv, d, 16, 12, dtype)
    kv_len = torch.tensor([192, 0, 17, 100], dtype=torch.int32, device="cuda")
    for row, n in enumerate(kv_len.tolist()):     # past each row: the trash page
        bt[row, -(-n // 16):] = TRASH_PAGE
    kp[:, TRASH_PAGE] = 1e6
    vp[:, TRASH_PAGE] = 1e6
    o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len,
                                   num_splits=num_splits)
    torch.cuda.synchronize()
    o_ref = kdecode.flash_paged_decode_torch(q, kp, vp, bt, kv_len=kv_len,
                                             num_splits=num_splits)
    assert _err(o, o_ref) <= TOL[dtype]
    assert float(o[1].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ["hubert_xlarge", "llava_next_34b"])
def test_frontend_train_pass_kernel_matches_torch(cuda, arch):
    """Two layers of hubert-xlarge at full width (D 80, non-causal, GELU)
    or one of llava-next-34b (D 128, G 7), f32, remat, dropout 0.1, over a
    batch of embeds: a loss-and-grad pass through the kernels against
    impl="torch"; the kernels launch 2 forward and 1 backward a layer."""
    from repro_torch.optim import global_norm

    layers = 2 if arch == "hubert_xlarge" else 1
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=layers,
                              dtype=torch.float32, dropout_rate=0.1, remat=True)
    params = lm.init_params(cfg, seed=0, device="cuda")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=512, global_batch=2,
                    seed=0, frontend=cfg.frontend)
    batch = place_batch(make_batch(dc, 0), "cuda")
    leaves = ("blocks.0.mixer.wq", "blocks.0.mlp.wi", "frontend_proj",
              "lm_head")
    out = {}
    for impl in ("kernel", "torch"):
        ctx = Ctx(impl=impl, deterministic=False, seed=-5, torch_chunk=256)
        before = (kfwd.launches, kbwd.launches_bwd)
        loss, _ = lm.loss_fn(cfg, params, batch, ctx)
        loss.backward()
        torch.cuda.synchronize()
        launched = (kfwd.launches - before[0], kbwd.launches_bwd - before[1])
        assert launched == ((2 * layers, layers) if impl == "kernel" else (0, 0))
        named = dict(params.named_parameters())
        assert named["embed"].grad is None
        out[impl] = (float(loss.detach()),
                     float(global_norm(p.grad for p in params.parameters()
                                       if p.grad is not None)),
                     {n: named[n].grad.clone() for n in leaves})
        params.zero_grad(set_to_none=True)
    (lk, gk, dk), (lt, gt, dt) = out["kernel"], out["torch"]
    assert abs(lk - lt) <= 1e-5 * abs(lt)
    assert abs(gk - gt) <= 1e-4 * gt
    for n in leaves:
        assert _err(dk[n], dt[n]) <= 1e-3 * float(dt[n].abs().max()), n


# ---------------------------------------------------------------------------
# the dropout mask's global coordinates (a rank's shard of the batch and heads)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_offsets_give_the_full_calls_masks(cuda, dtype):
    """Rows 1-3 on a shard: ``kernel(q[b0:, h0:h1], batch_offset=b0,
    head_offset=h0)`` equals the full call's slice with dropout on, the
    forward's o and lse and the backward's dK and dV bit for bit, dQ to f32
    rounding (its atomic adds run in another order from launch to launch)."""
    b, hq, hkv, s, d = 3, 8, 2, 192, 64
    q, do = (_rand(cuda, (b, hq, s, d), dtype) for _ in range(2))
    k, v = (_rand(cuda, (b, hkv, s, d), dtype) for _ in range(2))
    kw = dict(causal=True, dropout_rate=0.1, dropout_seed=-77)
    o, lse = kfwd.flash_fwd(q, k, v, **kw)
    dq, dk, dv = kbwd.flash_bwd(q, k, v, o, lse, do, **kw)
    b0, h0, h1 = 1, 4, 8                    # q heads 4-7 share kv head 1
    sl, kl = (slice(b0, b), slice(h0, h1)), (slice(b0, b), slice(1, 2))
    qs, dos = q[sl].contiguous(), do[sl].contiguous()
    ks, vs = k[kl].contiguous(), v[kl].contiguous()
    off = dict(batch_offset=b0, head_offset=h0)
    os_, lses = kfwd.flash_fwd(qs, ks, vs, **kw, **off)
    assert torch.equal(os_, o[sl]) and torch.equal(lses, lse[sl])
    dqs, dks, dvs = kbwd.flash_bwd(qs, ks, vs, os_, lses, dos, **kw, **off)
    assert torch.equal(dks, dk[kl]) and torch.equal(dvs, dv[kl])
    assert _err(dqs, dq[sl]) <= BWD_TOL[dtype] * max(1.0, float(dq.abs().max()))
    # without the offsets the shard draws other masks
    assert not torch.equal(kfwd.flash_fwd(qs, ks, vs, **kw)[0], o[sl])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,s,d,window", [(10, 1, 512, 256, 256),
                                               (6, 2, 512, 64, None)])
def test_query_shards_give_the_full_calls_rows(cuda, dtype, hq, hkv, s, d,
                                               window):
    """Rows 1-3 on the query shards of context parallelism (4 shards, each
    ``[a, b)`` against K/V cut to ``[0, b)``, q their suffix; rows a
    multiple of the kernels' tiles, as a mesh's ``S / model`` of 768 at
    D 256 is), dropout on: o and lse are the full call's rows bit for bit,
    dQ within its atomic adds' rounding, and the four shards' dK/dV summed
    are the full call's within ``BWD_TOL`` of their max."""
    b, m = 2, 4
    q, do = (_rand(cuda, (b, hq, s, d), dtype) for _ in range(2))
    k, v = (_rand(cuda, (b, hkv, s, d), dtype) for _ in range(2))
    kw = dict(causal=True, window=window, dropout_rate=0.1, dropout_seed=-77)
    o, lse = kfwd.flash_fwd(q, k, v, **kw)
    dq, dk, dv = kbwd.flash_bwd(q, k, v, o, lse, do, **kw)
    dk_sum = torch.zeros(dk.shape, dtype=torch.float32, device="cuda")
    dv_sum = torch.zeros_like(dk_sum)
    rows = s // m
    for r in range(m):
        a, e = r * rows, (r + 1) * rows
        qs, dos = q[:, :, a:e].contiguous(), do[:, :, a:e].contiguous()
        ks, vs = k[:, :, :e].contiguous(), v[:, :, :e].contiguous()
        os_, lses = kfwd.flash_fwd(qs, ks, vs, **kw)
        assert torch.equal(os_, o[:, :, a:e]) and torch.equal(lses, lse[:, :, a:e])
        dqs, dks, dvs = kbwd.flash_bwd(qs, ks, vs, os_, lses, dos, **kw)
        assert _err(dqs, dq[:, :, a:e]) <= BWD_TOL[dtype] * max(
            1.0, float(dq.abs().max()))
        dk_sum[:, :, :e] += dks.float()
        dv_sum[:, :, :e] += dvs.float()
    for got, want in ((dk_sum, dk), (dv_sum, dv)):
        assert _err(got, want.float()) <= BWD_TOL[dtype] * max(
            1.0, float(want.abs().max()))


# ---------------------------------------------------------------------------
# training over a mesh on the card
# ---------------------------------------------------------------------------

def _mesh_gpu_cfg(arch="granite_3_2b"):
    return dataclasses.replace(configs.smoke_config(arch),
                               dtype=torch.float32, dropout_rate=0.1)


def _mesh_gpu_batch(cfg):
    return make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                 global_batch=4, seed=2, pack=True,
                                 min_seg_len=5, max_seg_len=30), 0)


def _mesh_gpu_rank(pool, device, shape, arch="granite_3_2b"):
    """A rank of a mesh of ``shape`` on the card: the step-0 loss and
    gathered gradients from ``init_fn(0)`` (numpy: tensors would leave
    through the queue's shared memory after the rank has exited), and the
    kernels' launches."""
    from repro_torch.distributed.mesh import join_train_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = join_train_mesh(shape)
    cfg = _mesh_gpu_cfg(arch)
    arts = make_train_step(cfg, mesh=mesh, opt=AdamWConfig(lr=1e-3),
                           impl="kernel", device=device)
    params, _ = arts.init_fn(0)
    batch = place_batch(_mesh_gpu_batch(cfg), device, arts.shardings["batch"])
    kfwd.launches = kbwd.launches_bwd = 0
    loss, _, grads = arts.grad_fn(params, batch, 0)
    return {"loss": float(loss), "launches": (kfwd.launches, kbwd.launches_bwd),
            "grads": {n: arts.shardings["params"][n].gather(g).cpu().numpy()
                      for n, g in grads.items()}}


def test_two_rank_gloo_mesh_step_on_the_card(cuda):
    """Two gloo ranks sharing the card on (data 1, model 2), at smoke width
    with dropout and packing, against one device on the same state: the
    loss 1e-5 relative, every gathered gradient leaf 2e-5 of its max (the
    backward's dQ adds run in another order on each launch); every rank
    launched rows 1-3."""
    from repro_torch.launch.mesh import run_ranks
    shape = {"data": 1, "model": 2}
    ranks = run_ranks(_mesh_gpu_rank, 2, (shape,), backend="gloo",
                      device_type="cuda", timeout_s=600)
    cfg = _mesh_gpu_cfg()
    arts = make_train_step(cfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                           device="cuda")
    params = lm.init_params(cfg, seed=0, device="cuda", vocab_pad_to=2)
    loss, _, grads = arts.grad_fn(params, place_batch(_mesh_gpu_batch(cfg),
                                                      "cuda"), 0)
    layers = cfg.num_layers
    for r in ranks:
        assert r["launches"] == (2 * layers, layers)
        assert abs(r["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    for n, g in grads.items():
        got = torch.from_numpy(ranks[0]["grads"][n])
        assert _err(got, g.cpu()) <= 2e-5 * float(g.abs().max()), n


def test_context_parallel_mesh_step_on_the_card(cuda):
    """Four gloo ranks sharing the card on (model 4) train
    recurrentgemma-2b SMOKE (2 heads: ``seq_full``, 16 of 64 query rows a
    rank) with dropout and packing against one device on the same state:
    the loss 1e-5 relative, every gathered gradient leaf 2e-5 of its max;
    every rank launched rows 1-3 once a pass per attention layer."""
    from repro_torch.launch.mesh import run_ranks
    arch = "recurrentgemma_2b"
    ranks = run_ranks(_mesh_gpu_rank, 4, ({"model": 4}, arch),
                      backend="gloo", device_type="cuda", timeout_s=600)
    cfg = _mesh_gpu_cfg(arch)
    arts = make_train_step(cfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                           device="cuda")
    params = lm.init_params(cfg, seed=0, device="cuda", vocab_pad_to=4)
    loss, _, grads = arts.grad_fn(params, place_batch(_mesh_gpu_batch(cfg),
                                                      "cuda"), 0)
    attn = lm.block_kinds(cfg).count("attn")
    for r in ranks:
        assert r["launches"] == (2 * attn, attn)
        assert abs(r["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    for n, g in grads.items():
        got = torch.from_numpy(ranks[0]["grads"][n])
        assert _err(got, g.cpu()) <= 2e-5 * float(g.abs().max()), n


def test_prefetch_loader_on_the_card(cuda):
    """The loader's side-stream copies land on the card, this rank's rows
    of the sharded keys, and the caller's stream waits for them."""
    from repro_torch.data import PrefetchLoader
    from repro_torch.distributed.mesh import TrainMesh
    from repro_torch.distributed.parallel import NamedSharding
    mesh = TrainMesh(shape={"data": 2, "model": 2}, rank=2,
                     coords={"data": 1, "model": 0}, groups={})
    sh = {"tokens": NamedSharding(mesh, ("data", None))}
    dc = DataConfig(vocab_size=251, seq_len=4096, global_batch=8, seed=5)
    host = [make_batch(dc, s) for s in range(4)]
    got = list(PrefetchLoader(iter(host), sh, prefetch=2, device="cuda"))
    assert len(got) == 4
    for b, h in zip(got, host):
        assert b["tokens"].device.type == "cuda"
        # used at once on the current stream: the wait makes it safe
        assert int((b["tokens"].long() + 0).sum()) == int(h["tokens"][4:].sum())
        assert np.array_equal(b["labels"].cpu().numpy(), h["labels"])


def _fsdp_serve_rank(pool, device, shape):
    """A rank of llava-next-34b SMOKE (``fsdp=True``) served on the card:
    the bytes of the weights it holds, and its first decode step's
    collectives (``collectives.log``) and launches of row 4."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.mesh import join_train_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = join_train_mesh(shape)
    cfg = dataclasses.replace(configs.smoke_config("llava_next_34b"),
                              dtype=torch.float32, fsdp=True)
    arts = make_serve_steps(cfg, max_len=48, batch=4, torch_chunk=16,
                            device=device, mesh=mesh)
    params = arts.init_fn(0)
    prompt = torch.arange(4 * 40, device=device).view(4, 40) % cfg.vocab_size
    logits, caches = arts.prefill_fn(params, prompt, arts.cache_init_fn())
    kdecode.launches = 0
    C.log = []
    try:
        arts.decode_fn(params, logits[:, :cfg.vocab_size].argmax(-1), caches, 40)
        log = C.log
    finally:
        C.log = None
    return {"held": sum(p.numel() * p.element_size() for p in params.parameters()),
            "log": log, "launches": kdecode.launches}


def test_fsdp_mesh_serving_holds_the_dry_runs_bytes(cuda):
    """llava-next-34b SMOKE with ``fsdp=True`` on (data 2, model 2) gloo
    ranks sharing the card: each rank holds the weight bytes the dry run
    (``launch/dryrun.trace_step`` on meta) counts for it, a quarter of the
    model's, and its decode step logs the dry run's collectives, call for
    call."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.mesh import dry_train_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import run_ranks
    shape = {"data": 2, "model": 2}
    ranks = run_ranks(_fsdp_serve_rank, 4, (shape,), backend="gloo",
                      device_type="cuda", timeout_s=600)
    cfg = dataclasses.replace(configs.smoke_config("llava_next_34b"),
                              dtype=torch.float32, fsdp=True)
    whole = sum(p.numel() * 4 for p in lm.LM(cfg, lm.padded_vocab(cfg, 2),
                                              device="meta").parameters())
    for rank, r in enumerate(ranks):
        dry = dryrun.trace_step(cfg, ShapeConfig("decode", 48, 4, "decode"),
                                dry_train_mesh(shape, rank))
        assert r["held"] == dry["held"]["params"] < whole / 2
        assert r["log"] == dry["log"]
        assert r["launches"] == lm.block_kinds(cfg).count("attn")
