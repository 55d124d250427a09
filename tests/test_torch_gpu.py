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
    o = kdecode.flash_paged_decode(q, kp, vp, tables, kv_len, num_splits=2)
    o_ref = kdecode.flash_paged_decode_torch(q, kp, vp, tables, kv_len=kv_len,
                                             num_splits=2)
    assert _err(o, o_ref) <= TOL[torch.float32]
    assert float(o[250:].abs().max()) == 0.0


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
