"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; the ``cuda`` fixture skips them where no card is present
(this is decided when a test runs, never at import or collection). On the
card: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
The same checks, at the serving and training paths' full shapes, are in
``chip_smoke.py``.
"""

import dataclasses

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

pytestmark = pytest.mark.gpu

# kernel vs plain version: f32 sums in another order (the JAX suite's f32
# tolerance); bf16: two bf16 ulps at |o| <= 1 (P and o rounded on both sides)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
# backward kernels vs plain version, relative to max(1, max|plain|): f32 the
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
    before = (kbwd.launches_dkv, kbwd.launches_dq)
    grads = kbwd.flash_bwd(q, k, v, o, lse, do, acc_dtype=acc, **kw)
    torch.cuda.synchronize()
    assert (kbwd.launches_dkv, kbwd.launches_dq) == (before[0] + 1, before[1] + 1)
    plain = kbwd.flash_bwd_torch(q, k, v, lse, do, kbwd.row_delta(o, do),
                                 acc_dtype=acc, **kw)
    for g, gp, x in zip(grads, plain, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert bool(torch.isfinite(g).all())
        tol = BWD_TOL[torch.bfloat16 if torch.bfloat16 in (dtype, acc) else dtype]
        assert _err(g, gp) <= tol * max(1.0, float(gp.abs().max()))
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
    """ops.mha's backward launches both kernels and matches autograd of the
    naive oracle (f32, causal GQA with dropout and a q suffix)."""
    q, k, v, do = _bwd_inputs(cuda, 2, 8, 2, 96, 160, 64, torch.float32)
    cfg = ops.AttnConfig(causal=True, dropout_rate=0.1)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (kfwd.launches, kbwd.launches_dkv, kbwd.launches_dq)
    ops.mha(*xs, seed=-7, config=cfg).backward(do)
    torch.cuda.synchronize()
    assert (kfwd.launches, kbwd.launches_dkv, kbwd.launches_dq) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    ref.naive_mha(*ys, causal=True, dropout_rate=0.1, dropout_seed=-7).backward(do)
    for x, y in zip(xs, ys):
        assert _err(x.grad, y.grad) <= 5e-5 * max(1.0, float(y.grad.abs().max()))


def test_train_step_kernel_matches_torch(cuda):
    """A SMOKE training step (packed batch, dropout 0.1, remat) through the
    kernels against impl="torch" from one state: loss, grad norm and every
    gradient leaf agree, and the kernels launch once a layer forward, once
    more in the recompute, and each backward kernel once a layer."""
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
        before = (kfwd.launches, kbwd.launches_dkv, kbwd.launches_dq)
        lm.loss_fn(cfg, params, batch, ctx)[0].backward()
        grads = [p.grad.clone() for p in params.parameters()]
        params.zero_grad(set_to_none=True)
        _, _, m = arts.step_fn(params, opt, batch, 4)
        torch.cuda.synchronize()
        after = (kfwd.launches, kbwd.launches_dkv, kbwd.launches_dq)
        want = (4 * n, 2 * n, 2 * n) if impl == "kernel" else (0, 0, 0)
        assert tuple(a - b for a, b in zip(after, before)) == want
        out[impl] = (float(m["loss"]), float(m["grad_norm"]), grads)
    (lk, gk, dk), (lt, gt, dt) = out["kernel"], out["torch"]
    assert abs(lk - lt) <= 1e-5 * abs(lt)
    assert abs(gk - gt) <= 1e-4 * gt
    for a, b in zip(dk, dt):
        assert _err(a, b) <= 1e-4 * float(b.abs().max())
