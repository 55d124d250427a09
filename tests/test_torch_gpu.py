"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; the ``cuda`` fixture skips them where no card is present
(this is decided when a test runs, never at import or collection). On the
card: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
The same checks, at the serving path's full shapes, are in ``chip_smoke.py``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import decode as kdecode  # noqa: E402
from repro_torch.kernels import flash_fwd as kfwd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime.steps import make_serve_steps  # noqa: E402

pytestmark = pytest.mark.gpu

# kernel vs plain version: f32 sums in another order (the JAX suite's f32
# tolerance); bf16: two bf16 ulps at |o| <= 1 (P and o rounded on both sides)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}


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
