"""The port's attention backward against the JAX package, on the CPU.

Inputs come from numpy with a seed. JAX runs its backward kernels in Pallas
interpret mode with 64-wide blocks (the port's tile), on the port's forward
output and lse, and its oracle through ``jax.grad``; on CPU tensors the port's ``flash_bwd`` runs its plain version
and ``ops.mha`` / ``ref.online_mha`` differentiate through their own
backward functions. Tolerance: 5e-5, the JAX suite's gradient tolerance
(``tests/test_kernel_bwd.py``); bf16-ACC keeps that suite's bounds (0.05 on
the forward, 0.35 on the gradients).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_bwd import flash_bwd as j_flash_bwd  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402
from repro_torch.kernels import flash_bwd as tbwd  # noqa: E402
from repro_torch.kernels import flash_fwd as tfwd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 5e-5

CASES = {
    # b, hq, hkv, sq, skv, d, options
    "causal_gqa": (2, 4, 2, 128, 128, 32, dict(causal=True)),
    "q_suffix": (1, 2, 1, 64, 128, 32, dict(causal=True)),
    "window": (1, 2, 2, 128, 128, 32, dict(causal=True, window=40)),
    "ragged_100": (1, 2, 2, 100, 100, 32, dict(causal=True)),
    "dropout": (1, 2, 2, 128, 128, 32, dict(dropout_rate=0.15, dropout_seed=-5)),
    "segments": (2, 2, 1, 96, 96, 16, dict(causal=True, segments=True)),
}
PAD = 7          # trailing padding tokens (segment id -1) of the segments case


def _err(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@functools.lru_cache(maxsize=None)
def _case(name):
    """numpy (q, k, v, do, options) of a case; segments become int32 ids."""
    b, hq, hkv, sq, skv, d, kw = CASES[name]
    r = np.random.default_rng(sorted(CASES).index(name))
    xs = tuple(r.standard_normal(s, np.float32) for s in
               ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d)))
    kw = dict(kw)
    if kw.pop("segments", False):
        seg = (np.arange(skv, dtype=np.int32) // 30)[None].repeat(b, 0)
        seg[1] = np.arange(skv, dtype=np.int32) // 45
        seg[:, -PAD:] = -1
        kw["segment_ids"] = seg
    return xs + (kw,)


def _torch_kw(kw):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


def _jax_kw(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


@functools.lru_cache(maxsize=None)
def _jax_oracle_grads(name):
    """jax.grad of JAX ``naive_mha`` (f32) for the case."""
    q, k, v, do, kw = _case(name)
    jkw = _jax_kw(kw)

    def f(q, k, v):
        return (jref.naive_mha(q, k, v, **jkw) * do).sum()
    return tuple(np.asarray(g) for g in _jit_grad(f)(*map(jnp.asarray, (q, k, v))))


def _jit_grad(f):
    """Gradients of ``f(q, k, v)``, compiled once (far quicker than JAX's
    op-by-op dispatch on the CPU)."""
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))


def _check_padding(name, kw, grads):
    if "segment_ids" in kw:              # padding tokens: exact zero gradient
        for g in grads:
            assert float(np.abs(np.asarray(g.detach())[:, :, -PAD:]).max()) == 0.0


@pytest.mark.parametrize("name", list(CASES))
def test_flash_bwd_plain_matches_jax_kernel_and_oracle(name):
    q, k, v, do, kw = _case(name)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfwd.flash_fwd(tq, tk, tv, **_torch_kw(kw))
    before = tbwd.launches_bwd
    grads = tbwd.flash_bwd(tq, tk, tv, o, lse, tdo, **_torch_kw(kw))
    assert tbwd.launches_bwd == before   # plain: no count
    jkw = _jax_kw(kw)        # JAX's backward takes the same o and lse
    jgrads = jax.jit(lambda *xs: j_flash_bwd(
        *xs, block_q=64, block_kv=64, interpret=True, **jkw))(
        *(jnp.asarray(np.asarray(x)) for x in (q, k, v, o, lse, do)))
    for g, jg, og, x in zip(grads, jgrads, _jax_oracle_grads(name), (tq, tk, tv)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert _err(g, jg) < TOL
        assert _err(g, og) < TOL
    _check_padding(name, kw, grads)


@pytest.mark.parametrize("name", ["causal_gqa", "q_suffix", "dropout", "segments"])
def test_mha_autograd_matches_jax_oracle(name):
    q, k, v, do, kw = _case(name)
    kw = _torch_kw(kw)
    cfg = tops.AttnConfig(causal=kw.get("causal", False),
                          window=kw.get("window"),
                          dropout_rate=kw.get("dropout_rate", 0.0))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tops.mha(*xs, seed=kw.get("dropout_seed", 0),
                 segment_ids=kw.get("segment_ids"), config=cfg)
    o.backward(torch.from_numpy(do))
    for x, og in zip(xs, _jax_oracle_grads(name)):
        assert _err(x.grad, og) < TOL
    _check_padding(name, kw, [x.grad for x in xs])


@pytest.mark.parametrize("name", ["causal_gqa", "window", "dropout", "segments"])
def test_online_mha_grads_match_jax_online_mha(name):
    q, k, v, do, kw = _case(name)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tref.online_mha(*xs, chunk=32, **_torch_kw(kw)).backward(torch.from_numpy(do))
    jkw = _jax_kw(kw)

    def f(q, k, v):
        return (jref.online_mha(q, k, v, chunk=32, **jkw) * do).sum()
    jgrads = _jit_grad(f)(*map(jnp.asarray, (q, k, v)))
    for x, jg, og in zip(xs, jgrads, _jax_oracle_grads(name)):
        assert _err(x.grad, jg) < TOL
        assert _err(x.grad, og) < TOL


@pytest.mark.parametrize("name", ["causal_gqa", "dropout", "segments"])
def test_tf32_products_precision(name):
    """The kernel's f32 products on tensor cores: every tile product of the
    backward in 3xTF32 (``common.tf32_matmul``) stays within 5e-5 of JAX's
    f32 kernels relative to max|JAX grad|, and one TF32 product a tile
    (10 mantissa bits) lands at least 10x further off."""
    q, k, v, do, kw = _case(name)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfwd.flash_fwd(tq, tk, tv, **_torch_kw(kw))
    jkw = _jax_kw(kw)
    jgrads = jax.jit(lambda *xs: j_flash_bwd(
        *xs, block_q=64, block_kv=64, interpret=True, **jkw))(
        *(jnp.asarray(np.asarray(x)) for x in (q, k, v, o, lse, do)))
    delta = tbwd.row_delta(o, tdo)
    errs = {}
    for passes in (3, 1):
        grads = tbwd.flash_bwd_torch(
            tq, tk, tv, lse, tdo, delta, **_torch_kw(kw),
            matmul=functools.partial(tcommon.tf32_matmul, passes=passes))
        errs[passes] = max(_err(g, jg) / float(np.abs(np.asarray(jg)).max())
                           for g, jg in zip(grads, jgrads))
    assert errs[3] < TOL
    assert errs[1] >= 10 * errs[3] and errs[1] > TOL


def test_split_tf32_rounds_like_cvt_rna():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero; lo, the rest, is truncated to 10; hi + lo keeps about 21 bits."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                      1 + 3 * 2.0 ** -12, 0.0, -3.5])
    hi, lo = tcommon.split_tf32(x)
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0,
                           1 + 2.0 ** -10, 0.0, -3.5]
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096,
                                                                  np.float32))
    hi, lo = tcommon.split_tf32(r)
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 0x1FFF).count_nonzero()) == 0
    assert float(((r - hi - lo).abs() / r.abs()).max()) < 2.0 ** -20


def test_online_mha_backward_keeps_no_chunk_state():
    """The chunked backward saves (q, k, v, o, lse), not every chunk's f32
    state: the autograd graph holds one node, whatever the chunk count."""
    q, k, v, do, kw = _case("causal_gqa")
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tref.online_mha(*xs, chunk=16, **kw)
    assert type(o.grad_fn).__name__ == "_OnlineMHABackward"
    assert len(o.grad_fn.saved_tensors) == 6     # q, k, v, o, lse, segment ids


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def test_bf16_acc_forward_within_jax_bound():
    """bf16-ACC (each tile product rounded to bf16) stays within the JAX
    suite's 0.05 of the f32 oracle, and f32-ACC is no worse."""
    q, k, v, _, _ = _case("causal_gqa")
    tq, tk, tv = map(_bf16, (q, k, v))
    o16, lse16 = tfwd.flash_fwd(tq, tk, tv, causal=True, acc_dtype=torch.bfloat16)
    o32, _ = tfwd.flash_fwd(tq, tk, tv, causal=True)
    o_ref = tref.naive_mha(tq.float(), tk.float(), tv.float(), causal=True)
    assert 0.0 < _err(o16, o_ref) < 0.05
    assert _err(o32, o_ref) <= _err(o16, o_ref) + 1e-6
    assert bool(torch.isfinite(lse16).all())
    # the oracle and the chunked path round the same products
    on16 = tref.online_mha(tq, tk, tv, causal=True, chunk=64,
                           acc_dtype=torch.bfloat16)
    nv16 = tref.naive_mha(tq, tk, tv, causal=True, acc_dtype=torch.bfloat16)
    assert _err(on16, o_ref) < 0.05 and _err(nv16, o_ref) < 0.05


def test_bf16_acc_backward_within_jax_bound():
    q, k, v, do, _ = _case("causal_gqa")
    tq, tk, tv, tdo = map(_bf16, (q, k, v, do))
    o, lse = tfwd.flash_fwd(tq, tk, tv, causal=True)
    grads = tbwd.flash_bwd(tq, tk, tv, o, lse, tdo, causal=True,
                           acc_dtype=torch.bfloat16)
    xs = [t.float().requires_grad_() for t in (tq, tk, tv)]
    tref.naive_mha(*xs, causal=True).backward(tdo.float())
    for g, x in zip(grads, xs):
        assert g.dtype == torch.bfloat16
        assert _err(g, x.grad) < 0.35


def test_mha_bwd_acc_dtype_reaches_the_backward():
    """AttnConfig.bwd_acc_dtype rounds the backward's products, not the
    forward's: the forward output is the f32-ACC one, the gradients move."""
    q, k, v, do, _ = _case("q_suffix")
    outs = []
    for acc in (torch.float32, torch.bfloat16):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        cfg = tops.AttnConfig(causal=True, bwd_acc_dtype=acc)
        o = tops.mha(*xs, config=cfg)
        o.backward(torch.from_numpy(do))
        outs.append((o.detach(), [x.grad for x in xs]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert 0.0 < _err(outs[0][1][0], outs[1][1][0]) < 0.35


def test_flash_bwd_wrapper_checks():
    q, k, v, do, _ = _case("q_suffix")
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfwd.flash_fwd(tq, tk, tv, causal=True)
    with pytest.raises(ValueError):
        tbwd.flash_bwd(tq, tk, tv, o[:, :, 1:], lse, tdo)        # o shape
    with pytest.raises(ValueError):
        tbwd.flash_bwd(tq, tk, tv, o, lse.double(), tdo)         # lse dtype
    with pytest.raises(ValueError):
        tbwd.flash_bwd(tq, tk, tv, o, lse, tdo, acc_dtype=torch.float16)
    with pytest.raises(ValueError):
        tbwd.flash_bwd(*(t.to("meta") for t in (tq, tk, tv, o, lse, tdo)))
