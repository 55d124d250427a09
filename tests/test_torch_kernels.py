"""The port's kernel modules against the JAX package, on the CPU.

Inputs are made from a seed with numpy and fed to both packages; the JAX
kernels run in Pallas interpret mode. On a CPU tensor the port's kernel
wrappers run their plain-torch versions, which these tests hold against
JAX's kernels and oracles at the JAX suite's f32 tolerance (2e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import online_softmax as josm  # noqa: E402
from repro.kernels import rng as jrng  # noqa: E402
from repro.kernels.decode import flash_decode as j_flash_decode  # noqa: E402
from repro.kernels.flash_fwd import flash_fwd as j_flash_fwd  # noqa: E402
from repro.kernels.ops import AttnConfig as JAttnConfig  # noqa: E402
from repro.kernels.ops import mha_reference as j_mha_reference  # noqa: E402
from repro_torch.core import online_softmax as tosm  # noqa: E402
from repro_torch.kernels import decode as tdecode  # noqa: E402
from repro_torch.kernels import flash_fwd as tfwd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rng as trng  # noqa: E402

TOL = 2e-5  # the JAX suite's f32 attention tolerance


def _err(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _qkv(seed, b, hq, hkv, sq, skv, d):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, hq, sq, d), np.float32),
            r.standard_normal((b, hkv, skv, d), np.float32),
            r.standard_normal((b, hkv, skv, d), np.float32))


# ---------------------------------------------------------------------------
# online-softmax algebra
# ---------------------------------------------------------------------------

def _state(r, rows, d, masked_row=None):
    m = r.standard_normal(rows).astype(np.float32)
    l = r.uniform(0.5, 2.0, rows).astype(np.float32)
    acc = r.standard_normal((rows, d)).astype(np.float32)
    if masked_row is not None:
        m[masked_row], l[masked_row], acc[masked_row] = josm.NEG_INF, 0.0, 0.0
    return m, l, acc


def test_online_softmax_matches_jax():
    r = np.random.default_rng(0)
    rows, d, cols = 6, 8, 5
    s = r.standard_normal((rows, cols)).astype(np.float32)
    s[2] = josm.NEG_INF                         # a fully masked row
    v = r.standard_normal((cols, d)).astype(np.float32)
    a = _state(r, rows, d, masked_row=2)
    b = _state(r, rows, d)
    stack = [_state(r, rows, d, masked_row=i % 3) for i in range(3)]

    def both(jfn, tfn, *states):
        jo = jfn(*[josm.SoftmaxState(*map(jnp.asarray, st)) for st in states])
        to = tfn(*[tosm.SoftmaxState(*map(torch.from_numpy, st))
                   for st in states])
        return jo, to

    jo = josm.update(josm.SoftmaxState(*map(jnp.asarray, a)),
                     jnp.asarray(s), jnp.asarray(v))
    to = tosm.update(tosm.SoftmaxState(*map(torch.from_numpy, a)),
                     torch.from_numpy(s), torch.from_numpy(v))
    for x, y in zip(jo, to):
        assert _err(y, x) < TOL
    jo, to = both(josm.merge, tosm.merge, a, b)
    for x, y in zip(jo, to):
        assert _err(y, x) < TOL
    st = tuple(np.stack([x[i] for x in stack]) for i in range(3))
    jo, to = both(josm.merge_many, tosm.merge_many, st)
    for x, y in zip(jo, to):
        assert _err(y, x) < TOL
    jo, to = both(josm.finalize, tosm.finalize, a)
    for x, y in zip(jo, to):
        assert _err(y, x) < TOL
    assert float(to[0][2].abs().max()) == 0.0   # masked row finalizes to 0
    assert np.isfinite(to[1].numpy()).all()


# ---------------------------------------------------------------------------
# dropout RNG: bit-identical to JAX
# ---------------------------------------------------------------------------

GOLDEN_BITS_ROW0 = [0x2573FE71, 0x84EF34C3, 0x73D812D0, 0x617B245F,
                    0xEA793DC6, 0xA1C95254, 0x78A56FB9, 0xCEB20E90]
GOLDEN_BITS_ROW7 = [0xE87F66D4, 0xD78E4081, 0x05ABACC8, 0x7758B7FA,
                    0xBE9F5D74, 0xAD295C7C, 0x867EEC7F, 0xA46E6A33]
GOLDEN_MASK_PACKED = [127, 204, 151, 223, 221, 215, 255, 223]


def test_rng_golden_literals():
    qp, kp = torch.arange(8)[:, None], torch.arange(8)[None, :]
    bits = trng.random_bits(42, 1, 3, qp, kp)
    assert bits[0].tolist() == GOLDEN_BITS_ROW0
    assert bits[7].tolist() == GOLDEN_BITS_ROW7
    m = trng.dropout_keep_mask(0.25, 42, 1, 3, qp, kp)
    assert [int("".join(str(int(x)) for x in row), 2)
            for row in m] == GOLDEN_MASK_PACKED


@pytest.mark.parametrize("seed", [0, 77, -123456789, 2**31 - 1, -2**31])
def test_rng_bits_match_jax(seed):
    """Negative int32 seeds wrap to uint32 as in JAX; large positions too."""
    qp = np.arange(0, 4000, 37, dtype=np.int32)[:, None]
    kp = np.arange(0, 70000, 613, dtype=np.int32)[None, :]
    jb = np.asarray(jrng.random_bits(jnp.int32(seed), 3, 17, jnp.asarray(qp),
                                     jnp.asarray(kp))).astype(np.int64)
    tb = trng.random_bits(seed, 3, 17, torch.from_numpy(qp),
                          torch.from_numpy(kp)).numpy()
    np.testing.assert_array_equal(tb, jb)
    jm = np.asarray(jrng.dropout_keep_mask(0.4, jnp.int32(seed), 3, 17,
                                           jnp.asarray(qp), jnp.asarray(kp)))
    tm = trng.dropout_keep_mask(0.4, seed, 3, 17, torch.from_numpy(qp),
                                torch.from_numpy(kp)).numpy()
    np.testing.assert_array_equal(tm, jm)


# ---------------------------------------------------------------------------
# flash_fwd: the port's plain version vs the JAX kernel (interpret) + oracle
# ---------------------------------------------------------------------------

FWD_CASES = {
    # b, hq, hkv, sq, skv, d, causal, window, segments, dropout
    "causal": (1, 2, 2, 96, 96, 32, True, None, False, 0.0),
    "window": (1, 2, 2, 96, 96, 32, True, 40, False, 0.0),
    "gqa_4_2": (2, 4, 2, 64, 64, 16, True, None, False, 0.0),
    "segments": (2, 2, 1, 80, 80, 16, True, None, True, 0.0),
    "dropout": (1, 2, 2, 64, 64, 32, False, None, False, 0.4),
    "ragged_tail": (1, 2, 1, 50, 50, 32, True, None, False, 0.0),
    "q_suffix": (1, 4, 2, 24, 88, 16, True, None, False, 0.0),
}


def _segments(b, skv):
    seg = np.zeros((b, skv), np.int32)
    seg[:, skv // 3:] = 1
    seg[:, 2 * skv // 3:] = 2
    seg[:, skv - 7:] = -1                      # padding rows → zeros
    return seg


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_flash_fwd_plain_matches_jax(name):
    b, hq, hkv, sq, skv, d, causal, window, segs, drop = FWD_CASES[name]
    q, k, v = _qkv(1, b, hq, hkv, sq, skv, d)
    seg = _segments(b, skv) if segs else None
    kw = dict(causal=causal, window=window, dropout_rate=drop,
              dropout_seed=77)
    jo, jlse = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           segment_ids=None if seg is None else jnp.asarray(seg),
                           block_q=32, block_kv=32, interpret=True, **kw)
    jref = j_mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           seed=77,
                           segment_ids=None if seg is None else jnp.asarray(seg),
                           config=JAttnConfig(causal=causal, window=window,
                                              dropout_rate=drop))
    to, tlse = tfwd.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              segment_ids=None if seg is None
                              else torch.from_numpy(seg), **kw)
    assert to.shape == (b, hq, sq, d) and tlse.shape == (b, hq, sq)
    assert _err(to, jo) < TOL
    assert _err(to, jref) < TOL
    assert _err(tlse, jlse) < TOL
    if segs:                                    # padding rows: exact zeros
        assert float(to[:, :, -7:].abs().max()) == 0.0
        assert float(tlse[:, :, -7:].max()) == np.float32(tosm.NEG_INF)


def test_flash_fwd_oracles_agree():
    """naive_mha and online_mha (the port's oracle and impl="torch" path)
    against JAX's naive oracle, with GQA, causal+window, segments and
    dropout all on."""
    b, hq, hkv, s, d = 2, 4, 2, 72, 16
    q, k, v = _qkv(2, b, hq, hkv, s, s, d)
    seg = _segments(b, s)
    jref = j_mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seed=-5,
        segment_ids=jnp.asarray(seg),
        config=JAttnConfig(causal=True, window=30, dropout_rate=0.3))
    kw = dict(causal=True, window=30, dropout_rate=0.3, dropout_seed=-5,
              segment_ids=torch.from_numpy(seg))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert _err(tref.naive_mha(tq, tk, tv, **kw), jref) < TOL
    assert _err(tref.online_mha(tq, tk, tv, chunk=32, **kw), jref) < TOL


def test_flash_fwd_wrapper_dispatch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 2, 2, 8, 8, 16))
    before = tfwd.launches
    tfwd.flash_fwd(q, k, v, causal=True)        # CPU → plain version
    assert tfwd.launches == before              # the plain version never counts
    o16, _ = tfwd.flash_fwd(q, k, v, acc_dtype=torch.bfloat16)   # bf16-ACC
    assert o16.dtype == q.dtype and bool(torch.isfinite(o16).all())
    with pytest.raises(ValueError):
        tfwd.flash_fwd(q, k, v, acc_dtype=torch.float16)       # no fp16 ACC
    with pytest.raises(ValueError):
        tfwd.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError):
        tfwd.flash_fwd(q, k[..., :8], v)        # head dims differ
    with pytest.raises(ValueError):
        tfwd.flash_fwd(q, k, v, segment_ids=torch.zeros(1, 3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# flash_decode: the port's plain version vs the JAX kernel (interpret)
# ---------------------------------------------------------------------------

DECODE_CASES = {
    # b, hq, hkv, skv, d, kv_len, window, num_splits
    "ragged_with_zero": (4, 4, 2, 300, 32, [300, 129, 0, 17], None, 1),
    "ragged_splits3": (4, 4, 2, 300, 32, [300, 129, 0, 17], None, 3),
    "window": (2, 4, 2, 400, 32, [400, 250], 100, 1),
    "window_splits3": (2, 4, 2, 400, 32, [400, 250], 100, 3),
    "group5": (2, 10, 2, 200, 16, [200, 57], None, 1),
    "group5_splits3": (2, 10, 2, 200, 16, [200, 57], None, 3),
}


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_flash_decode_plain_matches_jax(name):
    b, hq, hkv, skv, d, kv_len, window, ns = DECODE_CASES[name]
    r = np.random.default_rng(4)
    q = r.standard_normal((b, hq, d), np.float32)
    k = r.standard_normal((b, hkv, skv, d), np.float32)
    v = r.standard_normal((b, hkv, skv, d), np.float32)
    kvl = np.asarray(kv_len, np.int32)
    jo = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        kv_len=jnp.asarray(kvl), window=window, block_kv=128,
                        num_splits=ns, interpret=True)
    to = tdecode.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              kv_len=torch.from_numpy(kvl), window=window,
                              num_splits=ns)
    assert to.shape == (b, hq, d)
    assert _err(to, jo) < TOL
    tref_o = tops.decode_reference(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   kv_len=torch.from_numpy(kvl), window=window)
    assert _err(to, tref_o) < TOL
    for i, n in enumerate(kv_len):
        if n == 0:
            assert float(to[i].abs().max()) == 0.0


def test_split_layout_and_state_merge():
    """Splits never outnumber tiles; split partials merge to the unsplit
    result (the f32 merge_many + finalize of the wrapper)."""
    assert tdecode.split_layout(300, 8) == (3, 3, 1)
    assert tdecode.split_layout(1024, 3) == (8, 3, 3)
    r = np.random.default_rng(5)
    q = torch.from_numpy(r.standard_normal((2, 8, 16), np.float32))
    k = torch.from_numpy(r.standard_normal((2, 2, 700, 16), np.float32))
    v = torch.from_numpy(r.standard_normal((2, 2, 700, 16), np.float32))
    kvl = torch.tensor([700, 260], dtype=torch.int32)
    outs = [tdecode.flash_decode(q, k, v, kv_len=kvl, num_splits=n)
            for n in (1, 2, 4, 6)]
    for o in outs[1:]:
        assert _err(o, outs[0]) < TOL
