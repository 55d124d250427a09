"""The port's public attention API against the JAX package, on the CPU.

``spark_attention`` and ``spark_decode`` of the port, under each of their
three impls ("kernel" → the kernels' plain versions on a CPU tensor,
"torch", "naive"), against JAX ``impl="xla"`` on the same numpy inputs at
the JAX suite's f32 tolerance (2e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.attention import spark_attention as j_attention  # noqa: E402
from repro.core.attention import spark_decode as j_decode  # noqa: E402
from repro_torch.core.attention import IMPLS  # noqa: E402
from repro_torch.core.attention import spark_attention, spark_decode  # noqa: E402

TOL = 2e-5


def _err(a, b):
    return float(np.abs(a.float().numpy() - np.asarray(b, np.float32)).max())


ATTN_CASES = {
    # b, hq, hkv, sq, skv, d, causal, window, segments, dropout
    "causal_gqa": (2, 4, 2, 70, 70, 16, True, None, False, 0.0),
    "window_suffix": (1, 4, 1, 40, 100, 16, True, 33, False, 0.0),
    "segments_dropout": (2, 2, 2, 64, 64, 32, True, None, True, 0.3),
}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_spark_attention_matches_jax(name, impl):
    b, hq, hkv, sq, skv, d, causal, window, segs, drop = ATTN_CASES[name]
    r = np.random.default_rng(7)
    q = r.standard_normal((b, hq, sq, d), np.float32)
    k = r.standard_normal((b, hkv, skv, d), np.float32)
    v = r.standard_normal((b, hkv, skv, d), np.float32)
    seg = None
    if segs:
        seg = np.repeat(np.arange(4, dtype=np.int32), skv // 4)[None]
        seg = np.repeat(seg, b, axis=0)
        seg[1, -5:] = -1
    kw = dict(causal=causal, window=window, dropout_rate=drop, seed=11)
    jo = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     impl="xla", xla_chunk=32,
                     segment_ids=None if seg is None else jnp.asarray(seg),
                     **kw)
    to = spark_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), impl=impl, torch_chunk=32,
                         segment_ids=None if seg is None
                         else torch.from_numpy(seg), **kw)
    assert to.shape == (b, hq, sq, d)
    assert _err(to, jo) < TOL


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("num_splits", [1, 3])
def test_spark_decode_matches_jax(impl, num_splits):
    b, hq, hkv, skv, d = 3, 8, 2, 333, 16
    r = np.random.default_rng(8)
    q = r.standard_normal((b, hq, d), np.float32)
    k = r.standard_normal((b, hkv, skv, d), np.float32)
    v = r.standard_normal((b, hkv, skv, d), np.float32)
    kvl = np.array([333, 0, 150], np.int32)
    for window in (None, 64):
        jo = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      impl="xla", kv_len=jnp.asarray(kvl), window=window,
                      num_splits=num_splits)
        to = spark_decode(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), impl=impl,
                          kv_len=torch.from_numpy(kvl), window=window,
                          num_splits=num_splits)
        assert to.shape == (b, hq, d)
        assert _err(to, jo) < TOL
        assert float(to[1].abs().max()) == 0.0      # kv_len == 0 → zeros


def test_unknown_impl_raises():
    x = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError):
        spark_attention(x, x, x, impl="pallas")
    with pytest.raises(ValueError):
        spark_decode(x[:, :, 0], x, x, impl="xla")
