"""The paged decode at the shapes its query tiles meet, against JAX, on the
CPU.

A launch of many token rows (chunked prefill, speculative verify) says so
with ``row_tokens`` (the token rows of a batch row), and the kernel folds
each K/V tile once for every run of consecutive rows that read one table
(``csrc/flash_decode.cu``). The rows of one launch do not all share a
table: a packed chunk row holds spans of several sequences and padding
tokens (the trash table, kv_len 0), and verify gives every slot its own
table. Here the port's plain versions (``flash_paged_decode`` and
``flash_paged_decode_partials`` on CPU tensors) meet JAX's Pallas kernels in
interpret mode on the same numpy inputs at such shapes, at the JAX suite's
f32 tolerance 2e-5; ``tests/test_torch_gpu.py`` holds the kernel against the
plain versions on the card at the same shapes. Last, the call sites: the
chunk / verify branch of ``apply_attention`` and the sharded decode pass
the hint down, the decode branch does not.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import online_softmax as tosm  # noqa: E402
from repro_torch.kernels import decode as tdecode  # noqa: E402

TOL = 2e-5          # the JAX suite's f32 attention tolerance
D = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@functools.lru_cache(maxsize=None)
def _j_decode(**kw):
    return jax.jit(functools.partial(jops.paged_decode, interpret=True, **kw))


@functools.lru_cache(maxsize=None)
def _j_partials(**kw):
    return jax.jit(functools.partial(jops.paged_decode_partials, interpret=True,
                                     **kw))


def _token_rows(seed, hq, ps, spans, pads):
    """Token rows over one pool: ``spans`` is a list of (history, new tokens)
    per sequence, each sequence its own table; every new token is a row
    reading ``position + 1`` keys through its sequence's table; then
    ``pads`` padding rows (the trash table, kv_len 0). The trash page 0
    holds 1e6. Returns q, the pool, tables [rows, T] and kv_len [rows]."""
    r = np.random.default_rng(seed)
    hkv = 2
    t = max(-(-(h + n) // ps) for h, n in spans) + 1
    n_pages = 1 + len(spans) * t
    kp = r.standard_normal((hkv, n_pages, ps, D), np.float32)
    vp = r.standard_normal((hkv, n_pages, ps, D), np.float32)
    kp[:, 0] = vp[:, 0] = 1e6
    perm = r.permutation(n_pages - 1) + 1
    tables, kv_len = [], []
    for i, (h, n) in enumerate(spans):
        table = perm[i * t:(i + 1) * t].astype(np.int32)
        table[-(-(h + n) // ps):] = 0                 # past the allocation
        for p in range(h, h + n):
            tables.append(table)
            kv_len.append(p + 1)
    for _ in range(pads):
        tables.append(np.zeros(t, np.int32))
        kv_len.append(0)
    q = r.standard_normal((len(kv_len), hq, D), np.float32)
    return q, kp, vp, np.stack(tables), np.array(kv_len, np.int32)


def _owned(tables, n_pages):
    """A shard's view: it owns the pages below n_pages / 2 and the trash
    page; a foreign entry is remapped to the trash page with valid 0."""
    valid = ((tables < n_pages // 2) | (tables == 0)).astype(np.int32)
    return np.where(valid == 1, tables, 0).astype(np.int32), valid


# a packed chunk row: spans of three sequences (one continuing a long
# history), then padding; 24 rows, more than one query tile
CHUNK = dict(spans=[(40, 9), (0, 7), (70, 5)], pads=3)
# verify: four slots of k + 1 = 5 rows, one table a slot; the last slot idle
VERIFY = dict(spans=[(33, 5), (60, 5), (11, 5)], pads=5)
#: the launch hint of each: one batch row of 24 tokens; 5 tokens a slot
ROW_TOKENS = {"chunk": 24, "verify": 5}


@pytest.mark.parametrize("num_splits", [1, 2])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("hq,ps", [(8, 16), (10, 4)])
@pytest.mark.parametrize("shape", ["chunk", "verify"])
def test_token_rows_match_jax(shape, hq, ps, window, num_splits):
    case = CHUNK if shape == "chunk" else VERIFY
    q, kp, vp, bt, kv_len = _token_rows(hq + ps, hq, ps, **case)
    kw = dict(window=window, num_splits=num_splits)
    got = tdecode.flash_paged_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(kv_len),
                                     row_tokens=ROW_TOKENS[shape], **kw)
    want = _j_decode(**kw)(q, kp, vp, bt, kv_len)
    assert _err(got, want) < TOL
    assert float(got[kv_len == 0].abs().max()) == 0.0


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("hq,ps", [(8, 16), (10, 4)])
@pytest.mark.parametrize("shape", ["chunk", "verify"])
def test_token_rows_gated_match_jax(shape, hq, ps, window):
    """The gated partials of one shard at the same rows: each table's
    foreign entries remapped to the trash page (1e6) with valid 0."""
    case = CHUNK if shape == "chunk" else VERIFY
    q, kp, vp, bt, kv_len = _token_rows(hq * ps, hq, ps, **case)
    bt, valid = _owned(bt, kp.shape[1])
    acc, m, l = tdecode.flash_paged_decode_partials(
        _t(q), _t(kp), _t(vp), _t(bt), _t(kv_len), block_valid=_t(valid),
        window=window, row_tokens=ROW_TOKENS[shape])
    j_acc, j_m, j_l = (np.asarray(x) for x in _j_partials(window=window)(
        q, kp, vp, bt, kv_len, block_valid=valid))
    l_safe = np.where(j_l == 0, 1, j_l)
    assert _err(acc / torch.where(l == 0, 1, l)[..., None],
                j_acc / l_safe[..., None]) < TOL
    np.testing.assert_array_equal((m == tosm.NEG_INF).numpy(), j_m == tosm.NEG_INF)
    assert _err(m, j_m) < TOL
    assert _err(l, j_l) < TOL * max(1.0, float(np.abs(j_l).max()))
    empty = (l == 0).numpy()
    assert empty[kv_len == 0].all()                 # padding reads nothing
    assert float(acc[empty].abs().max()) == 0.0


def test_row_tokens_is_checked():
    """The hint must be a positive count on every wrapper; on the CPU it
    changes nothing (the plain versions have no query tiles)."""
    q, kp, vp, bt, kv_len = (_t(a) for a in _token_rows(1, 8, 16, **VERIFY))
    k, v = tdecode.gather_pages(kp, bt), tdecode.gather_pages(vp, bt)
    calls = {
        "contiguous": lambda rt: tdecode.flash_decode(q, k, v, kv_len=kv_len,
                                                      row_tokens=rt),
        "paged": lambda rt: tdecode.flash_paged_decode(q, kp, vp, bt, kv_len,
                                                       row_tokens=rt),
        "gated": lambda rt: tdecode.flash_paged_decode_partials(
            q, kp, vp, bt, kv_len, row_tokens=rt)[0],
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="row_tokens"):
            call(0)
        assert torch.equal(call(5), call(1)), name


def _attention_layer():
    from repro_torch import configs
    from repro_torch.models import layers

    cfg = dataclasses.replace(configs.smoke_config("granite_3_2b"),
                              dtype=torch.float32)
    p = layers.Attention(cfg, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for w in p.parameters():
            w.copy_(torch.randn(w.shape, generator=gen) * 0.1)
    return cfg, p


def test_chunk_prefill_passes_row_tokens(monkeypatch):
    """apply_attention's chunk / verify branch flattens B x S token rows into
    one launch and passes row_tokens = S; its decode branch passes none (one
    row a sequence)."""
    from repro_torch.models import layers

    cfg, p = _attention_layer()
    seen = []
    real = layers.spark_paged_decode

    def spy(*args, **kw):
        seen.append(kw.get("row_tokens", 1))
        return real(*args, **kw)

    monkeypatch.setattr(layers, "spark_paged_decode", spy)
    b, s, ps, t = 2, 6, 4, 4
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cache = {"k_pages": torch.zeros(hkv, 1 + b * t, ps, hd),
             "v_pages": torch.zeros(hkv, 1 + b * t, ps, hd)}
    tables = torch.arange(1, 1 + b * t, dtype=torch.int32).view(b, t)
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1)
    dest = tables.gather(1, (pos // ps).long()) * ps + pos % ps
    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator().manual_seed(4))
    paged = {"dest": dest, "token_tables": tables[:, None].expand(b, s, t).contiguous(),
             "token_kv_len": pos + 1}
    with torch.no_grad():
        out, _ = layers.apply_attention(p, x, layers.Ctx(), cfg, positions=pos,
                                        cache=cache, paged=paged)
        kv_len = torch.full((b,), s, dtype=torch.int32)
        layers.apply_attention(p, x[:, :1], layers.Ctx(decode=True), cfg,
                               positions=kv_len[:, None], cache=cache,
                               paged={"block_tables": tables, "kv_len": kv_len})
    assert seen == [s, 1]
    assert out.shape == (b, s, cfg.d_model) and bool(torch.isfinite(out).all())


def test_sharded_decode_passes_row_tokens(monkeypatch):
    """distributed/paged.py's sharded decode hands the hint to the gated
    kernel's entry point with the shard's local tables."""
    from repro_torch.distributed import paged as dpaged

    seen = {}
    real = dpaged.spark_paged_decode_partials

    def partials(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)

    monkeypatch.setattr(dpaged, "spark_paged_decode_partials", partials)
    monkeypatch.setattr(dpaged, "merge_partials",
                        lambda acc, m, l, mesh, out_dtype: acc.to(out_dtype))
    q, kp, vp, bt, kv_len = (_t(a) for a in _token_rows(2, 8, 16, **CHUNK))
    mesh = types.SimpleNamespace(rank=0, size=1)
    out = dpaged.paged_decode_sharded(q, kp, vp, bt, kv_len, mesh=mesh,
                                      row_tokens=24)
    assert seen["row_tokens"] == 24 and out.shape == q.shape
