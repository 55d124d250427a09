"""The port's paged attention against the JAX package, on the CPU.

Kernel level: the same numpy inputs go through JAX ``ops.paged_decode``
(Pallas interpret mode) and ``paged_decode_reference``, and through the
port's ``flash_paged_decode`` on a CPU tensor (the plain version of
``csrc/flash_decode.cu``'s paged cache), at the JAX suite's f32 tolerance
2e-5 (the port folds 64-row tiles, JAX page-sized blocks: the same sums in
another order). Model level: the three paged branches of
``layers.apply_attention`` on one layer and the four ``lm.paged_*`` entry
points on the granite-3-2b SMOKE config, against JAX with the weights
carried across by ``models/convert.py``, at 1e-4 on logits (f32 projections
and a vocab head whose sums XLA and torch order differently).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.attention import spark_paged_decode as j_spark_paged_decode  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime.steps import make_serve_steps as j_make_serve_steps  # noqa: E402
from repro.serving import PagedCacheConfig as JPagedCacheConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.attention import spark_paged_decode  # noqa: E402
from repro_torch.kernels import decode as tdecode  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.runtime.steps import make_serve_steps  # noqa: E402
from repro_torch.serving import PagedCacheConfig, TRASH_PAGE  # noqa: E402

TOL = 2e-5          # the JAX suite's f32 attention tolerance
LOGIT_TOL = 1e-4    # as tests/test_torch_serve.py


def _err(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _j_paged_decode(**kw):
    """JAX's paged kernel in interpret mode, jit-compiled (op-by-op dispatch
    of the interpreter dominates otherwise)."""
    return jax.jit(functools.partial(jops.paged_decode, interpret=True, **kw))


def _pool(seed, b, hq, hkv, d, ps, t, extra_pages=3):
    """q, a page pool and shuffled block tables for b rows (numpy, f32)."""
    r = np.random.default_rng(seed)
    n_pages = 1 + b * t + extra_pages
    q = r.standard_normal((b, hq, d), np.float32)
    kp = r.standard_normal((hkv, n_pages, ps, d), np.float32)
    vp = r.standard_normal((hkv, n_pages, ps, d), np.float32)
    bt = (r.permutation(n_pages - 1)[:b * t] + 1).reshape(b, t).astype(np.int32)
    return q, kp, vp, bt


def _both(q, kp, vp, bt, kv_len, **kw):
    """(port plain version, JAX kernel in interpret mode) on one input."""
    got = tdecode.flash_paged_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(kv_len),
                                     **kw)
    want = _j_paged_decode(**kw)(q, kp, vp, bt, kv_len)
    return got, np.asarray(want)


# ---------------------------------------------------------------------------
# kernel level
# ---------------------------------------------------------------------------

CASES = [
    # hq, hkv, page_size, window (tests/test_paged.py's, then the engine's
    # page sizes, where one 64-row tile spans many pages)
    (4, 4, 64, None),      # MHA
    (8, 2, 64, None),      # GQA
    (4, 2, 64, 100),       # sliding window masked in-kernel
    (4, 1, 128, None),     # MQA, bigger pages
    (8, 2, 16, None),      # granite's group of 4, the CLI's page size
    (10, 2, 4, 37),        # qwen3's group of 5, tiny pages, window
]


@pytest.mark.parametrize("hq,hkv,ps,window", CASES, ids=[str(c) for c in CASES])
def test_paged_plain_matches_jax(hq, hkv, ps, window):
    b, d = 3, 64
    t = max(4, 320 // ps)                    # a row spans several 64-row tiles
    q, kp, vp, bt = _pool(0, b, hq, hkv, d, ps, t)
    kv_len = np.array([t * ps, ps + 7, 3], np.int32)
    got, want = _both(q, kp, vp, bt, kv_len, window=window)
    assert _err(got, want) < TOL
    oracle = jops.paged_decode_reference(jnp.asarray(q), jnp.asarray(kp),
                                         jnp.asarray(vp), jnp.asarray(bt),
                                         jnp.asarray(kv_len), window=window)
    assert _err(got, oracle) < TOL
    t_oracle = tops.paged_decode_reference(_t(q), _t(kp), _t(vp), _t(bt),
                                           _t(kv_len), window=window)
    assert _err(t_oracle, oracle) < TOL


@pytest.mark.parametrize("ps", [16, 64])
def test_paged_equals_contiguous(ps):
    """Same logical KV, scattered pages vs the gathered contiguous cache:
    the two plain versions walk the same tiles, bit for bit."""
    b, hq, hkv, d, t = 2, 8, 2, 64, 256 // ps
    q, kp, vp, bt = _pool(1, b, hq, hkv, d, ps, t)
    kv_len = np.array([t * ps, 2 * ps - 5], np.int32)
    kc = tdecode.gather_pages(_t(kp), _t(bt))
    assert _err(kc, jops.gather_pages(jnp.asarray(kp), jnp.asarray(bt))) == 0.0
    vc = tdecode.gather_pages(_t(vp), _t(bt))
    for ns in (1, 2):
        o_paged = tdecode.flash_paged_decode(_t(q), _t(kp), _t(vp), _t(bt),
                                             _t(kv_len), num_splits=ns)
        o_contig = tdecode.flash_decode(_t(q), kc, vc, kv_len=_t(kv_len),
                                        num_splits=ns)
        assert _err(o_paged, o_contig) == 0.0


@pytest.mark.parametrize("window", [None, 20])
def test_paged_trash_entries_are_inert(window):
    """Entries past a row's allocation (and, with a window, reclaimed
    entries before it) point at the trash page; a 1e6 poison there must not
    move the output by one bit."""
    b, hq, hkv, d, ps, t = 2, 4, 2, 64, 16, 8
    q, kp, vp, bt = _pool(2, b, hq, hkv, d, ps, t)
    kv_len = np.array([ps + 3, 4 * ps], np.int32)
    bt[0, 2:] = TRASH_PAGE                   # row 0 owns 2 pages
    bt[1, 4:] = TRASH_PAGE                   # row 1 owns 4
    if window is not None:
        bt[1, :2] = TRASH_PAGE               # wholly out of row 1's window
    clean, want = _both(q, kp, vp, bt, kv_len, window=window)
    kp[:, TRASH_PAGE], vp[:, TRASH_PAGE] = 1e6, 1e6
    poisoned, _ = _both(q, kp, vp, bt, kv_len, window=window)
    assert _err(clean, poisoned) == 0.0
    assert _err(poisoned, want) < TOL


@pytest.mark.parametrize("ns", [1, 2, 3, 7])
def test_paged_num_splits_matches_jax(ns):
    b, hq, hkv, d, ps, t = 3, 8, 2, 64, 16, 24
    q, kp, vp, bt = _pool(3, b, hq, hkv, d, ps, t)
    kv_len = np.array([t * ps, 200, 1], np.int32)
    got, want = _both(q, kp, vp, bt, kv_len, num_splits=ns)
    assert _err(got, want) < TOL
    # the plain impls gather and split the gathered length, as JAX's XLA path
    for impl in ("torch", "naive"):
        o = spark_paged_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(kv_len),
                               impl=impl, num_splits=ns)
        jo = j_spark_paged_decode(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(bt),
                                  jnp.asarray(kv_len), impl="xla", num_splits=ns)
        assert _err(o, jo) < TOL


def test_paged_token_rows_with_zero_length():
    """Chunked prefill's B·S token rows: each token attends through its own
    table row to ``position + 1`` keys; padding rows (kv_len 0) give exact
    zeros."""
    hq, hkv, d, ps, t = 8, 2, 64, 4, 10
    q, kp, vp, bt = _pool(4, 1, hq, hkv, d, ps, t)
    n_tok = 12
    r = np.random.default_rng(5)
    qt = r.standard_normal((n_tok, hq, d), np.float32)
    tables = np.repeat(bt, n_tok, axis=0)
    kv_len = np.array([17, 18, 19, 20, 21, 0, 0, 33, 34, 35, 0, 40], np.int32)
    for ns in (1, 3):
        got, want = _both(qt, kp, vp, tables, kv_len, num_splits=ns)
        assert _err(got, want) < TOL
        assert float(got[kv_len == 0].abs().max()) == 0.0


def test_paged_wrapper_checks():
    q, kp, vp, bt = _pool(6, 2, 4, 2, 16, 4, 3)
    kv_len = _t(np.array([5, 6], np.int32))
    with pytest.raises(ValueError, match="block_tables"):
        tdecode.flash_paged_decode(_t(q), _t(kp), _t(vp), _t(bt[:1]), kv_len)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        tdecode.flash_paged_decode(_t(q[:, :3]), _t(kp), _t(vp), _t(bt), kv_len)
    before = tdecode.launches_paged
    tdecode.flash_paged_decode(_t(q), _t(kp), _t(vp), _t(bt), kv_len)
    assert tdecode.launches_paged == before     # the plain version never counts


# ---------------------------------------------------------------------------
# the paged branches of apply_attention, one layer
# ---------------------------------------------------------------------------

def _layer(arch="granite_3_2b"):
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32)
    jp, _ = jlayers.init_attention(jax.random.PRNGKey(7), jcfg, jnp.float32)
    tp = tlayers.Attention(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, w in tp.named_parameters():
            w.copy_(_t(np.asarray(jp[name])))
    return jcfg, tcfg, jp, tp


def _pools(cfg, n_pages, ps, seed):
    r = np.random.default_rng(seed)
    shape = (cfg.num_kv_heads, n_pages, ps, cfg.head_dim)
    return (r.standard_normal(shape, np.float32),
            r.standard_normal(shape, np.float32))


def _run_layer(jcfg, tcfg, jp, tp, x, pools, positions, paged, *, decode,
               impl, segment_ids=None):
    jctx = jlayers.Ctx(impl="xla", decode=decode)

    @jax.jit
    def j_apply(jp, x, positions, cache, segment_ids, paged):
        return jlayers.apply_attention(jp, x, jctx, jcfg, positions=positions,
                                       cache=cache, segment_ids=segment_ids,
                                       paged=paged)

    jout, jcache = j_apply(
        jp, x, positions, {"k_pages": pools[0], "v_pages": pools[1]},
        segment_ids, paged)
    tctx = tlayers.Ctx(impl=impl, decode=decode, torch_chunk=8)
    cache = {"k_pages": _t(pools[0].copy()), "v_pages": _t(pools[1].copy())}
    with torch.no_grad():
        tout, tcache = tlayers.apply_attention(
            tp, _t(x), tctx, tcfg, positions=_t(positions), cache=cache,
            segment_ids=None if segment_ids is None else _t(segment_ids),
            paged={k: _t(v) for k, v in paged.items()})
    assert tcache["k_pages"] is cache["k_pages"]          # updated in place
    for name in ("k_pages", "v_pages"):
        assert _err(tcache[name], jcache[name]) < 1e-5
    assert _err(tout, jout) < 1e-4


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_apply_attention_paged_decode(impl):
    jcfg, tcfg, jp, tp = _layer()
    ps, t = 4, 5
    pools = _pools(jcfg, 12, ps, 8)
    r = np.random.default_rng(9)
    x = r.standard_normal((3, 1, jcfg.d_model), np.float32)
    bt = np.array([[3, 7, 1, 0, 0], [2, 5, 9, 4, 11], [0] * 5], np.int32)
    kv_len = np.array([9, 17, 0], np.int32)               # row 2 inactive
    _run_layer(jcfg, tcfg, jp, tp, x, pools, kv_len[:, None],
               {"block_tables": bt, "kv_len": kv_len}, decode=True, impl=impl)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_apply_attention_packed_prefill(impl):
    jcfg, tcfg, jp, tp = _layer("qwen3_14b")
    ps = 4
    pools = _pools(jcfg, 10, ps, 10)
    s = 16
    x = np.random.default_rng(11).standard_normal((1, s, jcfg.d_model),
                                                  np.float32)
    seg = np.array([[0] * 9 + [1] * 5 + [-1] * 2], np.int32)
    pos = np.array([list(range(9)) + list(range(5)) + [0, 0]], np.int32)
    pages = {0: [4, 1, 8], 1: [6, 2]}
    dest = np.zeros((1, s), np.int32)                     # pad → trash slot 0
    for i in range(14):
        sid, p = seg[0, i], pos[0, i]
        dest[0, i] = pages[sid][p // ps] * ps + p % ps
    _run_layer(jcfg, tcfg, jp, tp, x, pools, pos, {"dest": dest},
               decode=False, impl=impl, segment_ids=seg)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_apply_attention_chunk_prefill(impl):
    """Spans of two sequences whose earlier tokens are already in pages:
    each token reads its history and its same-row predecessors through its
    own table row; padding tokens write the trash page and read nothing."""
    jcfg, tcfg, jp, tp = _layer()
    ps, t = 4, 6
    pools = _pools(jcfg, 14, ps, 12)
    tables = {0: np.array([5, 2, 9, 11, 0, 0], np.int32),
              1: np.array([3, 13, 7, 1, 6, 0], np.int32)}
    spans = [(0, 6, 11), (1, 13, 18)]                     # (seq, start, end)
    s = 12
    pos = np.zeros((1, s), np.int32)
    kvl = np.zeros((1, s), np.int32)
    dest = np.zeros((1, s), np.int32)
    ttab = np.zeros((1, s, t), np.int32)
    off = 0
    for sid, a, b in spans:
        n = b - a
        pos[0, off:off + n] = np.arange(a, b)
        kvl[0, off:off + n] = np.arange(a, b) + 1
        ttab[0, off:off + n] = tables[sid]
        dest[0, off:off + n] = [tables[sid][p // ps] * ps + p % ps
                                for p in range(a, b)]
        off += n
    x = np.random.default_rng(13).standard_normal((1, s, jcfg.d_model),
                                                  np.float32)
    _run_layer(jcfg, tcfg, jp, tp, x, pools, pos,
               {"dest": dest, "token_tables": ttab, "token_kv_len": kvl},
               decode=False, impl=impl)


# ---------------------------------------------------------------------------
# lm's paged entry points through make_serve_steps(paged=), SMOKE config
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = convert_params(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    return jcfg, tcfg, params, tparams


@pytest.mark.parametrize("impl,num_splits", [("kernel", 1), ("torch", 2)])
def test_lm_paged_steps_match_jax(impl, num_splits):
    """Packed prefill of two prompts, a decode step, a chunk continuing one
    of them, and a verify step of width 3 over both: logits and pools
    against JAX's jitted paged steps on the same params and routing."""
    jcfg, tcfg, jparams, tparams = _model("granite_3_2b")
    ps, t, n_pages, width = 4, 6, 14, 16
    jpcfg = JPagedCacheConfig(page_size=ps, num_pages=n_pages, max_batch=2,
                              max_pages_per_seq=t)
    pcfg = PagedCacheConfig(page_size=ps, num_pages=n_pages, max_batch=2,
                            max_pages_per_seq=t)
    jarts = j_make_serve_steps(jcfg, impl="xla", paged=jpcfg, xla_chunk=16,
                               num_splits=num_splits)
    tarts = make_serve_steps(tcfg, impl=impl, paged=pcfg, torch_chunk=16,
                             num_splits=num_splits, device="cpu")
    jcaches, tcaches = jarts.cache_init_fn(), tarts.cache_init_fn()
    r = np.random.default_rng(21)
    tables = np.array([[4, 1, 8, 10, 0, 0], [6, 2, 12, 3, 0, 0]], np.int32)

    def slots(row, a, b):
        return [tables[row][p // ps] * ps + p % ps for p in range(a, b)]

    def check(step, jout, tout, ends=None):
        # ends: the rows that end a span, the only rows whose logits the
        # port's prefill and chunk steps return (JAX returns every row's)
        nonlocal jcaches, tcaches
        jl, jcaches = jout
        tl, tcaches = tout
        if ends is not None:
            jl = jl[0, np.asarray(ends)]
        assert tl.shape == jl.shape
        assert _err(tl, jl) < LOGIT_TOL, f"{step}: logits"
        for i, layer in enumerate(tcaches):
            for key in ("k_pages", "v_pages"):
                jp = np.asarray(jcaches["blocks"]["sub_0"][key][i])
                assert _err(layer[key], jp) < 1e-5, f"{step}: {key} {i}"

    # packed prefill: prompts of 9 and 5 tokens in one row of 16
    lens = (9, 5)
    tokens = np.zeros((1, width), np.int32)
    seg = np.full((1, width), -1, np.int32)
    pos = np.zeros((1, width), np.int32)
    dest = np.zeros((1, width), np.int32)
    state_slots = np.full((1, width), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        tokens[0, off:off + n] = r.integers(0, jcfg.vocab_size, n)
        seg[0, off:off + n] = i
        pos[0, off:off + n] = np.arange(n)
        dest[0, off:off + n] = slots(i, 0, n)
        state_slots[0, off:off + n] = i
        off += n
    args = (tokens, seg, pos, dest, state_slots)
    check("prefill", jarts.prefill_fn(jparams, *map(jnp.asarray, args), jcaches),
          tarts.prefill_fn(tparams, *map(_t, args), tcaches),
          ends=np.cumsum(lens) - 1)

    # one decode step of both rows
    kv_len = np.array(lens, np.int32)
    tok = r.integers(0, jcfg.vocab_size, 2).astype(np.int32)
    check("decode",
          jarts.decode_fn(jparams, jnp.asarray(tok), jcaches,
                          jnp.asarray(tables), jnp.asarray(kv_len)),
          tarts.decode_fn(tparams, _t(tok), tcaches, _t(tables), _t(kv_len)))
    kv_len += 1

    # a chunk continuing row 0 at positions 10..14 (padding after it)
    a, b = int(kv_len[0]), int(kv_len[0]) + 5
    tokens = np.zeros((1, 8), np.int32)
    tokens[0, :5] = r.integers(0, jcfg.vocab_size, 5)
    pos = np.zeros((1, 8), np.int32)
    pos[0, :5] = np.arange(a, b)
    kvl = np.zeros((1, 8), np.int32)
    kvl[0, :5] = np.arange(a, b) + 1
    dest = np.zeros((1, 8), np.int32)
    dest[0, :5] = slots(0, a, b)
    ttab = np.zeros((1, 8, t), np.int32)
    ttab[0, :5] = tables[0]
    local = np.zeros((1, 8), np.int32)
    local[0, :5] = np.arange(5)
    sl = np.where(kvl > 0, 0, -1).astype(np.int32)
    args = (tokens, pos, dest, ttab, kvl, sl, local)
    check("chunk", jarts.chunk_prefill_fn(jparams, *map(jnp.asarray, args),
                                          jcaches),
          tarts.chunk_prefill_fn(tparams, *map(_t, args), tcaches),
          ends=[4])
    kv_len[0] = b

    # verify width 3 over both rows (row 1 drafts only one token)
    w = 3
    tokens = r.integers(0, jcfg.vocab_size, (2, w)).astype(np.int32)
    pos = np.zeros((2, w), np.int32)
    kvl = np.zeros((2, w), np.int32)
    dest = np.zeros((2, w), np.int32)
    ttab = np.zeros((2, w, t), np.int32)
    for row, m in ((0, 3), (1, 2)):
        L = int(kv_len[row])
        pos[row, :m] = L + np.arange(m)
        kvl[row, :m] = L + 1 + np.arange(m)
        dest[row, :m] = slots(row, L, L + m)
        ttab[row, :m] = tables[row]
    args = (tokens, pos, dest, ttab, kvl)
    check("verify", jarts.verify_fn(jparams, *map(jnp.asarray, args), jcaches),
          tarts.verify_fn(tparams, *map(_t, args), tcaches))


def test_paged_cache_layout():
    tcfg = dataclasses.replace(tconfigs.smoke_config("qwen3_14b"),
                               dtype=torch.float32)
    pcfg = PagedCacheConfig(page_size=8, num_pages=5, max_batch=2,
                            max_pages_per_seq=2)
    caches = tlm.init_paged_cache(tcfg, pcfg, device="cpu")
    assert len(caches) == tcfg.num_layers
    assert caches[0]["k_pages"].shape == (tcfg.num_kv_heads, 5, 8,
                                          tcfg.head_dim)
    assert float(caches[0]["v_pages"].abs().max()) == 0.0
