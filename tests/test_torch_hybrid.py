"""The port's hybrid recurrentgemma-2b (RG-LRU + local MQA attention)
against the JAX package, on the CPU.

recurrentgemma-2b SMOKE (3 layers: rec, rec, attn; d 64, 2/1 heads, D 32,
window 32), f32, JAX's params carried across by ``models/convert.py``.
The same numpy inputs go through JAX (``impl="xla"``, jit-compiled) and the
port (``impl="torch"`` or ``"kernel"``: on the CPU the kernels' plain
versions). Tolerances: the RG-LRU at 2e-5 (the JAX suite's f32 forward
tolerance; the port's doubling scan and ``associative_scan`` associate the
products differently), logits at 1e-4 (as ``tests/test_torch_paged.py``:
f32 projections and a vocab head whose sums XLA and torch order
differently), serving token-identical.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.runtime.steps import make_serve_steps as j_make_serve_steps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert, rglru  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.runtime.steps import make_serve_steps  # noqa: E402

ARCH = "recurrentgemma_2b"
TOL = 2e-5           # the JAX suite's f32 forward tolerance
LOGIT_TOL = 1e-4     # as tests/test_torch_paged.py


def _err(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _model(num_layers=3, window=None):
    """(JAX cfg, port cfg, JAX params, port params), f32; 5 layers add a
    (rec, rec) tail after the superblock."""
    kw = dict(num_layers=num_layers)
    if window is not None:
        kw["attn_window"] = window
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), dtype=jnp.float32,
                               remat=False, **kw)
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH), dtype=torch.float32,
                               **kw)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.convert_params(tcfg, jax.tree.map(np.asarray, params),
                                     device="cpu")
    return jcfg, tcfg, params, tparams


def _layer_state(tcfg, jcaches, i):
    """Layer i's cache dict of a JAX cache tree (stacked superblocks)."""
    return convert._layer_tree(tcfg, jax.tree.map(np.asarray, jcaches), i)


# ---------------------------------------------------------------------------
# config and convert
# ---------------------------------------------------------------------------

def test_config_matches_jax():
    for get in ("get_config", "smoke_config"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "attn_window", "block_pattern", "causal", "mlp_type"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.rglru.d_rnn == j.rglru.d_rnn
    assert tconfigs.get_config(ARCH).family == "hybrid"


@pytest.mark.parametrize("num_layers", [3, 5])
def test_convert_lands_every_leaf(num_layers):
    """Every JAX leaf (superblock rows and tail layers) lands in one port
    parameter of its shape and value; lambda stays f32."""
    jcfg, tcfg, params, tparams = _model(num_layers)
    leaves = jax.tree.leaves(params)
    named = dict(tparams.named_parameters())
    assert len(leaves) == len(named)
    assert sum(x.size for x in leaves) == sum(p.numel() for p in named.values())
    kinds = tlm.block_kinds(tcfg)
    assert [b.kind for b in tparams.blocks] == kinds
    assert kinds == ["rec", "rec", "attn", "rec", "rec"][:num_layers]
    host = jax.tree.map(np.asarray, params)
    for i, kind in enumerate(kinds):
        layer = convert._layer_tree(tcfg, host, i)
        names = (("wx", "wg", "wo", "conv", "w_inp", "w_rec", "lambda")
                 if kind == "rec" else ("wq", "wk", "wv", "wo"))
        assert set(layer["mixer"]) == set(names)
        for name in names:
            assert _err(named[f"blocks.{i}.mixer.{name}"],
                        layer["mixer"][name]) == 0.0, (i, name)
        if kind == "rec":
            assert named[f"blocks.{i}.mixer.lambda"].dtype == torch.float32
    for name, arr in convert._named_arrays(tcfg, host, tparams).items():
        assert tuple(named[name].shape) == np.asarray(arr).shape, name


# ---------------------------------------------------------------------------
# the RG-LRU mixer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mixer():
    jcfg, tcfg, _, _ = _model()
    jp, _ = jrglru.init_rglru(jax.random.PRNGKey(11), jcfg, jnp.float32)
    tp = rglru.RGLRU(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for n, w in tp.named_parameters():
            w.copy_(_t(jp[n]))
    return jcfg, tcfg, jp, tp


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def test_linear_scan_is_the_sequential_recurrence():
    r = np.random.default_rng(0)
    a = r.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32)
    b = r.standard_normal((2, 37, 5)).astype(np.float32)
    h, seq = np.zeros((2, 5), np.float32), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    assert _err(rglru._linear_scan(_t(a), _t(b)), np.stack(seq, 1)) < 1e-5


def test_rglru_scan_and_steps_match_jax():
    """Prefill (the scan, with its final state) and a decode chain against
    JAX's, and the port's scan against its own steps (as
    tests/test_models.py pins for JAX)."""
    jcfg, tcfg, jp, tp = _mixer()
    b, s = 2, 12
    x = _x(1, b, s, tcfg.d_model)
    jctx = JCtx(impl="xla")
    jout, jcache = jax.jit(lambda x: jrglru.apply_rglru(
        jp, x, jctx, jcfg, cache=jrglru.init_rglru_cache(jcfg, b)))(x)
    cache = rglru.init_rglru_cache(tcfg, b, "cpu")
    with torch.no_grad():
        out, cache = rglru.apply_rglru(tp, _t(x), Ctx(impl="torch"), tcfg,
                                       cache=cache)
        assert _err(out, jout) < TOL
        assert _err(cache["h"], jcache["h"]) < TOL
        assert _err(cache["conv"], jcache["conv"]) < TOL
        # steps: the port's chain against its scan and against JAX's steps
        jstep = jax.jit(lambda x, c: jrglru.apply_rglru(
            jp, x, dataclasses.replace(jctx, decode=True), jcfg, cache=c))
        tc = rglru.init_rglru_cache(tcfg, b, "cpu")
        jc = jrglru.init_rglru_cache(jcfg, b)
        dctx = Ctx(impl="torch", decode=True)
        for t in range(s):
            o_t, tc = rglru.apply_rglru(tp, _t(x[:, t:t + 1]), dctx, tcfg,
                                        cache=tc)
            jo_t, jc = jstep(x[:, t:t + 1], jc)
            assert _err(o_t[:, 0], out[:, t]) < TOL, f"step {t}"
            assert _err(o_t, jo_t) < TOL, f"step {t}"
        assert _err(tc["h"], cache["h"]) < TOL
        assert _err(tc["conv"], cache["conv"]) < TOL


def test_rglru_scan_grads_match_jax():
    """Gradients of the doubling scan against those of JAX's
    ``associative_scan`` (``GRAD_TOL`` of tests/test_torch_train.py: 1e-4 of
    each leaf's max), with r = 0 on some tokens (a_t = 1 exactly, where
    1 - a_t^2 = 0 takes the 1e-12 floor and passes no gradient)."""
    r = np.random.default_rng(4)
    b, s, d = 2, 37, 6
    x = r.standard_normal((b, s, d)).astype(np.float32)
    rg = r.uniform(0.0, 1.0, (b, s, d)).astype(np.float32)
    rg[:, ::5, :2] = 0.0
    ig = r.uniform(0.0, 1.0, (b, s, d)).astype(np.float32)
    lam = r.standard_normal(d).astype(np.float32)
    w = r.standard_normal((b, s, d)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda *a: (jrglru._rglru_scan(*a) * w).sum(),
                          argnums=(0, 1, 2, 3)))(x, rg, ig, lam)
    xs = [_t(a).requires_grad_() for a in (x, rg, ig, lam)]
    (rglru._rglru_scan(*xs) * _t(w)).sum().backward()
    for name, t, g in zip(("x", "r", "i", "lambda"), xs, jg):
        g = np.asarray(g)
        assert _err(t.grad, g) <= 1e-4 * float(np.abs(g).max()), name


def test_gate_norm_gradient_at_the_floor_matches_jax():
    """sqrt(max(u, 1e-12)): below, at and above the floor, the gradient is
    JAX's, half of it to u at the tie as ``jnp.maximum`` gives (a clamp
    would give all of it)."""
    u = np.array([0.0, np.float32(1e-12), 0.25, 1.0], np.float32)
    jg = np.asarray(jax.grad(
        lambda u: jnp.sqrt(jnp.maximum(u, 1e-12)).sum())(jnp.asarray(u)))
    t = _t(u).requires_grad_()
    rglru._gate_norm(t).sum().backward()
    assert np.array_equal(t.grad.numpy(), jg)
    assert jg[1] == np.float32(0.5 / np.sqrt(np.float32(1e-12)) / 2)


def test_rglru_packed_scan_matches_jax():
    """One packed prefill row of three spans (a fresh span, a continuation
    resuming its slot's carried state, a fresh span of one token) and
    padding, over state rows [n_slots + 1, ...] whose trash row holds 1e6:
    outputs at live tokens and the scattered rows against JAX's."""
    jcfg, tcfg, jp, tp = _mixer()
    n_slots, s, dr = 3, 16, tcfg.rglru.d_rnn
    x = _x(2, 1, s, tcfg.d_model)
    slots = np.full((1, s), -1, np.int32)
    local = np.zeros((1, s), np.int32)
    pos = np.zeros((1, s), np.int32)
    for slot, start, n, p0 in ((0, 0, 6, 0), (2, 6, 5, 9), (1, 11, 1, 0)):
        slots[0, start:start + n] = slot
        local[0, start:start + n] = np.arange(n)
        pos[0, start:start + n] = p0 + np.arange(n)
    r = np.random.default_rng(3)
    h0 = r.standard_normal((n_slots + 1, dr)).astype(np.float32)
    c0 = r.standard_normal((n_slots + 1, 3, dr)).astype(np.float32)
    h0[-1] = c0[-1] = 1e6
    paged = dict(state_slots=slots, state_local=local)
    jout, jcache = jax.jit(lambda x: jrglru.apply_rglru(
        jp, x, JCtx(impl="xla"), jcfg,
        cache={"h": jnp.asarray(h0), "conv": jnp.asarray(c0)},
        positions=jnp.asarray(pos),
        paged={k: jnp.asarray(v) for k, v in paged.items()}))(x)
    cache = {"h": _t(h0), "conv": _t(c0)}
    with torch.no_grad():
        out, cache = rglru.apply_rglru(
            tp, _t(x), Ctx(impl="torch"), tcfg, cache=cache,
            positions=_t(pos), paged={k: _t(v) for k, v in paged.items()})
    live = slots[0] >= 0
    assert _err(out[0, live], np.asarray(jout)[0, live]) < TOL
    assert _err(cache["h"][:n_slots], np.asarray(jcache["h"])[:n_slots]) < TOL
    assert _err(cache["conv"][:n_slots],
                np.asarray(jcache["conv"])[:n_slots]) < TOL


# ---------------------------------------------------------------------------
# lm: forward, prefill + decode through the ring, the paged steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_layers", [3, 5])
def test_lm_forward_matches_jax(num_layers):
    jcfg, tcfg, params, tparams = _model(num_layers)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 40)
                                               ).astype(np.int32)
    jlog, _, _ = jax.jit(lambda p, t: jlm.forward(
        jcfg, p, JCtx(impl="xla", xla_chunk=16), tokens=t))(params, tokens)
    for impl in ("torch", "kernel"):
        with torch.no_grad():
            tlog, _, _ = tlm.forward(tcfg, tparams,
                                     Ctx(impl=impl, torch_chunk=16),
                                     tokens=_t(tokens))
        assert _err(tlog, jlog) < LOGIT_TOL, impl


def test_prefill_and_decode_through_the_ring_match_jax():
    """A 40-token prompt past the 32-token window, then 8 decode steps: the
    attention layers' ring keeps 32 slots and wraps (as
    tests/test_models.py's ring test). Each step's logits against JAX's
    and against the port's teacher-forced full forward."""
    jcfg, tcfg, params, tparams = _model(5)
    b, s, n = 2, 40, 8
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (b, s + n)
                                               ).astype(np.int32)
    jctx = JCtx(impl="xla", xla_chunk=16)
    jcaches = jlm.init_cache(jcfg, b, s + n)
    jlog, jcaches = jax.jit(lambda p, t, c: jlm.prefill(
        jcfg, p, jctx, tokens=t, caches=c))(params, tokens[:, :s], jcaches)
    jdec = jax.jit(lambda p, t, c, pos: jlm.decode_step(jcfg, p, jctx, t, c,
                                                        pos))
    ctx = Ctx(impl="kernel", torch_chunk=16)
    with torch.no_grad():
        full, _, _ = tlm.forward(tcfg, tparams, ctx, tokens=_t(tokens))
        caches = tlm.init_cache(tcfg, b, s + n, device="cpu")
        assert caches[2]["k"].shape[2] == tcfg.attn_window
        assert set(caches[0]) == {"h", "conv"}
        log, caches = tlm.prefill(tcfg, tparams, ctx, _t(tokens[:, :s]), caches)
        assert _err(log, jlog) < LOGIT_TOL
        for t in range(n):
            pos = s + t
            log, caches = tlm.decode_step(tcfg, tparams, ctx,
                                          _t(tokens[:, pos]), caches, pos)
            jlog, jcaches = jdec(params, tokens[:, pos], jcaches, pos)
            assert _err(log, jlog) < LOGIT_TOL, f"step {t}"
            assert _err(log, full[:, pos]) < LOGIT_TOL, f"step {t}"
        for i in range(tcfg.num_layers):
            jl = _layer_state(tcfg, jcaches, i)
            for key in caches[i]:
                if key != "index":
                    assert _err(caches[i][key], jl[key]) < 1e-4, (i, key)


def test_lm_paged_steps_match_jax():
    """Packed prefill of two prompts with state routing, a decode step gated
    on kv_len (slot 2 idle), a chunk continuing prompt 0 from its stored
    state: logits, pools and state rows against JAX's jitted paged steps.
    The verify step has no state routing, and both packages refuse it."""
    jcfg, tcfg, jparams, tparams = _model(5)
    ps, t, n_pages, width, mb = 4, 6, 14, 16, 3
    jpcfg = jserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                      max_batch=mb, max_pages_per_seq=t)
    pcfg = tserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                     max_batch=mb, max_pages_per_seq=t)
    jarts = j_make_serve_steps(jcfg, impl="xla", paged=jpcfg, xla_chunk=16)
    tarts = make_serve_steps(tcfg, impl="kernel", paged=pcfg, torch_chunk=16,
                             device="cpu")
    jcaches, tcaches = jarts.cache_init_fn(), tarts.cache_init_fn()
    assert tcaches[0]["h"].shape == (mb + 1, tcfg.rglru.d_rnn)
    r = np.random.default_rng(21)
    tables = np.array([[4, 1, 8, 10, 0, 0], [6, 2, 12, 3, 0, 0],
                       [0] * 6], np.int32)

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
            jlayer = _layer_state(tcfg, jcaches, i)
            for key, val in layer.items():
                rows = slice(None) if key.endswith("pages") else slice(0, mb)
                assert _err(val[rows], jlayer[key][rows]) < 1e-4, (step, i, key)

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

    kv_len = np.array(list(lens) + [0], np.int32)       # slot 2 idle
    tok = r.integers(0, jcfg.vocab_size, mb).astype(np.int32)
    check("decode",
          jarts.decode_fn(jparams, jnp.asarray(tok), jcaches,
                          jnp.asarray(tables), jnp.asarray(kv_len)),
          tarts.decode_fn(tparams, _t(tok), tcaches, _t(tables), _t(kv_len)))
    kv_len[:2] += 1

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

    w = 2
    vargs = (np.zeros((mb, w), np.int32), np.zeros((mb, w), np.int32),
             np.zeros((mb, w), np.int32), np.zeros((mb, w, t), np.int32),
             np.ones((mb, w), np.int32))
    with pytest.raises(ValueError, match="state routing"):
        jarts.verify_fn(jparams, *map(jnp.asarray, vargs), jcaches)
    with pytest.raises(ValueError, match="state routing"):
        tarts.verify_fn(tparams, *map(_t, vargs), tcaches)


# ---------------------------------------------------------------------------
# the serving engine against JAX's, token for token
# ---------------------------------------------------------------------------

_LENS = ((12, 6), (7, 8), (9, 4))
_MODES = {
    # name: (window, (page_size, num_pages, max_batch, max_pages_per_seq),
    #        prefill_len, engine kwargs, request lengths)
    "eager": (None, (8, 9, 2, 3), 24, {}, _LENS),
    "lazy_preempt_poison": (None, (4, 8, 2, 8), 32,
                            {"lazy": True, "poison_reclaimed": True}, _LENS),
    "chunked_prefill": (None, (8, 9, 2, 3), 24, {"prefill_chunk": 4}, _LENS),
    "num_splits_2": (None, (8, 9, 2, 3), 24, {"num_splits": 2},
                     ((12, 6), (7, 5))),
    "window_reclaim_poison": (6, (4, 8, 2, 8), 32,
                              {"lazy": True, "poison_reclaimed": True}, _LENS),
}


def _reqs(vocab, lens):
    rs = np.random.RandomState(0)
    return [(rs.randint(0, vocab, size=n).astype(np.int32), g) for n, g in lens]


@pytest.mark.parametrize("mode", list(_MODES))
def test_engine_matches_jax(mode):
    window, (ps, n_pages, mb, mp), prefill_len, kw, lens = _MODES[mode]
    jcfg, tcfg, params, tparams = _model(3, window)
    jeng = jserving.ServingEngine(
        jcfg, jserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                        max_batch=mb, max_pages_per_seq=mp),
        params, impl="xla", prefill_len=prefill_len, xla_chunk=16, **kw)
    teng = tserving.ServingEngine(
        tcfg, tserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                        max_batch=mb, max_pages_per_seq=mp),
        tparams, impl="torch", device="cpu", prefill_len=prefill_len,
        torch_chunk=16, **kw)
    reqs = _reqs(jcfg.vocab_size, lens)
    jout, jstats = jeng.run(list(reqs))
    tout, tstats = teng.run(list(reqs))
    assert tstats["outcomes"] == jstats["outcomes"]
    assert set(tout) == set(jout) and jout
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid],
                                      err_msg=f"{mode}: request {rid}")
    for key in ("decode_steps", "preemptions", "pages_grown",
                "pages_reclaimed", "prefill_tokens", "state_releases"):
        assert tstats[key] == jstats[key], key
    assert tstats["state_releases"] == len(reqs) + tstats["preemptions"]
    if mode.startswith("lazy"):
        assert tstats["preemptions"] > 0
    if mode.startswith("window"):
        assert tstats["pages_reclaimed"] > 0
    state = teng.scheduler.tables.state
    assert state.num_occupied == 0 and state.num_free == mb


@pytest.mark.parametrize("kw,match", [({"share_prefix": True}, "prefix sharing"),
                                      ({"speculate_k": 2}, "speculative")])
def test_engine_refuses_what_jax_refuses(kw, match):
    jcfg, tcfg, params, tparams = _model()
    pc = dict(page_size=8, num_pages=9, max_batch=2, max_pages_per_seq=3)
    with pytest.raises(ValueError, match=match) as jerr:
        jserving.ServingEngine(jcfg, jserving.PagedCacheConfig(**pc), params,
                               impl="xla", **kw)
    with pytest.raises(ValueError, match=match) as terr:
        tserving.ServingEngine(tcfg, tserving.PagedCacheConfig(**pc), tparams,
                               impl="torch", device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_serve_cli_drives_the_hybrid(capsys):
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--impl", "kernel"]
    res = tserve.main(base + ["--batch", "2", "--prompt-len", "40",
                              "--gen", "6"])
    assert res.tokens.shape == (2, 6)
    out, stats, _ = tserve.main(base + ["--paged", "--requests", "4",
                                        "--prompt-len", "40", "--gen", "6",
                                        "--prefill-chunk", "16"])
    assert stats["outcomes"]["completed"] == 4 and len(out) == 4
    assert "served 4 requests" in capsys.readouterr().out
    for extra, match in ((["--share-prefix"], "prefix sharing"),
                         (["--speculate", "3"], "speculative")):
        with pytest.raises(SystemExit, match=match):
            tserve.main(base + ["--paged", "--requests", "2"] + extra)
    # over --mesh every rank keeps every recurrent state row; prompts past
    # the 32-token window reclaim pages of the sharded pool
    mesh = ["--paged", "--requests", "4", "--prompt-len", "48", "--gen", "6"]
    out_m, stats_m, ranks = tserve.main(base + mesh + [
        "--mesh", "2", "--dist-backend", "gloo"])
    assert "mesh: 2 ranks on the pool axis" in capsys.readouterr().out
    assert len(ranks) == 2 and stats_m["outcomes"]["completed"] == 4
    assert stats_m["pages_reclaimed"] > 0
    out_1, _, _ = tserve.main(base + mesh)
    assert set(out_m) == set(out_1)
    for rid in out_1:
        np.testing.assert_array_equal(out_m[rid], out_1[rid])
