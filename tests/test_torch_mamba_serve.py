"""The port's falcon-mamba-7b (the ssm family) served and trained, against
the JAX package, on the CPU: the contiguous and paged serving steps, the
``ServingEngine`` token for token in three modes and over a two-rank gloo
mesh, the refusals, the loss and its gradients, a five-step AdamW
trajectory, a JAX ``Trainer`` checkpoint resumed, and both launchers.

falcon-mamba-7b SMOKE (2 mixer-only layers, d 64, Di 128, N 4), f32,
JAX's params carried across by ``models/convert.py``. Tolerances: logits
at 1e-4 and state rows at 1e-4 (as ``tests/test_torch_hybrid.py``),
serving token-identical, the loss 1e-5 relative and each gradient leaf 1e-4
of its max, the trajectory and the resumed step as the hybrid's in
``tests/test_torch_train.py``. The ranks' function lives here; a spawned
rank imports this module.
"""

import dataclasses
import functools
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.runtime.steps import make_serve_steps as j_make_serve_steps  # noqa: E402
from repro.runtime.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.runtime.trainer import Trainer as JTrainer  # noqa: E402
from repro.runtime.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.steps import (make_serve_steps, make_train_step,  # noqa: E402
                                       place_batch)
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

ARCH = "falcon_mamba_7b"
LOGIT_TOL = 1e-4     # as tests/test_torch_hybrid.py
LOSS_RTOL = 1e-5     # as tests/test_torch_train.py
GRAD_TOL = 1e-4
N_RANKS = 2


def _err(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _leaf_err(g, jg):
    """max |g - jg| over max |jg|."""
    jg = np.asarray(jg, np.float32)
    return _err(g, jg) / max(float(np.abs(jg).max()), 1e-30)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _model():
    """(JAX cfg, port cfg, JAX params, numpy tree, port params), f32."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), dtype=jnp.float32,
                               remat=False)
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH), dtype=torch.float32)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    tree = _np(params)
    return jcfg, tcfg, params, tree, convert.convert_params(tcfg, tree,
                                                            device="cpu")


def _layer_state(tcfg, jcaches, i):
    """Layer i's cache dict of a JAX cache tree (stacked layers)."""
    return convert._layer_tree(tcfg, _np(jcaches), i)


# ---------------------------------------------------------------------------
# the serving steps
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_jax():
    """A 40-token prompt, then 8 decode steps: each step's logits against
    JAX's and against the port's teacher-forced full forward (the chunk
    scan), and every layer's state rows against JAX's."""
    jcfg, tcfg, params, _, tparams = _model()
    b, s, n = 2, 40, 8
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (b, s + n)
                                               ).astype(np.int32)
    jctx = JCtx(impl="xla")
    jlog, jcaches = jax.jit(lambda p, t, c: jlm.prefill(
        jcfg, p, jctx, tokens=t, caches=c))(params, tokens[:, :s],
                                            jlm.init_cache(jcfg, b, s + n))
    jdec = jax.jit(lambda p, t, c, pos: jlm.decode_step(jcfg, p, jctx, t, c,
                                                        pos))
    ctx = Ctx(impl="kernel")
    with torch.no_grad():
        full, _, _ = tlm.forward(tcfg, tparams, ctx, tokens=_t(tokens))
        caches = tlm.init_cache(tcfg, b, s + n, device="cpu")
        assert all(set(c) == {"h", "conv"} for c in caches)
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
            for key in ("h", "conv"):
                assert _err(caches[i][key], jl[key]) < 1e-4, (i, key)


def test_lm_paged_steps_match_jax():
    """Packed prefill of two prompts with state routing, a decode step gated
    on kv_len (slot 2 idle), a chunk continuing prompt 0 from its stored
    state: logits and state rows against JAX's jitted paged steps. There is
    no page pool to fill; the verify step has no state routing, and both
    packages refuse it."""
    jcfg, tcfg, jparams, _, tparams = _model()
    ps, t, n_pages, width, mb = 4, 6, 14, 16, 3
    jpcfg = jserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                      max_batch=mb, max_pages_per_seq=t)
    pcfg = tserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                     max_batch=mb, max_pages_per_seq=t)
    jarts = j_make_serve_steps(jcfg, impl="xla", paged=jpcfg)
    tarts = make_serve_steps(tcfg, impl="kernel", paged=pcfg, device="cpu")
    jcaches, tcaches = jarts.cache_init_fn(), tarts.cache_init_fn()
    mc = tcfg.mamba
    assert [tuple(c["h"].shape) for c in tcaches] == \
        [(mb + 1, mc.d_inner, mc.ssm_state)] * tcfg.num_layers
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
                assert _err(val[:mb], jlayer[key][:mb]) < 1e-4, (step, i, key)

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
    idle = [c["h"][2].clone() for c in tcaches]
    check("decode",
          jarts.decode_fn(jparams, jnp.asarray(tok), jcaches,
                          jnp.asarray(tables), jnp.asarray(kv_len)),
          tarts.decode_fn(tparams, _t(tok), tcaches, _t(tables), _t(kv_len)))
    assert all(torch.equal(c["h"][2], h) for c, h in zip(tcaches, idle))
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
    # name: ((page_size, num_pages, max_batch, max_pages_per_seq),
    #        prefill_len, engine kwargs)
    "eager": ((8, 9, 2, 3), 24, {}),
    "lazy_preempt_poison": ((4, 8, 2, 8), 32,
                            {"lazy": True, "poison_reclaimed": True}),
    "chunked_prefill": ((8, 9, 2, 3), 24, {"prefill_chunk": 4}),
}


def _reqs(vocab):
    rs = np.random.RandomState(0)
    return [(rs.randint(0, vocab, size=n).astype(np.int32), g) for n, g in _LENS]


def _pcfg(pkg, ps, n_pages, mb, mp, shards=1):
    return pkg.PagedCacheConfig(page_size=ps, num_pages=n_pages, max_batch=mb,
                                max_pages_per_seq=mp, num_shards=shards)


@functools.lru_cache(maxsize=None)
def _jax_engine(mode):
    """JAX's engine in ``mode``: (outputs, stats)."""
    jcfg, _, params, _, _ = _model()
    pool, prefill_len, kw = _MODES[mode]
    eng = jserving.ServingEngine(jcfg, _pcfg(jserving, *pool), params,
                                 impl="xla", prefill_len=prefill_len, **kw)
    return eng.run(_reqs(jcfg.vocab_size))


@pytest.mark.parametrize("mode", list(_MODES))
def test_engine_matches_jax(mode):
    _, tcfg, _, _, tparams = _model()
    pool, prefill_len, kw = _MODES[mode]
    teng = tserving.ServingEngine(tcfg, _pcfg(tserving, *pool), tparams,
                                  impl="torch", device="cpu",
                                  prefill_len=prefill_len, **kw)
    assert teng._pools() == [] and teng.has_state
    reqs = _reqs(tcfg.vocab_size)
    jout, jstats = _jax_engine(mode)
    tout, tstats = teng.run(list(reqs))
    assert tstats["outcomes"] == jstats["outcomes"]
    assert set(tout) == set(jout) and jout
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid],
                                      err_msg=f"{mode}: request {rid}")
    for key in ("decode_steps", "preemptions", "pages_grown",
                "prefill_tokens", "state_releases"):
        assert tstats[key] == jstats[key], key
    assert tstats["state_releases"] == len(reqs) + tstats["preemptions"]
    if mode.startswith("lazy"):
        assert tstats["preemptions"] > 0
    state = teng.scheduler.tables.state
    assert state.num_occupied == 0 and state.num_free == pool[2]


@pytest.mark.parametrize("kw,match", [({"share_prefix": True}, "prefix sharing"),
                                      ({"speculate_k": 2}, "speculative")])
def test_engine_refuses_what_jax_refuses(kw, match):
    jcfg, tcfg, params, _, tparams = _model()
    pool = (8, 9, 2, 3)
    with pytest.raises(ValueError, match=match) as jerr:
        jserving.ServingEngine(jcfg, _pcfg(jserving, *pool), params,
                               impl="xla", **kw)
    with pytest.raises(ValueError, match=match) as terr:
        tserving.ServingEngine(tcfg, _pcfg(tserving, *pool), tparams,
                               impl="torch", device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_autotune_is_refused_with_its_reason():
    """An attention-free arch has no attention decode to split: the port's
    engine raises a named ValueError, where JAX's engine divides by its
    zero KV heads (a parked fault of the reference)."""
    jcfg, tcfg, params, _, tparams = _model()
    pool = (8, 9, 2, 3)
    with pytest.raises(ZeroDivisionError):
        jserving.ServingEngine(jcfg, _pcfg(jserving, *pool), params,
                               impl="xla", autotune=True)
    with pytest.raises(ValueError, match="no attention layer, so there is no "
                                         "attention decode to split"):
        tserving.ServingEngine(tcfg, _pcfg(tserving, *pool), tparams,
                               impl="torch", device="cpu", autotune=True)


# the mesh: num_pages a multiple of the two shards (one trash page each)
_MESH_MODES = {
    "eager": ((8, 10, 2, 3), 24, {"poison_reclaimed": True}),
    "lazy_preempt_poison": ((4, 8, 2, 8), 32,
                            {"lazy": True, "poison_reclaimed": True}),
    "chunked_prefill": ((8, 10, 2, 3), 24, {"prefill_chunk": 4}),
}


def _mesh_rank(mesh, device, tcfg, tree, reqs):
    """One rank: the engine over the mesh in every mode of ``_MESH_MODES``."""
    params = convert.convert_params(tcfg, tree, device=device)
    res = {}
    for mode, (pool, prefill_len, kw) in _MESH_MODES.items():
        eng = tserving.ServingEngine(tcfg, _pcfg(tserving, *pool, N_RANKS),
                                     params, impl="torch", device=device,
                                     mesh=mesh, prefill_len=prefill_len, **kw)
        out, stats = eng.run(list(reqs))
        res[mode] = {"out": out, "stats": stats, "pools": len(eng._pools()),
                     "state_rows": [tuple(c["h"].shape) for c in eng.caches],
                     "state_free": eng.scheduler.tables.state.num_free}
    return res


def test_sharded_engine_matches_jax():
    """Two gloo ranks serve through ``ServingEngine(mesh=)`` in three modes:
    every rank keeps every state row, on its half of the mixer's channels
    (the serving rules split ``rnn`` over ``model``; there is no attention
    pool), and emits JAX's single-device tokens, with equal stats on both
    ranks."""
    _, tcfg, _, tree, _ = _model()
    reqs = _reqs(tcfg.vocab_size)
    jout, _ = _jax_engine("eager")
    ranks = tmesh.run_ranks(_mesh_rank, N_RANKS, (tcfg, tree, reqs),
                            backend="gloo", device_type="cpu", timeout_s=600)
    mc = tcfg.mamba
    for mode, (pool, _, _) in _MESH_MODES.items():
        r0, r1 = (r[mode] for r in ranks)
        assert r0["stats"] == r1["stats"], mode
        for r in (r0, r1):
            assert r["pools"] == 0 and r["state_free"] == pool[2]
            assert r["state_rows"] == [(pool[2] + 1, mc.d_inner // N_RANKS,
                                        mc.ssm_state)] * tcfg.num_layers
            assert set(r["out"]) == set(jout)
            for rid in jout:
                np.testing.assert_array_equal(r["out"][rid], jout[rid],
                                              err_msg=f"{mode}: request {rid}")
        assert r0["stats"]["state_releases"] == \
            len(reqs) + r0["stats"]["preemptions"]
    assert ranks[0]["lazy_preempt_poison"]["stats"]["preemptions"] > 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [48, 512])
def test_loss_and_grads_match_jax(seq):
    """``loss_fn`` and every gradient leaf against JAX's; 512 tokens scan as
    two chunks of 256, 48 as one."""
    jcfg, tcfg, params, tree, _ = _model()
    batch = make_batch(DataConfig(vocab_size=tcfg.vocab_size, seq_len=seq,
                                  global_batch=2, seed=11), 0)

    def jloss(p, b):
        return jlm.loss_fn(jcfg, p, b, jlayers.Ctx(impl="xla"))
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.convert_params(tcfg, tree, device="cpu")
    loss, metrics = tlm.loss_fn(tcfg, model, place_batch(batch, "cpu"),
                                Ctx(impl="kernel"))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert set(metrics) == {"ce", "loss"}
    jnamed = convert._named_arrays(tcfg, _np(jg), model)
    for name, p in model.named_parameters():
        assert _leaf_err(p.grad, jnamed[name]) <= GRAD_TOL, name


def test_five_step_trajectory_matches_jax():
    """Five ``make_train_step`` steps of JAX and the port from one converted
    state: the loss each step within 1e-4, every parameter at the end within
    1e-4 of its leaf's max (the hybrid's tolerances)."""
    jcfg, tcfg, _, _, _ = _model()
    kw = dict(total_steps=5, warmup_steps=2)
    jarts = j_make_train_step(jcfg, opt=JAdamWConfig(lr=1e-3), impl="xla",
                              donate=False, **kw)
    jparams, jopt, _ = jarts.init_fn(jax.random.PRNGKey(1))
    tarts = make_train_step(tcfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                            device="cpu", **kw)
    params = convert.convert_params(tcfg, _np(jparams), device="cpu")
    opt = convert.convert_opt_state(tcfg, _np(jopt), params, device="cpu")
    dc = DataConfig(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=4,
                    seed=2)
    for step in range(5):
        batch = make_batch(dc, step)
        jparams, jopt, jm = jarts.step_fn(
            jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.int32(step))
        params, opt, tm = tarts.step_fn(params, opt, place_batch(batch, "cpu"),
                                        step)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-4 * abs(float(jm["loss"]))
    jnamed = convert._named_arrays(tcfg, _np(jparams), params)
    for name, p in params.named_parameters():
        assert _leaf_err(p.data, jnamed[name]) <= 1e-4, name
    assert opt.step == int(jopt.step) == 5


def test_trainer_resumes_a_jax_checkpoint(tmp_path):
    """The JAX ``Trainer`` takes two steps and checkpoints; the port's
    ``Trainer`` resumes that checkpoint and takes the third step, which
    JAX's takes too from a copy of the directory: every parameter within
    1e-6 of each leaf's max, the loss within ``LOSS_RTOL``."""
    jcfg, tcfg, _, _, _ = _model()
    kw = dict(vocab_size=tcfg.vocab_size, seq_len=24, global_batch=2, seed=1)
    tc = dict(ckpt_every=100, log_every=1000)
    jarts = j_make_train_step(jcfg, opt=JAdamWConfig(lr=1e-3), impl="xla",
                              donate=False)
    JTrainer(arts=jarts, data_cfg=JDataConfig(**kw), tcfg=JTrainerConfig(
        ckpt_dir=str(tmp_path / "jax"), **tc)).run(2)
    assert tckpt.is_jax_layout(str(tmp_path / "jax"), 1)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jt = JTrainer(arts=jarts, data_cfg=JDataConfig(**kw), tcfg=JTrainerConfig(
        ckpt_dir=str(tmp_path / "jax"), **tc))
    jparams = _np(jt.run(3)["params"])
    arts = make_train_step(tcfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                           device="cpu")
    t = Trainer(arts=arts, data_cfg=DataConfig(**kw), tcfg=TrainerConfig(
        ckpt_dir=str(tmp_path / "port"), **tc))
    r = t.run(3)
    assert [m["step"] for m in t.metrics_log] == [2] == \
        [m["step"] for m in jt.metrics_log]
    jl = jt.metrics_log[0]["loss"]
    assert abs(t.metrics_log[0]["loss"] - jl) <= LOSS_RTOL * abs(jl)
    assert r["opt"].step == 3
    jnamed = convert._named_arrays(tcfg, jparams, r["params"])
    for name, p in r["params"].named_parameters():
        assert _leaf_err(p.data, jnamed[name]) <= 1e-6, name
    assert tckpt.latest_step(str(tmp_path / "port")) == 2
    assert not tckpt.is_jax_layout(str(tmp_path / "port"), 2)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_serve_cli_drives_the_ssm(capsys):
    """The contiguous path, the paged engine (chunked prefill), the
    refusals (prefix sharing, speculation, ``--autotune`` on both caches),
    and ``--paged --mesh 2`` on gloo ranks giving the one-device tokens."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu"]
    res = tserve.main(base + ["--batch", "2", "--prompt-len", "24",
                              "--gen", "6"])
    assert res.tokens.shape == (2, 6)
    assert all(torch.isfinite(x).all() for x in res.logits)
    out, stats, _ = tserve.main(base + ["--paged", "--requests", "4",
                                        "--prompt-len", "24", "--gen", "6",
                                        "--prefill-chunk", "8"])
    assert stats["outcomes"]["completed"] == 4 and len(out) == 4
    assert "served 4 requests" in capsys.readouterr().out
    for extra, match in ((["--paged", "--share-prefix"], "prefix sharing"),
                         (["--paged", "--speculate", "3"], "speculative"),
                         (["--paged", "--autotune"], "no attention decode"),
                         (["--autotune"], "no attention decode")):
        with pytest.raises(SystemExit, match=match):
            tserve.main(base + ["--requests", "2"] + extra)
    paged = ["--paged", "--requests", "4", "--prompt-len", "24", "--gen", "6",
             "--lazy", "--num-pages", "10", "--max-batch", "2"]
    out_m, stats_m, ranks = tserve.main(base + paged + [
        "--mesh", "2", "--dist-backend", "gloo"])
    assert "mesh: 2 ranks on the pool axis" in capsys.readouterr().out
    assert len(ranks) == 2 and stats_m["outcomes"]["completed"] == 4
    out_1, _, _ = tserve.main(base + paged)
    assert set(out_m) == set(out_1)
    for rid in out_1:
        np.testing.assert_array_equal(out_m[rid], out_1[rid])


def test_train_launcher_runs_the_ssm_on_cpu(tmp_path, capsys):
    """falcon-mamba SMOKE through the train launcher: f32 params take no
    master copy (as on the card), the blocks are mixer-only."""
    res = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "32",
                       "--ckpt-dir", str(tmp_path)])
    assert res["stop_step"] == 2 and not res["preempted"]
    assert res["opt"].master is None and res["opt"].step == 2
    assert [b.kind for b in res["params"].blocks] == ["ssm", "ssm"]
    assert "done at step 2" in capsys.readouterr().out
