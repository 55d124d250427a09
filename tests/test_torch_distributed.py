"""The port's distributed paged serving against the JAX package, on the CPU.

Kernel level: ``spark_paged_decode_partials`` (the gated kernel's plain
version, ``impl="kernel"`` on a CPU tensor, and the plain ``torch`` /
``naive`` impls) against JAX ``flash_paged_decode_partials`` in Pallas
interpret mode and its ``impl="xla"`` path, on the same numpy inputs with a
random ownership mask and a 1e6-poisoned trash page: ``m`` equal, the
normalised ``acc / l`` and ``l`` at the JAX suite's f32 tolerance 2e-5 (the
port folds 64-row tiles, JAX page-sized blocks: the same sums in another
order). Then the JAX suite's two hand-made-shard checks, mirrored.

Across ranks: two ranks spawned with ``launch.mesh.run_ranks`` (gloo,
``file://`` rendezvous) run the sharded pool ops (``scatter_pages_sharded``,
``paged_append_decode_sharded``, ``paged_decode_sharded``,
``copy_pages_sharded`` with copies across shards, ``poison_pages_sharded``)
on their shards, held against JAX's single-device ops on the whole pool;
and the port's ``ServingEngine(mesh=, impl="torch")`` on qwen3-14b SMOKE
with ``vocab_pad_to=2`` params from JAX, token for token against JAX's
single-device ``ServingEngine(impl="xla")`` with the same pool
configuration (as JAX's sharded-engine test holds its own), in five modes;
and the hybrid recurrentgemma-2b SMOKE in three (eager, lazy with a
storm-forced preemption, chunked prefill; ``poison_reclaimed`` and prompts
past its 32-token window), against JAX's engine and the port's
single-device one.
The ranks' functions live here; a spawned rank imports this module.
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
from repro.core.attention import spark_paged_decode as j_spark_paged_decode  # noqa: E402
from repro.core.attention import (  # noqa: E402
    spark_paged_decode_partials as j_spark_partials)
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.core import online_softmax as tosm  # noqa: E402
from repro_torch.core.attention import (spark_paged_decode,  # noqa: E402
                                       spark_paged_decode_partials)
from repro_torch.distributed import paged as tpaged  # noqa: E402
from repro_torch.distributed.mesh import PoolMesh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.runtime import tracing  # noqa: E402
from repro_torch.runtime.steps import (make_serve_steps,  # noqa: E402
                                       serving_plan)

TOL = 2e-5          # the JAX suite's f32 attention tolerance
N_RANKS = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _normalised(acc, m, l):
    """(acc / l with the finalize guard, m, l) as numpy f32."""
    acc, m, l = (np.asarray(x, np.float32) for x in (acc, m, l))
    return acc / np.where(l == 0, 1, l)[..., None], m, l


# ---------------------------------------------------------------------------
# kernel level: the gated partials against JAX
# ---------------------------------------------------------------------------

# (hq, hkv, page size, window, num_splits): every pair of page size {4, 16},
# group {4, 5}, window {None, 20} and splits {1, 3} appears
CASES = [
    (8, 2, 4, None, 1), (10, 2, 4, 20, 3), (8, 2, 16, 20, 1),
    (10, 2, 16, None, 3), (8, 2, 4, 20, 3), (10, 2, 16, 20, 1),
    (10, 2, 4, None, 1), (8, 2, 16, None, 3),
]


@functools.lru_cache(maxsize=None)
def _gated_case(hq, hkv, ps, window, ns):
    """Inputs and JAX's two results: a pool whose table entries are owned
    at random (~half), the others remapped to the 1e6-poisoned trash page
    0, as a shard sees them."""
    d, t, b = 32, 320 // ps, 4               # a full row spans five 64-row tiles
    r = np.random.default_rng(hq * 1000 + ps * 10 + ns)
    n_pages = 1 + b * t
    q = r.standard_normal((b, hq, d), np.float32)
    kp = r.standard_normal((hkv, n_pages, ps, d), np.float32)
    vp = r.standard_normal((hkv, n_pages, ps, d), np.float32)
    bt = (r.permutation(n_pages - 1) + 1).reshape(b, t).astype(np.int32)
    valid = (r.random((b, t)) < 0.5).astype(np.int32)
    valid[2] = 0                              # a row this shard owns nothing of
    bt = np.where(valid == 1, bt, 0).astype(np.int32)
    kp[:, 0] = vp[:, 0] = 1e6
    kv_len = np.array([t * ps, 150, 200, 0], np.int32)
    args = (q, kp, vp, bt, kv_len)
    kern = jax.jit(functools.partial(jops.paged_decode_partials,
                                     window=window, num_splits=ns,
                                     interpret=True))
    j_kernel = kern(*args, block_valid=valid)
    j_xla = j_spark_partials(*map(jnp.asarray, args),
                             block_valid=jnp.asarray(valid), impl="xla",
                             window=window, num_splits=ns)
    return args, valid, [tuple(np.asarray(x) for x in j_kernel),
                         tuple(np.asarray(x) for x in j_xla)]


@pytest.mark.parametrize("impl", ["kernel", "torch", "naive"])
@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_partials_match_jax(case, impl):
    hq, hkv, ps, window, ns = case
    (q, kp, vp, bt, kv_len), valid, wants = _gated_case(*case)
    acc, m, l = spark_paged_decode_partials(
        _t(q), _t(kp), _t(vp), _t(bt), _t(kv_len), block_valid=_t(valid),
        impl=impl, window=window, num_splits=ns)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    got = _normalised(acc, m, l)
    for want in wants:
        o_w, m_w, l_w = _normalised(*want)
        assert _err(got[0], o_w) < TOL
        np.testing.assert_array_equal(got[1] == tosm.NEG_INF, m_w == tosm.NEG_INF)
        assert _err(got[1], m_w) < TOL
        assert _err(got[2], l_w) < TOL * max(1.0, float(np.abs(l_w).max()))
    # row 2 owns nothing, row 3 reads nothing: the empty state, exactly
    for row in (2, 3):
        assert float(acc[row].abs().max()) == 0.0 and float(l[row].max()) == 0.0
        assert bool((m[row] == tosm.NEG_INF).all())


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("window", [None, 20], ids=["full", "win20"])
def test_two_shards_merged_equal_the_whole_pool(impl, window):
    """JAX's test_paged_partials_merge_equals_full, mirrored: the pool cut
    into two page-aligned shards by hand, local partials per shard (tables
    remapped by ``_local_ids``) merged with ``online_softmax.merge``, equal
    the single-pool decode, the port's and JAX's."""
    b, hq, hkv, d, ps, t = 3, 8, 2, 64, 16, 4
    num_pages, n_shards = 8, 2
    n_local = num_pages // n_shards
    r = np.random.default_rng(7)
    q = r.standard_normal((b, hq, d), np.float32)
    kp = r.standard_normal((hkv, num_pages, ps, d), np.float32)
    vp = r.standard_normal((hkv, num_pages, ps, d), np.float32)
    usable = np.array([1, 2, 3, 5, 6, 7])     # 0 and 4: the shards' trash pages
    rs = np.random.RandomState(1)
    bt = np.stack([rs.permutation(usable)[:t] for _ in range(b)]).astype(np.int32)
    kv_len = np.array([t * ps, ps + 5, 3], np.int32)

    full = spark_paged_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(kv_len),
                              impl=impl, window=window)
    states = []
    for s in range(n_shards):
        bt_local, valid = tpaged._local_ids(_t(bt), n_local, s)
        acc, m, l = spark_paged_decode_partials(
            _t(q), _t(kp[:, s * n_local:(s + 1) * n_local]),
            _t(vp[:, s * n_local:(s + 1) * n_local]), bt_local, _t(kv_len),
            block_valid=valid, impl=impl, window=window)
        states.append(tosm.SoftmaxState(m=m, l=l, acc=acc))
    o, _ = tosm.finalize(tosm.merge(states[0], states[1]), out_dtype=torch.float32)
    assert _err(o, full) < TOL
    j_full = j_spark_paged_decode(*map(jnp.asarray, (q, kp, vp, bt, kv_len)),
                                  impl="xla", window=window)
    assert _err(o, j_full) < TOL


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_poisoned_trash_is_inert_behind_the_gate(impl):
    """JAX's test_paged_partials_trash_poison_inert, mirrored: poisoning the
    trash page that the unowned entries name moves no bit of the state."""
    b, hq, hkv, d, ps = 2, 4, 2, 32, 16
    r = np.random.default_rng(3)
    q = r.standard_normal((b, hq, d), np.float32)
    kp = r.standard_normal((hkv, 4, ps, d), np.float32)
    vp = r.standard_normal((hkv, 4, ps, d), np.float32)
    bt = np.array([[1, 2], [3, 1]], np.int32)
    kv_len = np.array([2 * ps, ps + 3], np.int32)
    valid = np.array([[1, 0], [0, 1]], np.int32)     # half is foreign
    bt_masked = np.where(valid == 1, bt, 0).astype(np.int32)
    ref = spark_paged_decode_partials(_t(q), _t(kp), _t(vp), _t(bt_masked),
                                      _t(kv_len), block_valid=_t(valid),
                                      impl=impl)
    kp[:, 0] = 1e6
    out = spark_paged_decode_partials(_t(q), _t(kp), _t(vp), _t(bt_masked),
                                      _t(kv_len), block_valid=_t(valid),
                                      impl=impl)
    for a, b_ in zip(ref, out):
        assert _err(a, b_) == 0.0


def test_shard_geometry_errors_match_jax():
    from repro.distributed.paged import pages_per_shard as j_pages_per_shard
    assert tpaged.pages_per_shard(8, 2) == j_pages_per_shard(8, 2) == 4
    for n_pages, n in ((7, 2), (2, 2)):
        with pytest.raises(ValueError) as te:
            tpaged.pages_per_shard(n_pages, n)
        with pytest.raises(ValueError) as je:
            j_pages_per_shard(n_pages, n)
        assert str(te.value) == str(je.value)
    # the pool a rank holds: num_pages / mesh.size pages (all without a mesh)
    tcfg = dataclasses.replace(tconfigs.smoke_config("qwen3_14b"),
                               dtype=torch.float32)
    pcfg = tserving.PagedCacheConfig(page_size=4, max_batch=2,
                                     max_pages_per_seq=4, num_pages=8,
                                     num_shards=2)
    for mesh, pages in ((None, 8), (PoolMesh(None, 0, 2), 4)):
        plan = None if mesh is None else serving_plan(tcfg, mesh, paged=True)
        pool = tlm.init_paged_cache(tcfg, pcfg, device="cpu", plan=plan)
        assert len(pool) == tcfg.num_layers
        assert pool[0]["k_pages"].shape == (tcfg.num_kv_heads, pages, 4,
                                            tcfg.head_dim)


# ---------------------------------------------------------------------------
# two ranks: the sharded pool ops and the engine
# ---------------------------------------------------------------------------

P_LOCAL, PS, HKV, HQ, D = 6, 4, 2, 8, 16   # ops: a 12-page pool, two shards


def _ops_inputs():
    r = np.random.default_rng(11)
    n_pages = N_RANKS * P_LOCAL
    kp = r.standard_normal((HKV, n_pages, PS, D), np.float32)
    vp = r.standard_normal((HKV, n_pages, PS, D), np.float32)
    usable = [p for p in range(n_pages) if p % P_LOCAL]
    rs = np.random.RandomState(2)
    b, t = 3, 3
    bt = np.stack([rs.permutation(usable)[:t] for _ in range(b)]).astype(np.int32)
    kv_len = np.array([t * PS - 1, PS + 1, 0], np.int32)    # pre-append lengths
    # packed prefill: 7 tokens into row 0's first two pages, 2 of padding
    # (slot 0, the trash page)
    dest = np.concatenate([(bt[0, :2, None] * PS + np.arange(PS)).reshape(-1)[:7],
                           [0, 0]]).astype(np.int32)
    # chunk rows: 5 token rows reading row 0's table up to positions 6..10
    tok_tables = np.repeat(bt[:1], 5, axis=0)
    tok_kv_len = np.arange(7, 12, dtype=np.int32)
    return {
        "kp": kp, "vp": vp, "bt": bt, "kv_len": kv_len,
        "q": r.standard_normal((b, HQ, D), np.float32),
        "k_new": r.standard_normal((b, HKV, D), np.float32),
        "v_new": r.standard_normal((b, HKV, D), np.float32),
        "dest": dest, "vals": r.standard_normal((HKV, dest.size, D), np.float32),
        "q_tok": r.standard_normal((5, HQ, D), np.float32),
        "tok_tables": tok_tables, "tok_kv_len": tok_kv_len,
        # copy-on-write pairs: shard 0 → 1, shard 1 → 0, within shard 1
        "src": np.array([1, 8, 9], np.int64), "dst": np.array([7, 2, 11], np.int64),
        "poison": np.array([0, 3, 10], np.int64),
    }


def _ops_on_rank(mesh, x):
    lo, hi = mesh.rank * P_LOCAL, (mesh.rank + 1) * P_LOCAL

    def shard():
        return _t(x["kp"][:, lo:hi]), _t(x["vp"][:, lo:hi])

    res = {}
    kp, vp = shard()
    tpaged.scatter_pages_sharded(kp, _t(x["dest"]), _t(x["vals"]), mesh=mesh)
    res["scatter"] = kp.numpy()
    for impl in ("torch", "kernel"):
        kp, vp = shard()
        o = tpaged.paged_append_decode_sharded(
            _t(x["q"]), _t(x["k_new"]), _t(x["v_new"]), kp, vp, _t(x["bt"]),
            _t(x["kv_len"]), mesh=mesh, impl=impl)
        res[f"append_{impl}"] = (o.numpy(), kp.numpy(), vp.numpy())
    kp, vp = shard()
    res["chunk"] = tpaged.paged_decode_sharded(
        _t(x["q_tok"]), kp, vp, _t(x["tok_tables"]), _t(x["tok_kv_len"]),
        mesh=mesh, impl="kernel", window=5, num_splits=2).numpy()
    kp, vp = shard()
    tpaged.copy_pages_sharded([kp, vp], _t(x["src"]), _t(x["dst"]), mesh)
    res["cow"] = (kp.numpy(), vp.numpy())
    kp, vp = shard()
    tpaged.poison_pages_sharded([kp, vp], _t(x["poison"]), mesh)
    res["poison"] = (kp.numpy(), vp.numpy())
    return res


def _crash_restore_on_rank(mesh, device, tcfg, tparams, pcfg, prefill_len,
                           kw, reqs):
    """An injected crash at iteration 3 on every rank, each rank's snapshot
    (its own shard of the pool) restored into a fresh engine twice: the
    uninterrupted run's outputs, the resumed ones, and whether it crashed."""
    def engine(**extra):
        return tserving.ServingEngine(tcfg, pcfg, tparams, impl="torch",
                                      device=device, mesh=mesh,
                                      prefill_len=prefill_len, torch_chunk=16,
                                      **kw, **extra)

    base, _ = engine().run(list(reqs))
    eng = engine(fault_plan=tserving.FaultPlan(seed=0, events=(), crash_step=3))
    crashed = False
    try:
        eng.run(list(reqs))
    except tserving.InjectedCrash:
        crashed = True
    snap = eng.snapshot()
    resumed = []
    for _ in range(2):
        again = engine()
        again.restore(snap)
        resumed.append(again.run()[0])
    return base, resumed, crashed


def _rank_job(mesh, device, job):
    """One rank: the pool ops, then the engine in every mode. Each result
    carries what the parent compares with JAX and across ranks."""
    res = {"ops": _ops_on_rank(mesh, job["ops"]), "engine": {}}
    tcfg = job["cfg"]
    tparams = convert_params(tcfg, job["params"], device=device)
    res["restore"] = _crash_restore_on_rank(mesh, device, tcfg, tparams,
                                            *job["engine"]["eager"])
    hcfg, htree, hybrid = job["hybrid"]
    hparams = convert_params(hcfg, htree, device=device)
    pcfg, prefill_len, _, _ = hybrid["hybrid_eager"]
    res["autotune"] = tserving.ServingEngine(
        hcfg, pcfg, hparams, impl="torch", device=device, mesh=mesh,
        prefill_len=prefill_len, autotune=True).num_splits
    runs = [(tcfg, tparams, mode, j) for mode, j in job["engine"].items()]
    runs += [(hcfg, hparams, mode, j) for mode, j in hybrid.items()]
    for cfg, params, mode, (pcfg, prefill_len, kw, reqs) in runs:
        eng = tserving.ServingEngine(cfg, pcfg, params, impl="torch",
                                     device=device, mesh=mesh,
                                     prefill_len=prefill_len, torch_chunk=16,
                                     **kw)
        pairs = []
        drain = eng.scheduler.tables.drain_copies

        def spy(drain=drain, pairs=pairs):
            out = drain()
            pairs.extend(out)
            return out

        eng.scheduler.tables.drain_copies = spy
        out, stats = eng.run(list(reqs))
        alloc = eng.scheduler.tables.allocator
        res["engine"][mode] = {
            "out": out, "stats": stats, "cow_pairs": pairs,
            "outcomes": {rid: r.outcome.value for rid, r in eng.results.items()},
            "allocated": alloc.num_allocated,
            "free_or_cached": alloc.num_free + alloc.num_cached,
            "pool_shape": next(tuple(c["k_pages"].shape) for c in eng.caches
                               if "k_pages" in c),
            "state_rows": [tuple(c["h"].shape) for c in eng.caches if "h" in c],
            "state_free": eng.scheduler.tables.state.num_free}
    return res


def _reqs(vocab, lens, seed=0, motif=False, shared=False):
    """(prompt, max_new) pairs: random prompts, or a tiled 4-token ``motif``
    for the drafter, or with ``shared`` JAX's shared-prefix trace
    (tests/test_prefix_cache.py): a prompt and a same-prefix sibling, then
    two duplicates of the first, admitted together, which alias its blocks
    at refcount 2, so the first one's write copies on write."""
    rs = np.random.RandomState(seed)
    if shared:
        prefix = rs.randint(0, vocab, size=9).astype(np.int32)
        a, b = (rs.randint(0, vocab, size=3).astype(np.int32) for _ in range(2))
        cold = np.concatenate([prefix, a])
        return [(cold, 4), (np.concatenate([prefix, b]), 4), (cold.copy(), 4),
                (cold.copy(), 4)]
    out = []
    for n, g in lens:
        tail = (np.tile(rs.randint(0, vocab, size=4), -(-n // 4))[:n] if motif
                else rs.randint(0, vocab, size=n))
        out.append((tail.astype(np.int32), g))
    return out


_LENS = ((12, 6), (7, 8), (12, 1), (7, 5))
MODES = {
    # name: ((page_size, num_pages, max_batch, max_pages_per_seq),
    #        prefill_len, engine kwargs, request kwargs); JAX's sharded test
    # serves the first two
    "eager": ((8, 8, 2, 3), 24, {}, {}),
    "lazy_preempt": ((8, 6, 2, 3), 24, {"lazy": True}, {}),
    # the copy-on-write goes from page 3 (shard 0) to page 7 (shard 1)
    "prefix_chunk": ((4, 12, 2, 5), 16,
                     {"share_prefix": True, "prefill_chunk": 6},
                     {"seed": 2, "shared": True}),
    "speculate_3": ((8, 12, 2, 3), 24, {"speculate_k": 3}, {"motif": True}),
    "fault_plan": ((8, 12, 2, 3), 24, {"fault_plan": 17}, {}),
}
# recurrentgemma-2b SMOKE (window 32): prompts past the window, so pages of
# the sharded pool are reclaimed (and poisoned) while every rank keeps every
# recurrent state row; the lazy mode's preemptions forced by a storm plan
_HYBRID_LENS = ((40, 6), (36, 8), (45, 1), (38, 5))
HYBRID_MODES = {
    "hybrid_eager": ((8, 16, 2, 7), 48, {"poison_reclaimed": True}, {}),
    "hybrid_lazy": ((8, 16, 2, 7), 56,
                    {"lazy": True, "poison_reclaimed": True,
                     "fault_plan": dict(seed=3, horizon=16, events_per_kind=3,
                                        kinds=("storm",))}, {}),
    "hybrid_chunk": ((8, 16, 2, 7), 48,
                     {"prefill_chunk": 12, "poison_reclaimed": True}, {}),
}


@functools.lru_cache(maxsize=None)
def _qwen():
    """qwen3-14b SMOKE, f32, params from JAX with vocab_pad_to=2 (as JAX's
    sharded-engine test builds them): (JAX cfg, port cfg, JAX params, numpy
    tree)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen3_14b"),
                               dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(tconfigs.smoke_config("qwen3_14b"),
                               dtype=torch.float32)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(0), vocab_pad_to=2)
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _hybrid():
    """recurrentgemma-2b SMOKE, f32, params from JAX: as :func:`_qwen`."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("recurrentgemma_2b"),
                               dtype=jnp.float32, remat=False)
    tcfg = dataclasses.replace(tconfigs.smoke_config("recurrentgemma_2b"),
                               dtype=torch.float32)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def _mode(mode, fault_plan_cls):
    (ps, n_pages, mb, mp), prefill_len, kw, rkw = {**MODES, **HYBRID_MODES}[mode]
    kw = dict(kw)
    if "fault_plan" in kw:
        plan = kw["fault_plan"]
        kw["fault_plan"] = (fault_plan_cls(**plan) if isinstance(plan, dict)
                            else fault_plan_cls(seed=plan, horizon=24))
    return (ps, n_pages, mb, mp), prefill_len, kw, rkw


def _engine_jobs(modes, vocab, lens, fault_plan_cls):
    """{mode: (pool config of two shards, prefill_len, engine kwargs,
    requests)} of the port for ``modes``."""
    jobs = {}
    for mode in modes:
        (ps, n_pages, mb, mp), prefill_len, kw, rkw = _mode(mode, fault_plan_cls)
        pcfg = tserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                         max_batch=mb, max_pages_per_seq=mp,
                                         num_shards=N_RANKS)
        jobs[mode] = (pcfg, prefill_len, kw, _reqs(vocab, lens, **rkw))
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, spawned once for the module (an autotuned
    engine's plan persists under a temporary directory)."""
    _, tcfg, _, tree = _qwen()
    _, hcfg, _, htree = _hybrid()
    job = {"ops": _ops_inputs(), "cfg": tcfg, "params": tree,
           "engine": _engine_jobs(MODES, tcfg.vocab_size, _LENS,
                                  tserving.FaultPlan),
           "hybrid": (hcfg, htree, _engine_jobs(
               HYBRID_MODES, hcfg.vocab_size, _HYBRID_LENS,
               tserving.FaultPlan))}
    cache = str(tmp_path_factory.mktemp("autotune") / "at.json")
    with pytest.MonkeyPatch.context() as mp:   # the spawned ranks inherit it
        mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE", cache)
        return tmesh.run_ranks(_rank_job, N_RANKS, (job,), backend="gloo",
                               device_type="cpu", timeout_s=600)


def _gathered(results, key, part=None):
    """A result's local pools of both ranks, concatenated on the page axis."""
    return np.concatenate([r["ops"][key] if part is None else r["ops"][key][part]
                           for r in results], axis=1)


_TRASH = [s * P_LOCAL for s in range(N_RANKS)]


def _owned(a):
    """The pool without the shards' trash pages (foreign writes land there)."""
    return np.delete(a, _TRASH, axis=1)


def test_scatter_pages_sharded_matches_jax(ranks):
    x = _ops_inputs()
    want = np.asarray(jlayers._scatter_pages(jnp.asarray(x["kp"]),
                                             jnp.asarray(x["dest"]),
                                             jnp.asarray(x["vals"])))
    got = _gathered(ranks, "scatter")
    np.testing.assert_array_equal(_owned(got), _owned(want))


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_paged_append_decode_sharded_matches_jax(ranks, impl):
    x = _ops_inputs()
    kvl, bt = x["kv_len"], x["bt"]
    page = bt[np.arange(3), kvl // PS]
    dest = jnp.asarray(page * PS + kvl % PS)
    kp = jlayers._scatter_pages(jnp.asarray(x["kp"]), dest,
                                jnp.asarray(x["k_new"]).transpose(1, 0, 2))
    vp = jlayers._scatter_pages(jnp.asarray(x["vp"]), dest,
                                jnp.asarray(x["v_new"]).transpose(1, 0, 2))
    o_want = j_spark_paged_decode(jnp.asarray(x["q"]), kp, vp, jnp.asarray(bt),
                                  jnp.asarray(kvl + 1), impl="xla")
    outs = [r["ops"][f"append_{impl}"] for r in ranks]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])  # o on every rank
    assert _err(outs[0][0], o_want) < TOL
    for part, want in ((1, kp), (2, vp)):
        got = np.concatenate([o[part] for o in outs], axis=1)
        np.testing.assert_array_equal(_owned(got), _owned(np.asarray(want)))


def test_paged_decode_sharded_token_rows_match_jax(ranks):
    """Chunked prefill's sharded attention: B·S token rows, a window and
    two splits within each shard."""
    x = _ops_inputs()
    want = j_spark_paged_decode(
        *map(jnp.asarray, (x["q_tok"], x["kp"], x["vp"], x["tok_tables"],
                           x["tok_kv_len"])), impl="xla", window=5, num_splits=2)
    got = [r["ops"]["chunk"] for r in ranks]
    np.testing.assert_array_equal(got[0], got[1])
    assert _err(got[0], want) < TOL


def test_copy_pages_sharded_across_shards(ranks):
    x = _ops_inputs()
    for part, pool in ((0, x["kp"]), (1, x["vp"])):
        want = np.asarray(jnp.asarray(pool).at[:, x["dst"]].set(
            jnp.asarray(pool)[:, x["src"]]))
        np.testing.assert_array_equal(_gathered(ranks, "cow", part), want)


def test_poison_pages_sharded(ranks):
    x = _ops_inputs()
    for part, pool in ((0, x["kp"]), (1, x["vp"])):
        want = np.asarray(jnp.asarray(pool).at[:, x["poison"]].set(1e6))
        np.testing.assert_array_equal(_gathered(ranks, "poison", part), want)


@pytest.mark.parametrize("mode", list(MODES) + list(HYBRID_MODES))
def test_sharded_engine_matches_jax_single_device(ranks, mode):
    """Token for token against JAX's single-device engine on the same pool
    configuration (num_shards=2 reserves the same trash pages), equal on
    both ranks, every page returned at the end. The hybrid's modes also
    against the port's single-device engine, with every state row on each
    rank and every one free at the end."""
    hybrid = mode in HYBRID_MODES
    jcfg, tcfg, params, tree = _hybrid() if hybrid else _qwen()
    lens = _HYBRID_LENS if hybrid else _LENS
    (ps, n_pages, mb, mp), prefill_len, kw, rkw = _mode(mode, jserving.FaultPlan)
    pcfg = jserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                     max_batch=mb, max_pages_per_seq=mp,
                                     num_shards=N_RANKS)
    jeng = jserving.ServingEngine(jcfg, pcfg, params, impl="xla",
                                  prefill_len=prefill_len, xla_chunk=16, **kw)
    reqs = _reqs(jcfg.vocab_size, lens, **rkw)
    jout, jstats = jeng.run(list(reqs))
    r0, r1 = (r["engine"][mode] for r in ranks)
    assert r0["pool_shape"] == (jcfg.num_kv_heads, n_pages // N_RANKS, ps,
                                jcfg.head_dim)
    if hybrid:
        _, _, tkw, _ = _mode(mode, tserving.FaultPlan)
        single, _ = tserving.ServingEngine(
            tcfg, tserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                            max_batch=mb, max_pages_per_seq=mp,
                                            num_shards=N_RANKS),
            convert_params(tcfg, tree, device="cpu"), impl="torch",
            device="cpu", prefill_len=prefill_len, torch_chunk=16,
            **tkw).run(list(reqs))
        assert jstats["pages_reclaimed"] > 0
        for r in (r0, r1):
            assert r["state_rows"] and all(rows[0] == mb + 1
                                           for rows in r["state_rows"])
            assert r["state_free"] == mb
            assert r["stats"]["pages_reclaimed"] == jstats["pages_reclaimed"]
            assert r["stats"]["state_releases"] == jstats["state_releases"]
            assert set(r["out"]) == set(single)
            for rid in single:
                np.testing.assert_array_equal(r["out"][rid], single[rid],
                                              err_msg=f"{mode}: request {rid}")
    for r in (r0, r1):
        assert set(r["out"]) == set(jout) and jout
        for rid in jout:
            np.testing.assert_array_equal(r["out"][rid], jout[rid],
                                          err_msg=f"{mode}: request {rid}")
        assert r["outcomes"] == {rid: res.outcome.value
                                 for rid, res in jeng.results.items()}
        for key in ("decode_steps", "preemptions", "pages_grown",
                    "prefill_tokens", "prefill_tokens_skipped", "pages_shared",
                    "cow_copies", "drafted_tokens", "accepted_tokens"):
            assert r["stats"][key] == jstats[key], key
        assert r["allocated"] == 0
        assert r["free_or_cached"] == pcfg.usable_pages
    assert r0["stats"] == r1["stats"] and r0["cow_pairs"] == r1["cow_pairs"]
    if mode in ("lazy_preempt", "hybrid_lazy"):
        assert r0["stats"]["preemptions"] >= 1 and r0["stats"]["pages_grown"] >= 1
    if mode == "hybrid_chunk":
        assert r0["stats"]["prefill_tokens"] == jstats["prefill_tokens"] > 0
    if mode == "prefix_chunk":
        n_local = n_pages // N_RANKS
        assert r0["stats"]["prefill_tokens_skipped"] > 0
        assert r0["stats"]["cow_copies"] > 0
        assert any(s // n_local != d // n_local for s, d in r0["cow_pairs"]), \
            f"no copy-on-write crossed shards: {r0['cow_pairs']}"
    if mode == "speculate_3":
        assert r0["stats"]["accepted_tokens"] > 0


def test_sharded_engine_autotune_plans_one_shard(ranks):
    """Under a mesh, rank 0 plans for one shard's launch over the whole
    reach (with the window) and every rank takes its split count."""
    from repro_torch.perf.autotune import DecodeShape, plan_decode

    _, hcfg, _, _ = _hybrid()
    (ps, _, mb, mp), _, _, _ = HYBRID_MODES["hybrid_eager"]
    shape = DecodeShape(batch=mb, hkv=hcfg.num_kv_heads,
                        group=hcfg.num_heads // hcfg.num_kv_heads,
                        kv_len=mp * ps, head_dim=hcfg.head_dim, page_size=ps,
                        dtype_bytes=4, window=hcfg.attn_window, shards=N_RANKS)
    assert [r["autotune"] for r in ranks] == [plan_decode(shape).num_splits] * 2


def test_sharded_crash_snapshot_restore_resumes_token_identical(ranks):
    """Each rank's snapshot holds its own shard of the pool; restored into
    fresh sharded engines, the ranks resume token for token."""
    for r in ranks:
        base, resumed, crashed = r["restore"]
        assert crashed and base
        for out in resumed:
            assert set(out) == set(base)
            for rid in base:
                np.testing.assert_array_equal(out[rid], base[rid])


def _one_rank_engine(mesh, device, cfg, tree, mode):
    """The engine of ``mode`` on a one-rank mesh: its tokens, merges and
    copy-on-write pairs."""
    (ps, n_pages, mb, mp), prefill_len, kw, rkw = _mode(mode, tserving.FaultPlan)
    pcfg = tserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                     max_batch=mb, max_pages_per_seq=mp)
    eng = tserving.ServingEngine(cfg, pcfg, convert_params(cfg, tree,
                                                           device=device),
                                 impl="torch", device=device, mesh=mesh,
                                 prefill_len=prefill_len, torch_chunk=16, **kw)
    t0 = tracing.clock()
    out, stats = eng.run(_reqs(cfg.vocab_size, _LENS, **rkw))
    return out, len(tracing.spans("dist.merge", t0=t0)), stats["cow_copies"]


def test_one_rank_mesh_runs_the_sharded_path():
    """A mesh of one rank over a process group of its own (``launch.mesh``
    makes it so) serves through the sharded pool ops, the merges and the
    copy-on-write collective included, and generates what the engine
    without a mesh does."""
    _, tcfg, _, tree = _qwen()
    (out, merges, cow), = tmesh.run_ranks(
        _one_rank_engine, 1, (tcfg, tree, "prefix_chunk"), backend="gloo",
        device_type="cpu", timeout_s=600)
    (ps, n_pages, mb, mp), prefill_len, kw, rkw = _mode("prefix_chunk",
                                                        tserving.FaultPlan)
    want, _ = tserving.ServingEngine(
        tcfg, tserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                        max_batch=mb, max_pages_per_seq=mp),
        convert_params(tcfg, tree, device="cpu"), impl="torch", device="cpu",
        prefill_len=prefill_len, torch_chunk=16, **kw).run(
            _reqs(tcfg.vocab_size, _LENS, **rkw))
    assert merges > 0 and cow > 0
    assert set(out) == set(want) and want
    for rid in want:
        np.testing.assert_array_equal(out[rid], want[rid])


def test_mesh_cli_runs_on_cpu(capsys):
    out, stats, ranks = tserve.main([
        "--arch", "granite_3_2b", "--smoke", "--device", "cpu", "--paged",
        "--mesh", "2", "--dist-backend", "gloo", "--requests", "5",
        "--prompt-len", "16", "--gen", "6", "--lazy", "--num-pages", "10",
        "--max-batch", "2"])
    text = capsys.readouterr().out
    assert "mesh: 2 ranks on the pool axis, backend gloo" in text
    assert "served 5 requests" in text and "outcomes: completed=5" in text
    assert len(ranks) == 2 and len(out) == 5
    single, _, _ = tserve.main([
        "--arch", "granite_3_2b", "--smoke", "--device", "cpu", "--paged",
        "--requests", "5", "--prompt-len", "16", "--gen", "6", "--lazy",
        "--num-pages", "10", "--max-batch", "2"])
    for rid in single:
        np.testing.assert_array_equal(out[rid], single[rid])


def test_mesh_refuses_what_is_not_ported():
    """Serving over a mesh refuses only what JAX refuses: JAX's mesh forms
    parse, the contiguous cache takes a mesh (with or without --paged), and
    the encoder still has no decode step; the backend checks stay."""
    assert tserve.parse_mesh("2x2") == {"data": 2, "model": 2}
    assert tserve.parse_mesh("1x2x2") == {"pod": 1, "data": 2, "model": 2}
    with pytest.raises(SystemExit, match="encoder-only: no decode step"):
        tserve.main(["--arch", "hubert_xlarge", "--smoke", "--device", "cpu",
                     "--mesh", "2"])
    with pytest.raises(SystemExit, match="N, DxM or PxDxM"):
        tserve.main(["--arch", "granite_3_2b", "--smoke", "--device", "cpu",
                     "--mesh", "2x2x2x2"])
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        tmesh.check_backend("nccl", "cpu", 2)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="--dist-backend gloo"):
            tmesh.check_backend("nccl", "cuda", 2)
    tcfg = dataclasses.replace(tconfigs.smoke_config("qwen3_14b"),
                               dtype=torch.float32)
    # a PoolMesh is the mesh ("model",): the contiguous steps build its plan
    # (kv heads 2 over model 2: each rank caches one)
    arts = make_serve_steps(tcfg, device="cpu", batch=2, max_len=8,
                            mesh=PoolMesh(None, 0, 2))
    assert arts.plan.kv and not arts.plan.kv_seq
    assert arts.cache_init_fn()[0]["k"].shape == (2, 1, 8, tcfg.head_dim)
