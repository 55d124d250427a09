"""The port's paged serving engine against the JAX package's, on the CPU.

``repro_torch.serving.ServingEngine(impl="torch", device="cpu")`` against
``repro.serving.ServingEngine(impl="xla")`` on the same params (carried
across by ``models/convert.py``), page-pool configuration and requests:
token-identical generations and equal outcome counts in every mode the JAX
suite serves an attention-only arch with, ``autotune=`` included (each
engine plans for its own device). Also: the paged engine against
the port's contiguous ``greedy_generate``, the copied numpy host layer
against its JAX original, a crash / snapshot / restore, and the ``--paged``
CLI.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.distributed.mesh import PoolMesh  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.runtime.steps import make_serve_steps  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HOST_MODULES = ("state_cache", "paged_cache", "scheduler", "outcomes",
                "faults", "drafter")


@functools.lru_cache(maxsize=None)
def _model(window=None):
    """(JAX cfg, port cfg, JAX params, port params): granite-3-2b SMOKE, f32."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("granite_3_2b"),
                               dtype=jnp.float32, remat=False,
                               attn_window=window)
    tcfg = dataclasses.replace(tconfigs.smoke_config("granite_3_2b"),
                               dtype=torch.float32, attn_window=window)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert_params(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    return jcfg, tcfg, params, tparams


def _reqs(vocab, lens, seed=0, system=0, motif=False, dup=False):
    """(prompt, max_new) pairs: random prompts, or with ``system`` a common
    prefix of that many tokens, or with ``motif`` a tiled 4-token motif the
    prompt-lookup drafter can match; ``dup`` repeats the first request (a
    full prefix match, whose write block is copied on write)."""
    rs = np.random.RandomState(seed)
    head = rs.randint(0, vocab, size=system)
    out = []
    for n, g in lens:
        tail = (np.tile(rs.randint(0, vocab, size=4), -(-n // 4))[:n] if motif
                else rs.randint(0, vocab, size=n))
        out.append((np.concatenate([head, tail]).astype(np.int32), g))
    return out + out[:1] if dup else out


_LENS = ((12, 6), (7, 8), (9, 4), (10, 5))
_MODES = {
    # name: (window, pool (page_size, num_pages, max_batch, max_pages_per_seq),
    #        prefill_len, engine kwargs, request kwargs)
    "eager": (None, (8, 11, 2, 3), 24, {}, {}),
    "lazy_preempt": (None, (4, 6, 2, 8), 32, {"lazy": True}, {}),
    "prefix_chunk": (None, (4, 25, 2, 8), 16,
                     {"share_prefix": True, "prefill_chunk": 6},
                     {"system": 8, "dup": True}),
    "speculate_3": (None, (8, 11, 2, 3), 24, {"speculate_k": 3},
                    {"motif": True}),
    "num_splits_2": (None, (4, 13, 2, 6), 24, {"num_splits": 2}, {}),
    "window_reclaim_poison": (6, (4, 8, 2, 8), 32,
                              {"lazy": True, "poison_reclaimed": True}, {}),
    "fault_plan": (None, (8, 11, 2, 3), 24, {"fault_plan": 17}, {}),
    # each engine plans its split count for its own device's kernel
    "autotune": (None, (4, 13, 2, 6), 24, {"autotune": True}, {}),
}


def _engines(mode):
    window, (ps, n_pages, mb, mp), prefill_len, kw, rkw = _MODES[mode]
    jcfg, tcfg, params, tparams = _model(window)
    jkw, tkw = dict(kw), dict(kw)
    if "fault_plan" in kw:
        jkw["fault_plan"] = jserving.FaultPlan(seed=kw["fault_plan"], horizon=24)
        tkw["fault_plan"] = tserving.FaultPlan(seed=kw["fault_plan"], horizon=24)
    jeng = jserving.ServingEngine(
        jcfg, jserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                        max_batch=mb, max_pages_per_seq=mp),
        params, impl="xla", prefill_len=prefill_len, xla_chunk=16, **jkw)
    teng = tserving.ServingEngine(
        tcfg, tserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                        max_batch=mb, max_pages_per_seq=mp),
        tparams, impl="torch", device="cpu", prefill_len=prefill_len,
        torch_chunk=16, **tkw)
    return jeng, teng, _reqs(jcfg.vocab_size, _LENS, **rkw)


@pytest.mark.parametrize("mode", list(_MODES))
def test_engine_matches_jax(mode, tmp_path, monkeypatch):
    # autotuned plans persist under tmp_path, each package's in its own file
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "port.json"))
    jeng, teng, reqs = _engines(mode)
    jout, jstats = jeng.run(list(reqs))
    tout, tstats = teng.run(list(reqs))
    assert tstats["outcomes"] == jstats["outcomes"]
    assert {rid: r.outcome.value for rid, r in teng.results.items()} == \
        {rid: r.outcome.value for rid, r in jeng.results.items()}
    assert set(tout) == set(jout) and jout
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid],
                                      err_msg=f"{mode}: request {rid}")
    for key in ("decode_steps", "preemptions", "pages_grown",
                "pages_reclaimed", "prefill_tokens", "prefill_tokens_skipped",
                "pages_shared", "cow_copies", "drafted_tokens",
                "accepted_tokens"):
        assert tstats[key] == jstats[key], key
    if mode == "lazy_preempt":
        assert tstats["preemptions"] > 0
    if mode == "window_reclaim_poison":
        assert tstats["pages_reclaimed"] > 0
    if mode == "prefix_chunk":
        assert tstats["prefill_tokens_skipped"] > 0
    if mode == "speculate_3":
        assert tstats["accepted_tokens"] > 0
    if mode == "autotune":
        assert (tmp_path / "port.json").exists()
        assert teng.num_splits >= 1 and jeng.num_splits >= 1
    alloc = teng.scheduler.tables.allocator
    assert alloc.num_allocated == 0
    assert alloc.num_free + alloc.num_cached == teng.pcfg.usable_pages


def test_engine_matches_contiguous_serving():
    """Packed prefill + paged decode through the engine reproduce
    one-request-at-a-time contiguous serving token for token (the port's
    ``greedy_generate`` on the contiguous cache)."""
    _, tcfg, _, tparams = _model()
    reqs = _reqs(tcfg.vocab_size, [(12, 6), (7, 8), (12, 1), (7, 5)])
    expected = {}
    for rid, (prompt, max_new) in enumerate(reqs):
        arts = make_serve_steps(tcfg, impl="kernel", max_len=24, batch=1,
                                torch_chunk=16, device="cpu")
        gen = tserve.greedy_generate(arts, tparams,
                                     torch.from_numpy(prompt)[None].long(),
                                     max_new, tcfg.vocab_size)
        expected[rid] = gen.tokens[0].numpy()
    pcfg = tserving.PagedCacheConfig(page_size=8, num_pages=8, max_batch=2,
                                     max_pages_per_seq=3)
    eng = tserving.ServingEngine(tcfg, pcfg, tparams, impl="kernel",
                                 device="cpu", prefill_len=24, torch_chunk=16)
    out, stats = eng.run(reqs)
    assert stats["mean_utilization"] > 0.5
    for rid, exp in expected.items():
        np.testing.assert_array_equal(out[rid], exp, err_msg=f"request {rid}")
    assert eng.scheduler.tables.allocator.num_free == pcfg.num_pages - 1


def test_crash_snapshot_restore_resumes_token_identical():
    _, tcfg, _, tparams = _model()
    reqs = _reqs(tcfg.vocab_size, _LENS)
    pcfg = tserving.PagedCacheConfig(page_size=8, num_pages=11, max_batch=2,
                                     max_pages_per_seq=3)

    def engine(**kw):
        return tserving.ServingEngine(tcfg, pcfg, tparams, impl="kernel",
                                      device="cpu", prefill_len=24,
                                      torch_chunk=16, **kw)

    base, _ = engine().run(list(reqs))
    eng = engine(fault_plan=tserving.FaultPlan(seed=0, events=(), crash_step=3))
    with pytest.raises(tserving.InjectedCrash):
        eng.run(list(reqs))
    snap = eng.snapshot()
    for _ in range(2):                     # a snapshot restores more than once
        eng2 = engine()
        eng2.restore(snap)
        out, _ = eng2.run()
        assert set(out) == set(base)
        for rid in base:
            np.testing.assert_array_equal(out[rid], base[rid])


def test_engine_refuses_unported_modes():
    _, tcfg, _, tparams = _model()
    pcfg = tserving.PagedCacheConfig(page_size=8, num_pages=11, max_batch=2,
                                     max_pages_per_seq=3)
    # a mesh is ported: the pool must have one shard a rank, as in JAX
    with pytest.raises(ValueError, match="num_shards=1 must equal the mesh's "
                                         "model-axis size 2"):
        tserving.ServingEngine(tcfg, pcfg, tparams, device="cpu",
                               mesh=PoolMesh(group=None, rank=0, size=2))


@pytest.mark.parametrize("module", HOST_MODULES)
def test_host_layer_is_the_jax_copy(module):
    """The numpy host layer is the JAX package's, apart from the import
    prefix, and stays numpy-only."""
    jax_src = (ROOT / "src" / "repro" / "serving" / f"{module}.py").read_text()
    port_src = (ROOT / "src" / "repro_torch" / "serving" / f"{module}.py").read_text()
    assert port_src == jax_src.replace("from repro.", "from repro_torch.")
    assert "torch" not in port_src.replace("repro_torch", "")


def test_public_names_match_jax():
    assert tserving.__all__ == jserving.__all__


def test_paged_cli_runs_on_cpu(capsys):
    out, stats, eng = tserve.main([
        "--arch", "granite_3_2b", "--smoke", "--device", "cpu", "--paged",
        "--requests", "5", "--prompt-len", "16", "--gen", "6", "--lazy",
        "--num-pages", "10", "--max-batch", "2"])
    text = capsys.readouterr().out
    assert "served 5 requests" in text and "lazy page utilization" in text
    assert "outcomes: completed=5" in text
    assert len(out) == 5 and stats["preemptions"] >= 0
    assert eng.device == torch.device("cpu")
