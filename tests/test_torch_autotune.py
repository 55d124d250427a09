"""The port's split-KV planner (``repro_torch/perf/autotune.py``) and H100
roofline (``repro_torch/perf/roofline.py``) against the JAX package's, on
the CPU.

Counterparts of ``tests/test_autotune.py``'s eight contracts (the port's
default record is the H100's), then: under the ``TPU_V5E`` record the port
plans exactly as JAX does over a grid of geometries; under ``H100`` every
plan's ``block_kv`` is the kernel's 64-row tile and its split count one
``kernels/decode.split_layout`` keeps; the port's cache never reads JAX's
file or environment variable and misses on another device's entries or
another (refit) record's; one shard's launch is the whole table's at its
share of the bytes; and the parameter counts and MODEL_FLOPS equal JAX's for every arch.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.perf import autotune as jautotune  # noqa: E402
from repro.perf import roofline as jroofline  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.kernels.decode import split_layout  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.perf import roofline  # noqa: E402
from repro_torch.perf.autotune import (H100, TPU_V5E, AutotuneCache,  # noqa: E402
                                       DecodeShape, LaunchPlan,
                                       candidate_plans, plan_decode,
                                       predict_time)

LONG_SMALL_BATCH = DecodeShape(batch=1, hkv=2, group=4, kv_len=500_000,
                               head_dim=128)


@pytest.fixture(autouse=True)
def _cache_in_tmp(tmp_path, monkeypatch):
    """Every persistent plan of this module lands in tmp_path."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "at.json"))


def _assert_valid(shape, plan, hw=H100):
    nk = -(-shape.kv_len // plan.block_kv)
    assert plan.num_splits >= 1
    assert plan.num_splits <= nk          # every split owns >= 1 KV block
    assert plan.block_kv >= 1
    if shape.page_size > 0 and not hw.split_unit:
        assert plan.block_kv == shape.page_size
    if hw.split_unit:
        assert plan.block_kv == hw.split_unit
    assert plan.time_s > 0 and np.isfinite(plan.time_s)


# ---------------------------------------------------------------------------
# counterparts of tests/test_autotune.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [H100, TPU_V5E], ids=lambda h: h.name)
def test_pure_cost_model_plans_are_valid(hw):
    shapes = [
        LONG_SMALL_BATCH,
        DecodeShape(batch=32, hkv=8, group=4, kv_len=2048, head_dim=128),
        DecodeShape(batch=2, hkv=2, group=4, kv_len=32768, head_dim=128,
                    page_size=16),
        DecodeShape(batch=1, hkv=1, group=8, kv_len=64, head_dim=64),
        DecodeShape(batch=1, hkv=1, group=1, kv_len=3, head_dim=64),
    ]
    for shape in shapes:
        plan = plan_decode(shape, hw=hw)    # no sweep, no cache, no device
        _assert_valid(shape, plan, hw)
        assert plan.source == "model"


#: a batch that fills the device in whole waves: 64·8 TPU grid cells; on the
#: card 99·4 = 396 one-block units, the D 128 bf16 kernel's resident count
#: (64·8 = 512 would leave a second wave of 116 whose tail splits shorten)
BUSY = {"tpu_v5e": (64, 8), "h100_sxm": (99, 4)}


@pytest.mark.parametrize("hw", [H100, TPU_V5E], ids=lambda h: h.name)
def test_cost_model_splits_where_occupancy_is_low(hw):
    """long_500k at B·Hkv=2 must split; a saturated batch must not."""
    assert plan_decode(LONG_SMALL_BATCH, hw=hw).num_splits > 1
    b, h = BUSY[hw.name]
    busy = DecodeShape(batch=b, hkv=h, group=4, kv_len=2048, head_dim=128)
    assert plan_decode(busy, hw=hw).num_splits == 1
    tiny = DecodeShape(batch=1, hkv=1, group=8, kv_len=64, head_dim=64)
    assert plan_decode(tiny, hw=hw).num_splits == 1   # merge overhead dominates


@pytest.mark.parametrize("hw", [H100, TPU_V5E], ids=lambda h: h.name)
def test_predict_time_monotonic_in_traffic(hw):
    s1 = dataclasses.replace(LONG_SMALL_BATCH, kv_len=10_000)
    s2 = dataclasses.replace(LONG_SMALL_BATCH, kv_len=100_000)
    assert predict_time(s2, 1, 512, hw) > predict_time(s1, 1, 512, hw)


def test_candidates_respect_page_size():
    paged = DecodeShape(batch=2, hkv=2, group=2, kv_len=4096, head_dim=64,
                        page_size=32)
    assert {bk for _, bk in candidate_plans(paged, TPU_V5E)} == {32}
    contig = DecodeShape(batch=2, hkv=2, group=2, kv_len=4096, head_dim=64)
    assert all(bk <= 4096 for _, bk in candidate_plans(contig, TPU_V5E))
    # the card's kernel splits 64-row tiles on either cache
    for shape in (paged, contig):
        assert {bk for _, bk in candidate_plans(shape)} == {64}


def test_cache_round_trips_and_is_shape_keyed(tmp_path):
    path = tmp_path / "autotune.json"
    cache = AutotuneCache(path, device="NVIDIA H100 80GB HBM3")
    s1 = LONG_SMALL_BATCH
    s2 = dataclasses.replace(s1, batch=2)              # differs in one field
    p1 = plan_decode(s1, cache=cache)
    p2 = plan_decode(s2, cache=cache)
    cache.save()
    raw = json.loads(path.read_text())                 # valid JSON on disk
    assert {r["device"] for r in raw.values()} == {"NVIDIA H100 80GB HBM3"}
    reloaded = AutotuneCache(path, device="NVIDIA H100 80GB HBM3")
    h1, h2 = reloaded.get(s1), reloaded.get(s2)
    assert h1 is not None and h2 is not None
    assert (h1.num_splits, h1.block_kv) == (p1.num_splits, p1.block_kv)
    assert (h2.num_splits, h2.block_kv) == (p2.num_splits, p2.block_kv)
    assert h1.source == "cache"
    # a hit short-circuits the model: plan_decode returns the cached record
    assert plan_decode(s1, cache=reloaded).source == "cache"
    # distinct geometries never collide
    assert s1.key() != s2.key()
    # a window is part of the geometry; without one the key is JAX's
    assert dataclasses.replace(s1, window=2048).key() != s1.key()


def test_cache_env_override_and_corrupt_file(tmp_path, monkeypatch):
    env_path = tmp_path / "via_env.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(env_path))
    assert AutotuneCache.default_path() == env_path
    env_path.write_text("{not json")
    cache = AutotuneCache()                            # corrupt → empty, no raise
    assert cache.get(LONG_SMALL_BATCH) is None
    plan_decode(LONG_SMALL_BATCH, cache=cache)
    cache.save()
    assert json.loads(env_path.read_text())


def test_sweep_hook_overrides_model():
    """The measured time ranks the model's shortlist, not the model."""
    times = {}

    def sweep(ns, bk):
        # invert the model's preference: make bigger splits "measure" slower
        times[(ns, bk)] = float(ns)
        return times[(ns, bk)]
    plan = plan_decode(LONG_SMALL_BATCH, sweep=sweep)
    assert times, "sweep was never invoked"
    assert plan.source == "sweep"
    best = min(times, key=times.get)
    assert (plan.num_splits, plan.block_kv) == best    # measurement won
    assert plan.num_splits == min(ns for ns, _ in times)


def _engine_shape(tcfg, pcfg):
    return DecodeShape(batch=pcfg.max_batch, hkv=tcfg.num_kv_heads,
                       group=tcfg.num_heads // tcfg.num_kv_heads,
                       kv_len=pcfg.max_pages_per_seq * pcfg.page_size,
                       head_dim=tcfg.head_dim, page_size=pcfg.page_size,
                       dtype_bytes=4)


@pytest.mark.parametrize("arch", ["qwen3_14b", "recurrentgemma_2b"])
def test_engine_autotune_wires_plan(arch, tmp_path):
    """ServingEngine(autotune=True) bakes the planned split count in and
    serves the tokens of a num_splits=1 engine; the plan lands in the
    persistent cache under the device's name; an explicit num_splits
    wins."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype=jnp.float32,
                               remat=False)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert_params(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    # 12 pages of 8 a row: 96 positions, two 64-row tiles
    pcfg = tserving.PagedCacheConfig(page_size=8, num_pages=40, max_batch=2,
                                     max_pages_per_seq=12)
    kw = dict(impl="torch", device="cpu", prefill_len=80, torch_chunk=16)
    eng = tserving.ServingEngine(tcfg, pcfg, tparams, autotune=True, **kw)
    shape = dataclasses.replace(_engine_shape(tcfg, pcfg),
                                window=tcfg.attn_window or 0)
    assert eng.num_splits == plan_decode(shape).num_splits
    hit = AutotuneCache(device="cpu").get(shape)
    assert hit is not None and hit.source == "cache"     # persisted
    assert AutotuneCache(device="NVIDIA H100 80GB HBM3").get(shape) is None
    rs = np.random.RandomState(0)
    reqs = [(rs.randint(0, tcfg.vocab_size, size=n).astype(np.int32), g)
            for n, g in ((70, 5), (9, 8), (66, 4))]
    base, _ = tserving.ServingEngine(tcfg, pcfg, tparams, num_splits=1,
                                     **kw).run(list(reqs))
    # a cached plan of two splits (a sweep's, say) is taken as planned
    cache = AutotuneCache(device="cpu")
    cache.put(shape, LaunchPlan(num_splits=2, block_kv=64, time_s=1e-5))
    cache.save()
    eng_2 = tserving.ServingEngine(tcfg, pcfg, tparams, autotune=True, **kw)
    assert eng_2.num_splits == 2
    for e in (eng, eng_2):
        out, _ = e.run(list(reqs))
        assert set(out) == set(base) and len(out) == 3
        for rid in base:
            np.testing.assert_array_equal(out[rid], base[rid])
    # an explicit num_splits beats autotune
    eng2 = tserving.ServingEngine(tcfg, pcfg, tparams, autotune=True,
                                  num_splits=2, **kw)
    assert eng2.num_splits == 2


# ---------------------------------------------------------------------------
# the port against JAX, and the card's record
# ---------------------------------------------------------------------------

def _grid():
    for paged, g, d, kv in itertools.product(
            (0, 16), (1, 4, 6, 10), (64, 128, 256),
            (64, 100, 512, 2048, 3136, 8192, 32768)):
        for b, h in ((1, 1), (4, 1), (8, 8), (32, 2)):
            yield dict(batch=b, hkv=h, group=g, kv_len=kv, head_dim=d,
                       page_size=paged, dtype_bytes=4)


def test_tpu_record_plans_as_jax():
    n = 0
    for kw in _grid():
        js, ts = jautotune.DecodeShape(**kw), DecodeShape(**kw)
        assert ts.key() == js.key()
        jp, tp = jautotune.plan_decode(js), plan_decode(ts, hw=TPU_V5E)
        assert (tp.num_splits, tp.block_kv) == (jp.num_splits, jp.block_kv), kw
        assert abs(tp.time_s - jp.time_s) <= 1e-12 * jp.time_s, kw
        for ns, bk in jautotune.candidate_plans(js):
            assert predict_time(ts, ns, bk, TPU_V5E) == pytest.approx(
                jautotune.predict_time(js, ns, bk), rel=1e-12)
        n += 1
    assert n == 2 * 4 * 3 * 7 * 4


def test_h100_plans_split_the_kernel_tile():
    for kw in _grid():
        for window in (0, 2048):
            shape = DecodeShape(**kw, window=window)
            plan = plan_decode(shape)
            assert plan.block_kv == 64 and plan.source == "model"
            nk, ns, _ = split_layout(shape.kv_len, plan.num_splits)
            assert ns == plan.num_splits and plan.num_splits <= nk
            assert all(bk == 64 and split_layout(shape.kv_len, s)[1] == s
                       for s, bk in candidate_plans(shape))


def test_port_never_reads_the_jax_cache(tmp_path, monkeypatch):
    jax_file = tmp_path / "jax.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(jax_file))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    jcache = jautotune.AutotuneCache()
    shape = DecodeShape(batch=8, hkv=8, group=4, kv_len=592, head_dim=64,
                        page_size=16, dtype_bytes=4)
    jcache.put(jautotune.DecodeShape(**{f.name: getattr(shape, f.name)
                                        for f in dataclasses.fields(
                                            jautotune.DecodeShape)}),
               jautotune.LaunchPlan(num_splits=32, block_kv=16, time_s=1.0))
    jcache.save()
    path = AutotuneCache.default_path()
    assert path != jax_file and path != jautotune.AutotuneCache.default_path()
    assert path == tmp_path / "home" / ".cache" / "repro_torch" / "autotune.json"
    # JAX's file, pointed at directly, holds no entry the port takes
    assert AutotuneCache(jax_file, device="cpu").get(shape) is None
    assert AutotuneCache(jax_file, device="cpu").get(shape, TPU_V5E) is None
    plan = plan_decode(shape, cache=AutotuneCache(device="cpu"))
    assert plan.source == "model" and plan.num_splits != 32
    assert not path.exists() or "jax" not in path.read_text()


def test_cache_entry_of_another_device_or_record_is_a_miss(tmp_path):
    path = tmp_path / "at.json"
    shape = DecodeShape(batch=4, hkv=1, group=10, kv_len=2048, head_dim=256,
                        dtype_bytes=4)
    a = AutotuneCache(path, device="NVIDIA H100 80GB HBM3")
    a.put(shape, LaunchPlan(num_splits=4, block_kv=64, time_s=1e-5))
    a.save()
    assert AutotuneCache(path, device="NVIDIA H100 80GB HBM3").get(shape) \
        is not None
    assert AutotuneCache(path, device="NVIDIA A100-SXM4-80GB").get(shape) is None
    assert AutotuneCache(path, device="NVIDIA H100 80GB HBM3").get(
        shape, TPU_V5E) is None


def test_cache_entry_of_a_refit_record_is_a_miss(tmp_path):
    path = tmp_path / "at.json"
    shape = DecodeShape(batch=4, hkv=1, group=10, kv_len=2048, head_dim=256,
                        dtype_bytes=4)
    a = AutotuneCache(path, device="NVIDIA H100 80GB HBM3")
    a.put(shape, LaunchPlan(num_splits=16, block_kv=64, time_s=1e-5))
    a.save()
    refit = dataclasses.replace(H100, c1=2 * H100.c1)
    assert refit.name == H100.name
    assert refit.fingerprint() != H100.fingerprint()
    b = AutotuneCache(path, device="NVIDIA H100 80GB HBM3")
    assert b.get(shape, H100) is not None and b.get(shape, refit) is None
    assert plan_decode(shape, cache=b, hw=refit).source == "model"


def test_h100_plans_one_split_where_it_has_not_read_the_card():
    """A head dim or dtype whose resident clusters the record lacks keeps
    the engine's one split rather than a guessed occupancy."""
    for shape in (DecodeShape(batch=1, hkv=1, group=8, kv_len=32768,
                              head_dim=96, dtype_bytes=4),
                  DecodeShape(batch=1, hkv=1, group=8, kv_len=32768,
                              head_dim=128, dtype_bytes=1)):
        assert not H100.reads(shape.head_dim, shape.dtype_bytes)
        assert candidate_plans(shape) == [(1, 64)]
        assert plan_decode(shape).num_splits == 1
        assert plan_decode(shape, hw=TPU_V5E).num_splits > 1
    for d, b, _ in H100.resident:
        assert H100.reads(d, b)


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16, 32])
def test_shard_launch_is_the_whole_table_at_its_share_of_bytes(splits):
    """One shard of two launches the whole table's splits and clusters
    (``launch_geometry`` on the card), reading half the bytes; the key
    names the shards."""
    from repro_torch.perf.autotune import cost_terms, split_cluster
    whole = DecodeShape(batch=8, hkv=1, group=10, kv_len=3136, head_dim=256,
                        page_size=16, dtype_bytes=4, window=2048)
    shard = dataclasses.replace(whole, shards=2)
    assert shard.key() == whole.key() + ".n2"
    assert split_cluster(shard, splits) == split_cluster(whole, splits)
    (wv, wt, wb, wm), (sv, st, sb, sm) = (cost_terms(s, splits, 64)
                                          for s in (whole, shard))
    assert (sv, st, sm) == (wv, wt, wm) and 2 * sb == wb
    # the cluster rule of csrc/flash_decode.cu geometry: doubled while the
    # split has twice the tiles and the launch fewer blocks than SMs
    nj = -(-49 // min(splits, 49))
    c = 1
    while c < 8 and 2 * c <= nj and 8 * min(splits, 49) * c < 132:
        c *= 2
    assert split_cluster(shard, splits) == c
    assert split_cluster(shard, splits, TPU_V5E) == 1     # grid cells, no clusters


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_counts_and_model_flops_match_jax(arch):
    j, t = jconfigs.get_config(arch), tconfigs.arch_config(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    for name, shape in jconfigs.SHAPES.items():
        for kind in ("train", "prefill", "decode"):
            assert roofline.model_flops_for(t, shape, step_kind=kind) == \
                jroofline.model_flops_for(j, shape, step_kind=kind)


def test_roofline_terms_on_the_card():
    cfg = tconfigs.arch_config("granite_3_2b")
    shape = jconfigs.SHAPES["decode_32k"]
    r = roofline.build(cfg, shape, step_kind="decode", chips=1,
                       hlo_flops_per_dev=989e12, hlo_bytes_per_dev=3.35e12,
                       coll_bytes_per_dev=450e9 * 2)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 2.0)
    assert r.bound == "collective" and r.step_time_s == 2.0
    assert r.model_flops == 2.0 * cfg.param_count() * shape.global_batch
    assert r.mfu == r.model_flops / (roofline.PEAK_FLOPS["bfloat16"] * 2.0)
    assert roofline.hbm_per_chip() == (
        torch.cuda.get_device_properties(0).total_memory
        if torch.cuda.is_available() else 80e9)


def test_serve_cli_autotune_on_both_caches(capsys):
    base = ["--arch", "granite_3_2b", "--smoke", "--device", "cpu",
            "--autotune"]
    res = tserve.main(base + ["--batch", "2", "--prompt-len", "16",
                              "--gen", "4"])
    assert res.tokens.shape == (2, 4)
    text = capsys.readouterr().out
    assert "autotune: num_splits=" in text and "block_kv=64" in text
    out, stats, eng = tserve.main(base + ["--paged", "--requests", "3",
                                          "--prompt-len", "16", "--gen", "4"])
    assert stats["outcomes"]["completed"] == 3
    assert "(autotuned)" in capsys.readouterr().out
    assert eng.num_splits >= 1
