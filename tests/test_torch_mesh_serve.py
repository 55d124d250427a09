"""Serving over a mesh of ranks against the JAX package, on the CPU.

The ranks are gloo processes on the CPU (``launch.mesh.run_ranks``),
spawned once for the mesh ``(model 2)`` and once for ``(data 2, model 2)``;
a rank imports this module and runs the jobs it is handed (in a pickle
file, as ``tests/test_torch_mesh_train.py`` hands them over). Every job
starts from JAX's weights (``init_params`` with the vocab padded to the
``model`` axis, 2), each rank converting only its shard of them
(``convert_params(keep=)``) or, for the paged engine, handed the whole
model and cutting it (``ShardPlan.place``).

References and tolerances, for every family with a decode step (dense
granite-3-2b, the hybrid recurrentgemma-2b, the MoE deepseek-moe-16b and
dbrx-132b, the ssm falcon-mamba-7b, the vlm llava-next-34b from tokens
and from patch embeddings), SMOKE configs in f32:

* JAX's single-device ``make_serve_steps(impl="xla")``: the greedy tokens
  identical; the logits of every step within ``tests/test_torch_serve.py``'s
  1e-4 (two layers of f32 projections and a vocab-wide head that XLA and
  torch sum in other orders);
* the port's single-device steps on the same weights: the greedy tokens
  identical, the first step's logits (prefill's) within 2e-5, the kernels'
  f32 tolerance (the mesh sums its row-parallel products and merges its
  attention partials in another order);
* recurrentgemma-2b's one kv head does not divide ``model``, so its decode
  takes ``kv_cache_seq``: a rank holds ``cap / 2`` slots of the ring, and
  the ranks' slots and rows, put together, are the single-device ring, for
  a prompt shorter than the ring that decode wraps and one longer;
* the paged engine on (data 2, model 2): token for token against JAX's
  single-device engine for every family, every rank holding
  ``1 / model`` of ``wq``;
* the prefill runs under the prefill rules' ``seq`` (each rank's residual
  rows ``S / model``, the rows of a packed paged prefill too) and, for a
  config with ``ctx_parallel_attn`` whose q heads ``model`` does not
  divide (``ctx``: qwen3-14b SMOKE with 3 q heads over 1 kv head), under
  ``seq_full`` (``S / model`` query rows a rank); a prompt that ``model``
  does not divide (``dense_odd``) falls back to replicated rows;
* the five FSDP configs (dbrx-132b, llava-next-34b, qwen3-14b, deepseek-67b,
  deepseek-coder-33b, SMOKE with ``fsdp=True``) on (data 2, model 2) only,
  in the same spawn: each rank holds exactly the prefill rules' shard of
  every weight (every embed dim over data) on both caches, the contiguous
  steps are held as above, and the paged engine token for token against
  JAX's single-device engine;
* a contiguous batch of 3 rows, which data 2 does not divide, on (data 2,
  model 2), dense granite-3-2b and FSDP llava-next-34b: the batch is
  replicated (JAX's ``spec_for`` falls back), every rank holds all 3 rows
  of the cache, and the steps are held as above.
"""

import dataclasses
import functools
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime.steps import make_serve_steps as j_make_serve_steps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.core import online_softmax as osm  # noqa: E402
from repro_torch.core.attention import (spark_decode,  # noqa: E402
                                        spark_decode_partials)
from repro_torch.distributed.mesh import join_train_mesh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.runtime.steps import (make_serve_steps,  # noqa: E402
                                       serving_plan)

LOGIT_TOL = 1e-4        # against JAX (tests/test_torch_serve.py's)
MESH_LOGIT_TOL = 2e-5   # against the port on one device
KERNEL_TOL = 2e-5
VPAD = 2                # the vocab padded to the model axis
B = 4
MESHES = {"model2": {"model": 2}, "2x2": {"data": 2, "model": 2}}

# name: (arch, prompt length, tokens generated, from embeds)
CASES = {
    "dense": ("granite_3_2b", 12, 6, False),
    # 13 rows do not split over model 2: the stream stays replicated
    "dense_odd": ("granite_3_2b", 13, 6, False),
    # seq_full: 3 q heads over 1 kv head do not divide model 2 (CASE_OVER)
    "ctx": ("qwen3_14b", 12, 6, False),
    # the ring of 32 slots: a prompt shorter than it that decode wraps, and
    # one longer (the prefill's roll)
    "hybrid_short": ("recurrentgemma_2b", 20, 20, False),
    "hybrid_long": ("recurrentgemma_2b", 40, 8, False),
    "moe": ("deepseek_moe_16b", 12, 6, False),
    "moe_gqa": ("dbrx_132b", 12, 6, False),
    "ssm": ("falcon_mamba_7b", 12, 6, False),
    "vlm": ("llava_next_34b", 12, 6, False),
    "vlm_embeds": ("llava_next_34b", 12, 6, True),
}
#: the five FSDP configs (``fsdp=True``, as their full configs), served on
#: (data 2, model 2) only: every weight's embed dim over data
FSDP_ARCHS = ("dbrx_132b", "llava_next_34b", "qwen3_14b", "deepseek_67b",
              "deepseek_coder_33b")
FSDP_CASES = {f"fsdp_{arch}": (arch, 12, 6, False) for arch in FSDP_ARCHS}
#: a batch of 3 rows, which data 2 does not divide: replicated on 2x2
REPLICATED_CASES = {"replicated_dense": ("granite_3_2b", 12, 6, False),
                    "replicated_fsdp": ("llava_next_34b", 12, 6, False)}
ALL_CASES = {**CASES, **FSDP_CASES, **REPLICATED_CASES}
#: a case's config overrides
CASE_OVER = {"ctx": (("num_heads", 3), ("num_kv_heads", 1), ("head_dim", 16)),
             **{name: (("fsdp", True),) for name in FSDP_CASES},
             "replicated_fsdp": (("fsdp", True),)}
#: a case's batch, where not ``B``
CASE_BATCH = {name: 3 for name in REPLICATED_CASES}
# paged engine on 2x2: arch → (page size, pages, slots, pages a sequence,
# prefill row, engine kwargs, (prompt, new tokens) of each request)
_LENS = ((12, 6), (7, 8), (12, 1), (7, 5))
PAGED = {
    "granite_3_2b": (8, 8, 2, 3, 24, {}, _LENS),
    "recurrentgemma_2b": (8, 16, 2, 7, 48, {"poison_reclaimed": True},
                          ((40, 6), (36, 8), (45, 1), (38, 5))),
    "deepseek_moe_16b": (8, 8, 2, 3, 24, {}, _LENS),
    "falcon_mamba_7b": (8, 8, 2, 3, 24, {}, _LENS),
    "llava_next_34b": (8, 8, 2, 3, 24, {"prefill_chunk": 6}, _LENS),
}


def _batch(name):
    return CASE_BATCH.get(name, B)


def _cfgs(arch, over=()):
    return (dataclasses.replace(jconfigs.smoke_config(arch), dtype=jnp.float32,
                                remat=False, **dict(over)),
            dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32,
                                **dict(over)))


def _case_cfgs(name):
    return _cfgs(ALL_CASES[name][0], CASE_OVER.get(name, ()))


@functools.lru_cache(maxsize=None)
def _weights(arch, over=()):
    """JAX's params of ``arch`` SMOKE (with ``over``), the vocab padded to
    2: (JAX tree, numpy tree)."""
    jcfg, _ = _cfgs(arch, over)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(3), vocab_pad_to=VPAD)
    return params, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """(prompt [B, S] int32, embeds [B, S, 1024] f32 or None) of a case."""
    arch, s, _, from_embeds = ALL_CASES[name]
    b = _batch(name)
    rs = np.random.default_rng(7)
    prompt = rs.integers(0, tconfigs.smoke_config(arch).vocab_size,
                         (b, s)).astype(np.int32)
    embeds = (rs.standard_normal((b, s, 1024)).astype(np.float32)
              if from_embeds else None)
    return prompt, embeds


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """JAX's single-device greedy run: (tokens [B, gen], logits of each step)."""
    arch, s, gen, _ = ALL_CASES[name]
    jcfg, _ = _case_cfgs(name)
    params, _ = _weights(arch, CASE_OVER.get(name, ()))
    prompt, embeds = _inputs(name)
    arts = j_make_serve_steps(jcfg, impl="xla", max_len=s + gen,
                              batch=_batch(name), xla_chunk=16)
    caches = arts.cache_init_fn()
    logits, caches = arts.prefill_fn(
        params, None if embeds is not None else jnp.asarray(prompt),
        None if embeds is None else jnp.asarray(embeds), caches)
    out = [np.asarray(logits)]
    toks = [np.asarray(jnp.argmax(logits[:, :jcfg.vocab_size], axis=-1))]
    for i in range(gen - 1):
        logits, caches = arts.decode_fn(params, jnp.asarray(toks[-1]), caches,
                                        jnp.int32(s + i))
        out.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits[:, :jcfg.vocab_size], axis=-1)))
    return np.stack(toks, axis=1), out


def _serve(name, mesh=None, params=None):
    """The port's greedy run of a case on one device or this rank of
    ``mesh``: tokens, the logits of every step, and the first attention
    layer's k cache after prefill and at the end (this rank's shard), as
    numpy."""
    arch, s, gen, _ = ALL_CASES[name]
    _, cfg = _case_cfgs(name)
    prompt, embeds = _inputs(name)
    arts = make_serve_steps(cfg, impl="kernel", max_len=s + gen,
                            batch=_batch(name), torch_chunk=16, device="cpu",
                            mesh=mesh)
    caches = arts.cache_init_fn()
    if arts.plan is not None:
        arts.plan.rows_log = []
    attn = next((i for i, c in enumerate(caches) if "k" in c), None)

    def ring():
        return None if attn is None else caches[attn]["k"].numpy().copy()

    logits, caches = arts.prefill_fn(
        params, None if embeds is not None else torch.from_numpy(prompt).long(),
        caches, embeds=None if embeds is None else torch.from_numpy(embeds))
    after_prefill = ring()
    rows = None
    if arts.plan is not None:
        rows = {what: sorted({n for w, n in arts.plan.rows_log if w == what})
                for what in ("residual", "query")}
        arts.plan.rows_log = None
    out = [logits.numpy()]
    toks = [logits[:, :cfg.vocab_size].argmax(-1)]
    for i in range(gen - 1):
        logits, caches = arts.decode_fn(params, toks[-1], caches, s + i)
        out.append(logits.numpy())
        toks.append(logits[:, :cfg.vocab_size].argmax(-1))
    return {"tokens": torch.stack(toks, 1).numpy(), "logits": out,
            "ring": (after_prefill, ring()),
            "shards": None if attn is None else caches[attn].get("shards", 1),
            "kv_seq": None if arts.plan is None else arts.plan.kv_seq,
            "batch_axes": None if arts.plan is None else arts.plan.batch,
            "rows": rows}


@functools.lru_cache(maxsize=None)
def _single(name):
    arch = ALL_CASES[name][0]
    _, cfg = _case_cfgs(name)
    return _serve(name, params=convert_params(
        cfg, _weights(arch, CASE_OVER.get(name, ()))[1], device="cpu"))


# ---------------------------------------------------------------------------
# the ranks' jobs
# ---------------------------------------------------------------------------

def _contiguous_job(mesh, name, tree):
    """A case on this rank's shard of the weights, converted leaf by leaf."""
    _, cfg = _case_cfgs(name)
    plan = serving_plan(cfg, mesh)
    params = convert_params(cfg, tree, device="cpu",
                            keep=lambda n, t: plan.sharding(n).shard(t).clone())
    res = _serve(name, mesh, params)
    res["shapes"] = {n: tuple(p.shape) for n, p in params.named_parameters()}
    return res


def _paged_requests(vocab, lens):
    rs = np.random.RandomState(0)
    return [(rs.randint(0, vocab, size=n).astype(np.int32), g) for n, g in lens]


def _paged_pool(arch, shards):
    """An arch's paged run (PAGED's; granite's for an arch not there)."""
    ps, n_pages, mb, mp, prefill_len, kw, lens = PAGED.get(
        arch, PAGED["granite_3_2b"])
    return (dict(page_size=ps, num_pages=n_pages, max_batch=mb,
                 max_pages_per_seq=mp, num_shards=shards), prefill_len, kw, lens)


def _paged_job(mesh, arch, tree, over=()):
    """The paged engine on this rank, handed the whole model (it keeps its
    shard); ``over``: config overrides."""
    _, cfg = _cfgs(arch, over)
    pool, prefill_len, kw, lens = _paged_pool(arch, mesh.size("model"))
    eng = tserving.ServingEngine(
        cfg, tserving.PagedCacheConfig(**pool),
        convert_params(cfg, tree, device="cpu"), impl="kernel", device="cpu",
        mesh=mesh, prefill_len=prefill_len, torch_chunk=16, **kw)
    eng.plan.rows_log = []
    out, stats = eng.run(_paged_requests(cfg.vocab_size, lens))
    return {"out": out, "stats": stats,
            "rows": sorted({n for w, n in eng.plan.rows_log if w == "residual"}),
            "shapes": {n: tuple(p.shape) for n, p in eng.params.named_parameters()},
            "state": [tuple(c["h"].shape) for c in eng.caches if "h" in c]}


def _rank_jobs(pool, device, shape, path):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // pool.size))
    with open(path, "rb") as f:
        jobs = pickle.load(f)
    mesh = join_train_mesh(shape)
    return {name: globals()[fn](mesh, *args) for name, fn, args in jobs}


def _run(shape, jobs, root):
    path = root / f"serve_jobs_{'x'.join(map(str, shape.values()))}.pkl"
    with open(path, "wb") as f:
        pickle.dump(jobs, f)
    size = int(np.prod(list(shape.values())))
    return tmesh.run_ranks(_rank_jobs, size, (shape, str(path)),
                           backend="gloo", device_type="cpu", timeout_s=900)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh name: every rank's results}, one spawn a mesh."""
    root = tmp_path_factory.mktemp("mesh_serve")
    out = {}
    for mesh_name, shape in MESHES.items():
        jobs = [(name, "_contiguous_job",
                 (name, _weights(CASES[name][0], CASE_OVER.get(name, ()))[1]))
                for name in CASES]
        if mesh_name == "2x2":
            jobs += [(f"paged_{arch}", "_paged_job", (arch, _weights(arch)[1]))
                     for arch in PAGED]
            for name, (arch, *_) in FSDP_CASES.items():
                over = CASE_OVER[name]
                jobs += [(name, "_contiguous_job", (name, _weights(arch, over)[1])),
                         (f"paged_{name}", "_paged_job",
                          (arch, _weights(arch, over)[1], over))]
            jobs += [(name, "_contiguous_job",
                      (name, _weights(arch, CASE_OVER.get(name, ()))[1]))
                     for name, (arch, *_) in REPLICATED_CASES.items()]
        out[mesh_name] = _run(shape, jobs, root)
    return out


# ---------------------------------------------------------------------------
# the contiguous cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_serving_matches_jax_and_one_device(ranks, mesh_name, name):
    jtok, jlogits = _jax_run(name)
    one = _single(name)
    np.testing.assert_array_equal(one["tokens"], jtok)
    for r, res in enumerate(ranks[mesh_name]):
        res = res[name]
        np.testing.assert_array_equal(res["tokens"], jtok,
                                      err_msg=f"rank {r} against JAX")
        err = float(np.abs(res["logits"][0] - one["logits"][0]).max())
        assert err < MESH_LOGIT_TOL, f"rank {r}: first step {err}"
        for step, (got, want) in enumerate(zip(res["logits"], jlogits)):
            err = float(np.abs(got - want).max())
            assert err < LOGIT_TOL, f"rank {r}, step {step}: {err} against JAX"


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_prefill_lays_out_the_sequence(ranks, mesh_name, name):
    """The prefill ran the prefill rules' layout on every rank: residual
    rows ``S / model`` between blocks (``S`` for ``dense_odd``, whose 13
    rows do not split), attention's query rows ``S / model`` under
    ``seq_full`` (``ctx``) and ``S`` on the rank's heads else."""
    arch, s, _, _ = CASES[name]
    m = MESHES[mesh_name]["model"]
    _, cfg = _case_cfgs(name)
    seq = s % m == 0
    ctx = seq and cfg.ctx_parallel_attn and cfg.num_heads % m != 0
    for r, res in enumerate(ranks[mesh_name]):
        rows = res[name]["rows"]
        assert rows["residual"] == [s // m if seq else s], (r, rows)
        assert rows["query"] == ([] if not cfg.num_heads else
                                 [s // m if ctx else s]), (r, rows)
    assert (name == "ctx") == ctx


@pytest.mark.parametrize("arch", list(PAGED))
def test_paged_prefill_splits_its_rows_over_model(ranks, arch):
    """The paged engine's packed prefill rows (``prefill_len``) split over
    model 2 on every rank: no step ran them replicated."""
    prefill_len = PAGED[arch][4]
    for r, res in enumerate(ranks["2x2"]):
        rows = res[f"paged_{arch}"]["rows"]
        assert prefill_len // 2 in rows and prefill_len not in rows, (r, rows)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ["dense", "hybrid_long", "moe", "ssm", "vlm"])
def test_each_rank_holds_its_shard_of_the_weights(ranks, mesh_name, name):
    """No rank holds the whole model: every parameter split by the rules is
    the rank's part (wq on its heads, the vocab, the experts, the
    channels)."""
    arch = CASES[name][0]
    _, cfg = _cfgs(arch)
    full = {n: tuple(p.shape) for n, p in
            convert_params(cfg, _weights(arch)[1], device="cpu").named_parameters()}
    got = ranks[mesh_name][0][name]["shapes"]
    assert got["embed"][0] == full["embed"][0] // 2
    assert got["lm_head"][1] == full["lm_head"][1] // 2
    split = {n for n in full if got[n] != full[n]}
    assert sum(np.prod(got[n]) for n in full) < sum(np.prod(s) for s in
                                                     full.values())
    if cfg.num_heads:
        i = next(n for n in full if n.endswith("mixer.wq"))
        assert got[i] == (full[i][0], full[i][1] // 2)
    if cfg.moe is not None:
        assert got["blocks.0.mlp.wi"][0] == cfg.moe.num_experts // 2
    if cfg.mamba is not None:
        assert "blocks.0.mixer.out_proj" in split


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ["hybrid_short", "hybrid_long"])
def test_hybrid_decode_shards_the_ring_over_model(ranks, mesh_name, name):
    """recurrentgemma-2b's one kv head takes ``kv_cache_seq``: a rank holds
    every kv head on 16 of the ring's 32 slots, and the ranks' slots of
    their batch rows, put together, are the single-device ring after
    prefill and after the decode steps (``hybrid_short`` wraps the ring,
    ``hybrid_long`` prefills past it)."""
    shape = MESHES[mesh_name]
    one = _single(name)
    cap = one["ring"][0].shape[2]
    m, dp = shape["model"], shape.get("data", 1)
    for which in (0, 1):
        union = np.zeros_like(one["ring"][which])
        for rank, res in enumerate(ranks[mesh_name]):
            res = res[name]
            assert res["kv_seq"] and res["shards"] == m
            part = res["ring"][which]
            d, r = divmod(rank, m)
            rows, slots = B // dp, cap // m
            assert part.shape[:3] == (rows, 1, slots)
            union[d * rows:(d + 1) * rows, :, r * slots:(r + 1) * slots] = part
        np.testing.assert_allclose(union, one["ring"][which], atol=KERNEL_TOL,
                                   rtol=0)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("num_splits", [1, 2])
def test_decode_partials_merged_over_two_shards(impl, num_splits):
    """``spark_decode_partials`` on each half of a cache, merged with the
    online-softmax algebra, equals ``spark_decode`` over the whole cache;
    rows whose length ends in the first half leave the second at kv_len 0
    (m NEG_INF, l 0, acc 0), and a row of length 0 comes out zeros."""
    g = torch.Generator().manual_seed(0)
    b, hq, hkv, s, d = 5, 10, 1, 128, 32
    q = torch.randn(b, hq, d, generator=g)
    k, v = (torch.randn(b, hkv, s, d, generator=g) for _ in range(2))
    kv_len = torch.tensor([0, 1, 64, 65, 128], dtype=torch.int32)
    half = s // 2
    states = []
    for r in range(2):
        n = (kv_len - r * half).clamp(0, half).to(torch.int32)
        acc, m, l = spark_decode_partials(q, k[:, :, r * half:(r + 1) * half],
                                          v[:, :, r * half:(r + 1) * half],
                                          impl=impl, kv_len=n,
                                          num_splits=num_splits)
        empty = n == 0
        assert bool((m[empty] == osm.NEG_INF).all())
        assert bool((l[empty] == 0).all()) and bool((acc[empty] == 0).all())
        states.append((acc, m, l))
    merged = osm.merge_many(osm.SoftmaxState(
        m=torch.stack([s_[1] for s_ in states]),
        l=torch.stack([s_[2] for s_ in states]),
        acc=torch.stack([s_[0] for s_ in states])), axis=0)
    o, _ = osm.finalize(merged, out_dtype=q.dtype)
    want = spark_decode(q, k, v, impl=impl, kv_len=kv_len)
    assert float((o - want).abs().max()) < KERNEL_TOL
    assert bool((o[0] == 0).all())


# ---------------------------------------------------------------------------
# the paged engine on (data 2, model 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(PAGED))
def test_paged_engine_on_2x2_matches_one_device(ranks, arch):
    jcfg, tcfg = _cfgs(arch)
    pool, prefill_len, kw, lens = _paged_pool(arch, 2)
    reqs = _paged_requests(tcfg.vocab_size, lens)
    want, _ = jserving.ServingEngine(
        jcfg, jserving.PagedCacheConfig(**pool), _weights(arch)[0],
        impl="xla", prefill_len=prefill_len, xla_chunk=16, **kw).run(
            list(reqs))
    results = [r[f"paged_{arch}"] for r in ranks["2x2"]]
    for r, res in enumerate(results):
        assert set(res["out"]) == set(want) and want
        for rid in want:
            np.testing.assert_array_equal(res["out"][rid], want[rid],
                                          err_msg=f"rank {r}: request {rid}")
        assert res["stats"] == results[0]["stats"]
        if tcfg.num_heads:
            i = next(n for n in res["shapes"] if n.endswith("mixer.wq"))
            assert res["shapes"][i][1] == tcfg.num_heads * tcfg.head_dim // 2
        for rows in res["state"]:       # the rank's channels of every slot
            width = (tcfg.rglru.d_rnn if tcfg.rglru is not None
                     else tcfg.mamba.d_inner)
            assert rows[:2] == (pool["max_batch"] + 1, width // 2)


# ---------------------------------------------------------------------------
# the FSDP configs on (data 2, model 2): weights held as the prefill rules
# lay them out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FSDP_CASES))
def test_fsdp_serving_matches_jax_and_one_device(ranks, name):
    """An FSDP config served with every embed dim over data: the greedy
    tokens of JAX's single-device steps and of the port's on one device,
    every step's logits within ``LOGIT_TOL`` of JAX's, the first within
    ``MESH_LOGIT_TOL`` of one device's."""
    jtok, jlogits = _jax_run(name)
    one = _single(name)
    np.testing.assert_array_equal(one["tokens"], jtok)
    for r, res in enumerate(ranks["2x2"]):
        res = res[name]
        np.testing.assert_array_equal(res["tokens"], jtok,
                                      err_msg=f"rank {r} against JAX")
        np.testing.assert_array_equal(res["tokens"], one["tokens"])
        err = float(np.abs(res["logits"][0] - one["logits"][0]).max())
        assert err < MESH_LOGIT_TOL, f"rank {r}: first step {err}"
        for step, (got, want) in enumerate(zip(res["logits"], jlogits)):
            err = float(np.abs(got - want).max())
            assert err < LOGIT_TOL, f"rank {r}, step {step}: {err} against JAX"


def _prefill_shards(cfg):
    """Every parameter's shape on a rank of (data 2, model 2) under the
    prefill rules (``default_rules(serve=True)``), the vocab padded to 2."""
    from types import SimpleNamespace

    from repro_torch.distributed.sharding import axis_size, default_rules
    from repro_torch.models import lm as tlm
    mesh = SimpleNamespace(shape=MESHES["2x2"])
    full = {n: tuple(p.shape) for n, p in
            tlm.LM(cfg, tlm.padded_vocab(cfg, VPAD), device="meta")
            .named_parameters()}
    specs = default_rules(mesh, cfg, serve=True).tree_specs(
        full, tlm.param_specs(cfg))
    local = {n: tuple(d // (1 if e is None else axis_size(mesh, e))
                      for d, e in zip(full[n], specs[n])) for n in full}
    return full, specs, local


@pytest.mark.parametrize("name", list(FSDP_CASES))
def test_fsdp_rank_holds_the_prefill_rules_shard(ranks, name):
    """On both caches each rank holds exactly the prefill rules' shard of
    every weight: every embed dim halved over data (its 1 / data share),
    the TP dims over model; a quarter of the model's bytes where both
    split."""
    from repro_torch.models import lm as tlm
    _, cfg = _case_cfgs(name)
    full, specs, local = _prefill_shards(cfg)
    logical = tlm.param_specs(cfg)
    for n in full:
        for d, axis in enumerate(logical[n]):
            if axis == "embed":
                assert specs[n][d] == "data", (n, specs[n])
                assert local[n][d] == full[n][d] // 2
    for r, res in enumerate(ranks["2x2"]):
        for job in (name, f"paged_{name}"):
            assert res[job]["shapes"] == local, (r, job)
    held = sum(np.prod(s) for s in local.values())
    assert held < sum(np.prod(s) for s in full.values()) / 2


@pytest.mark.parametrize("name", list(FSDP_CASES))
def test_fsdp_paged_engine_on_2x2_matches_jax(ranks, name):
    """The paged engine of an FSDP config on (data 2, model 2), its weights
    cut to the prefill rules' shards: token for token JAX's single-device
    engine on every rank."""
    arch = FSDP_CASES[name][0]
    jcfg, tcfg = _case_cfgs(name)
    pool, prefill_len, kw, lens = _paged_pool(arch, 2)
    want, _ = jserving.ServingEngine(
        jcfg, jserving.PagedCacheConfig(**pool),
        _weights(arch, CASE_OVER[name])[0], impl="xla",
        prefill_len=prefill_len, xla_chunk=16, **kw).run(
            _paged_requests(tcfg.vocab_size, lens))
    for r, res in enumerate(ranks["2x2"]):
        out = res[f"paged_{name}"]["out"]
        assert set(out) == set(want) and want
        for rid in want:
            np.testing.assert_array_equal(out[rid], want[rid],
                                          err_msg=f"rank {r}: request {rid}")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_launcher_serves_on_a_2x2_mesh(capsys, paged):
    """``launch/serve.py --mesh 2x2`` on the CPU: four gloo ranks, the
    tokens of the run without ``--mesh``."""
    args = ["--arch", "granite_3_2b", "--smoke", "--device", "cpu",
            "--prompt-len", "16", "--gen", "4"]
    args += ["--paged", "--requests", "6"] if paged else ["--batch", "2"]
    single = tserve.main(args)
    got = tserve.main(args + ["--mesh", "2x2", "--dist-backend", "gloo"])
    text = capsys.readouterr().out
    assert "mesh: 4 ranks over data 2 x model 2" in text
    assert "; weights: no dim over data" in text
    if paged:
        assert set(got[0]) == set(single[0]) and len(got[0]) == 6
        for rid in single[0]:
            np.testing.assert_array_equal(got[0][rid], single[0][rid])
    else:
        np.testing.assert_array_equal(got.tokens.numpy(), single.tokens.numpy())


# ---------------------------------------------------------------------------
# a contiguous batch that the batch axes do not divide, on (data 2, model 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(REPLICATED_CASES))
def test_replicated_batch_matches_jax_and_one_device(ranks, name):
    """3 rows over data 2: the plan replicates the batch (no batch axes),
    every rank holds all 3 rows of the cache and gathers no logits over
    data; the greedy tokens of JAX's single-device steps and of the port's
    on one device, every step's logits within ``LOGIT_TOL`` of JAX's, the
    first within ``MESH_LOGIT_TOL`` of one device's."""
    jtok, jlogits = _jax_run(name)
    one = _single(name)
    np.testing.assert_array_equal(one["tokens"], jtok)
    assert jtok.shape[0] == 3
    for r, res in enumerate(ranks["2x2"]):
        res = res[name]
        assert res["batch_axes"] is None, r
        assert res["ring"][1].shape[0] == 3, r
        np.testing.assert_array_equal(res["tokens"], jtok,
                                      err_msg=f"rank {r} against JAX")
        err = float(np.abs(res["logits"][0] - one["logits"][0]).max())
        assert err < MESH_LOGIT_TOL, f"rank {r}: first step {err}"
        for step, (got, want) in enumerate(zip(res["logits"], jlogits)):
            assert got.shape == want.shape
            err = float(np.abs(got - want).max())
            assert err < LOGIT_TOL, f"rank {r}, step {step}: {err} against JAX"
