"""The port's frontend families against the JAX package, on the CPU: the vlm
llava-next-34b (a dense decoder, GQA, fed tokens or patch embeddings) and
the encoder hubert-xlarge (non-causal attention, the ungated GELU MLP,
per-position loss, fed frame embeddings; no decode step).

Both SMOKE configs, f32, JAX's params carried across by
``models/convert.py``, plus a head-dim-80 config (hubert's head dim: d 160,
2/2 heads, 2 layers, non-causal) whose attention runs the port's plain
kernels against JAX's Pallas kernels in interpret mode. Tolerances
(ROADMAP.md): f32 forward 2e-5 and gradients 5e-5, each relative to
max(1, the reference's max); serving token-identical. The ranks' function
lives here; a spawned rank imports this module.
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
from repro.kernels.flash_bwd import flash_bwd as j_flash_bwd  # noqa: E402
from repro.kernels.flash_fwd import flash_fwd as j_flash_fwd  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.runtime.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.runtime.trainer import Trainer as JTrainer  # noqa: E402
from repro.runtime.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.kernels import flash_bwd as tbwd  # noqa: E402
from repro_torch.kernels import flash_fwd as tfwd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.steps import (make_serve_steps, make_train_step,  # noqa: E402
                                       place_batch)
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

FWD_TOL = 2e-5       # f32 forward (tests/test_kernel_fwd.py)
GRAD_TOL = 5e-5      # f32 gradients (tests/test_kernel_bwd.py)
VLM, ENC = "llava_next_34b", "hubert_xlarge"
# hubert's head dim at a CPU size: d 160 over 2 heads
D80 = dict(d_model=160, num_heads=2, num_kv_heads=2, head_dim=0, num_layers=2)
MODELS = {"llava": (VLM, {}), "hubert": (ENC, {}), "d80": (ENC, D80)}
N_RANKS = 2


def _rel(a, b):
    """max |a - b| over max(1, max |b|)."""
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b, np.float32)
    return float(np.abs(np.asarray(a, np.float32) - b).max()) / max(
        1.0, float(np.abs(b).max()))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _model(name):
    """(JAX cfg, port cfg, JAX params, numpy tree, port params), f32."""
    arch, over = MODELS[name]
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype=jnp.float32,
                               remat=False, **over)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32,
                               **over)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(5))
    tree = _np(params)
    return jcfg, tcfg, params, tree, convert.convert_params(tcfg, tree,
                                                            device="cpu")


def _jctx(name, **kw):
    """JAX's context: the d80 model's attention through the Pallas kernels
    in interpret mode, the SMOKE ones through XLA."""
    if name == "d80":
        return jlayers.Ctx(impl="pallas_interpret", block_q=64, block_kv=64, **kw)
    return jlayers.Ctx(impl="xla", **kw)


def _embeds(b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, tlm.FRONTEND_DIM)).astype(np.float32)


# ---------------------------------------------------------------------------
# configs, the MLP, convert
# ---------------------------------------------------------------------------

def test_configs_match_jax():
    fields = ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "head_dim", "causal",
              "frontend", "mlp_type", "attn_window")
    for arch in (VLM, ENC):
        for get in ("get_config", "smoke_config"):
            j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
            assert {f: getattr(t, f) for f in fields} == \
                {f: getattr(j, f) for f in fields}
    assert tconfigs.get_config(ENC).head_dim == 80
    assert tlm.FRONTEND_DIM == jlm.FRONTEND_DIM == 1024


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_jax(gated):
    """The dense FFN against JAX's ``apply_mlp``: gated SiLU, or ungated
    GELU in its tanh form (``jax.nn.gelu``'s default), which the erf GELU
    misses by more than the tolerance at these activations."""
    d, f = 48, 96
    p, _ = jlayers.init_mlp(jax.random.PRNGKey(1), d, f, jnp.float32,
                            gated=gated)
    x = 3.0 * np.random.default_rng(2).standard_normal((2, 7, d)).astype(
        np.float32)
    ref = np.asarray(jlayers.apply_mlp(p, jnp.asarray(x), jlayers.Ctx(),
                                       gated=gated))
    mlp = tlayers.MLP(d, f, torch.float32, "cpu", gated=gated)
    assert mlp.wi.shape == ((d, 2 * f) if gated else (d, f))
    with torch.no_grad():
        mlp.wi.copy_(_t(p["wi"]))
        mlp.wo.copy_(_t(p["wo"]))
        out = tlayers.apply_mlp(mlp, _t(x))
        assert _rel(out, ref) <= FWD_TOL
        if not gated:
            erf = torch.nn.functional.gelu(_t(x) @ mlp.wi) @ mlp.wo
            assert _rel(erf, ref) > 2 * FWD_TOL


@pytest.mark.parametrize("name", list(MODELS))
def test_convert_lands_every_leaf(name):
    """Every JAX leaf, ``frontend_proj`` among them, lands in one port
    parameter of its shape and value; hubert's ``wi`` is ungated."""
    jcfg, tcfg, _, tree, model = _model(name)
    named = dict(model.named_parameters())
    assert sum(p.numel() for p in named.values()) == sum(
        np.asarray(a).size for a in jax.tree.leaves(tree))
    assert named["frontend_proj"].shape == (1024, tcfg.d_model)
    np.testing.assert_array_equal(named["frontend_proj"].detach().numpy(),
                                  tree["frontend_proj"])
    for n, arr in convert._named_arrays(tcfg, tree, model).items():
        np.testing.assert_array_equal(named[n].detach().numpy(),
                                      np.asarray(arr), err_msg=n)
    width = tcfg.d_ff * (2 if tcfg.mlp_type == "gated_silu" else 1)
    assert named["blocks.0.mlp.wi"].shape == (tcfg.d_model, width)
    bad = dict(tree, extra=tree["final_norm"])
    with pytest.raises(ValueError, match="top-level leaves"):
        convert.convert_params(tcfg, bad, device="cpu")


# ---------------------------------------------------------------------------
# the kernels at head dim 80, non-causal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "dropout_segments", "kv_longer"])
def test_d80_plain_kernels_match_jax_interpret(case):
    """The port's plain forward and backward at D 80, non-causal, against
    JAX's Pallas kernels in interpret mode."""
    b, h, sq, skv, d = 1, 2, 96, 96, 80
    kw = {}
    if case == "kv_longer":
        sq, skv = 40, 130
    r = np.random.default_rng(3)
    q = r.standard_normal((b, h, sq, d)).astype(np.float32)
    k = r.standard_normal((b, h, skv, d)).astype(np.float32)
    v = r.standard_normal((b, h, skv, d)).astype(np.float32)
    do = r.standard_normal((b, h, sq, d)).astype(np.float32)
    seg = None
    if case == "dropout_segments":
        seg = (np.arange(skv) // 40).astype(np.int32)[None].repeat(b, 0)
        seg[:, -10:] = -1
        kw = dict(dropout_rate=0.1, dropout_seed=-4)
    jo, jlse = j_flash_fwd(*map(jnp.asarray, (q, k, v)), causal=False,
                           segment_ids=None if seg is None else jnp.asarray(seg),
                           block_q=64, block_kv=64, interpret=True, **kw)
    jg = j_flash_bwd(*map(jnp.asarray, (q, k, v)), jo, jlse, jnp.asarray(do),
                     causal=False,
                     segment_ids=None if seg is None else jnp.asarray(seg),
                     block_q=64, block_kv=64, interpret=True, **kw)
    tseg = None if seg is None else _t(seg)
    o, lse = tfwd.flash_fwd(_t(q), _t(k), _t(v), causal=False,
                            segment_ids=tseg, **kw)
    assert _rel(o, jo) <= FWD_TOL and _rel(lse, jlse) <= FWD_TOL
    grads = tbwd.flash_bwd(_t(q), _t(k), _t(v), o, lse, _t(do), causal=False,
                           segment_ids=tseg, **kw)
    for g, j in zip(grads, jg):
        assert _rel(g, j) <= GRAD_TOL


# ---------------------------------------------------------------------------
# the model: forward from embeds, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_forward_from_embeds_matches_jax(name):
    """``lm.forward(embeds=)`` (embeds @ frontend_proj, then the blocks)
    against JAX's; tokens and embeds together are refused."""
    jcfg, tcfg, params, _, model = _model(name)
    emb = _embeds(2, 64, 7)
    jlog, _, _ = jax.jit(lambda p, e: jlm.forward(
        jcfg, p, _jctx(name), embeds=e))(params, jnp.asarray(emb))
    with torch.no_grad():
        log, _, metrics = tlm.forward(tcfg, model, Ctx(impl="kernel"),
                                      embeds=_t(emb))
        assert metrics == {}
        assert _rel(log, jlog) <= FWD_TOL
        with pytest.raises(ValueError, match="tokens or embeds"):
            tlm.forward(tcfg, model, Ctx(), embeds=_t(emb),
                        tokens=torch.zeros((2, 64), dtype=torch.long))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(name, dropout):
    jcfg, tcfg, params, _, _ = _model(name)
    jcfg = dataclasses.replace(jcfg, dropout_rate=dropout)
    batch = make_batch(DataConfig(vocab_size=tcfg.vocab_size, seq_len=64,
                                  global_batch=2, seed=11,
                                  frontend=tcfg.frontend), 0)

    def jloss(p, bt):
        ctx = _jctx(name, deterministic=dropout == 0.0, seed=jnp.int32(-9))
        return jlm.loss_fn(jcfg, p, bt, ctx)
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, float(jl), _np(jg)


@pytest.mark.parametrize("name,dropout", [("llava", 0.0), ("hubert", 0.0),
                                          ("hubert", 0.1), ("d80", 0.0),
                                          ("d80", 0.1)])
def test_loss_and_grads_match_jax(name, dropout):
    """``loss_fn`` on an embeds batch (next-token CE for llava, per-position
    for hubert) and every gradient leaf against JAX's; the embedding, which
    an embeds batch does not reach, has a zero gradient in both."""
    _, tcfg, _, tree, _ = _model(name)
    tcfg = dataclasses.replace(tcfg, dropout_rate=dropout)
    batch, jl, jg = _jax_loss_and_grads(name, dropout)
    assert set(batch) == {"embeds", "labels"}
    model = convert.convert_params(tcfg, tree, device="cpu")
    ctx = Ctx(impl="kernel", deterministic=dropout == 0.0, seed=-9)
    loss, _ = tlm.loss_fn(tcfg, model, place_batch(batch, "cpu"), ctx)
    loss.backward()
    assert abs(float(loss.detach()) - jl) <= FWD_TOL * abs(jl)
    assert not np.asarray(jg["embed"]).any() and model.embed.grad is None
    jnamed = convert._named_arrays(tcfg, jg, model)
    for n, p in model.named_parameters():
        if n != "embed":
            assert _rel(p.grad, jnamed[n]) <= GRAD_TOL, n


# ---------------------------------------------------------------------------
# llava serving: contiguous, paged engine, two ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["tokens", "embeds"])
def test_llava_prefill_and_decode_match_jax(source):
    """Prefill from a token prompt or from patch embeddings, then 6 greedy
    decode steps by tokens (JAX's ``prefill`` and ``decode_step``): every
    step's logits within the forward tolerance and the tokens identical;
    ``greedy_generate(embeds=)`` gives the same tokens."""
    jcfg, tcfg, params, _, model = _model("llava")
    b, s, n = 2, 20, 6
    r = np.random.default_rng(4)
    prompt = r.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    emb = _embeds(b, s, 8)
    jctx = jlayers.Ctx(impl="xla")
    kw = {"tokens": prompt} if source == "tokens" else {"embeds": emb}
    jlog, jc = jax.jit(lambda p, c, **a: jlm.prefill(jcfg, p, jctx, caches=c,
                                                      **a))(
        params, jlm.init_cache(jcfg, b, s + n),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    jdec = jax.jit(lambda p, t, c, pos: jlm.decode_step(jcfg, p, jctx, t, c,
                                                        pos))
    jtoks = [np.asarray(jlog[:, :jcfg.vocab_size].argmax(-1))]
    jlogs = [jlog]
    for i in range(n - 1):
        jlog, jc = jdec(params, jnp.asarray(jtoks[-1]), jc, s + i)
        jlogs.append(jlog)
        jtoks.append(np.asarray(jlog[:, :jcfg.vocab_size].argmax(-1)))
    arts = make_serve_steps(tcfg, impl="kernel", max_len=s + n, batch=b,
                            torch_chunk=16, device="cpu")
    if source == "tokens":
        gen = tserve.greedy_generate(arts, model, _t(prompt).long(), n,
                                     tcfg.vocab_size)
    else:
        gen = tserve.greedy_generate(arts, model, None, n, tcfg.vocab_size,
                                     embeds=_t(emb))
    np.testing.assert_array_equal(gen.tokens.numpy(), np.stack(jtoks, 1))
    for lg, jl in zip(gen.logits, jlogs):
        assert _rel(lg, jl) <= FWD_TOL


_LENS = ((12, 6), (7, 8), (9, 4), (10, 5))
_MODES = {
    # tests/test_torch_engine.py's modes: (window, pool (page_size,
    # num_pages, max_batch, max_pages_per_seq), prefill_len, engine
    # kwargs, request kwargs)
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
    "autotune": (None, (4, 13, 2, 6), 24, {"autotune": True}, {}),
}


def _reqs(vocab, system=0, motif=False, dup=False):
    rs = np.random.RandomState(0)
    head = rs.randint(0, vocab, size=system)
    out = []
    for n, g in _LENS:
        tail = (np.tile(rs.randint(0, vocab, size=4), -(-n // 4))[:n] if motif
                else rs.randint(0, vocab, size=n))
        out.append((np.concatenate([head, tail]).astype(np.int32), g))
    return out + out[:1] if dup else out


def _pcfg(pkg, ps, n_pages, mb, mp, shards=1):
    return pkg.PagedCacheConfig(page_size=ps, num_pages=n_pages, max_batch=mb,
                                max_pages_per_seq=mp, num_shards=shards)


@functools.lru_cache(maxsize=None)
def _window_models(window):
    """llava SMOKE with ``attn_window`` (the reclaim mode's), as _model."""
    jcfg, tcfg, params, tree, model = _model("llava")
    if window is None:
        return jcfg, tcfg, params, tree, model
    return (dataclasses.replace(jcfg, attn_window=window),
            dataclasses.replace(tcfg, attn_window=window), params, tree, model)


@functools.lru_cache(maxsize=None)
def _jax_engine(mode):
    window, pool, prefill_len, kw, rkw = _MODES[mode]
    jcfg, _, params, _, _ = _window_models(window)
    if "fault_plan" in kw:
        kw = dict(kw, fault_plan=jserving.FaultPlan(seed=kw["fault_plan"],
                                                    horizon=24))
    eng = jserving.ServingEngine(jcfg, _pcfg(jserving, *pool), params,
                                 impl="xla", prefill_len=prefill_len,
                                 xla_chunk=16, **kw)
    out, stats = eng.run(_reqs(jcfg.vocab_size, **rkw))
    return out, stats


@pytest.mark.parametrize("mode", list(_MODES))
def test_llava_engine_matches_jax(mode, tmp_path, monkeypatch):
    """llava's paged ``ServingEngine`` against JAX's in every mode the
    engine tests serve granite with: tokens and outcome counts equal."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "port.json"))
    window, pool, prefill_len, kw, rkw = _MODES[mode]
    _, tcfg, _, _, model = _window_models(window)
    if "fault_plan" in kw:
        kw = dict(kw, fault_plan=tserving.FaultPlan(seed=kw["fault_plan"],
                                                    horizon=24))
    eng = tserving.ServingEngine(tcfg, _pcfg(tserving, *pool), model,
                                 impl="torch", device="cpu",
                                 prefill_len=prefill_len, torch_chunk=16, **kw)
    tout, tstats = eng.run(_reqs(tcfg.vocab_size, **rkw))
    jout, jstats = _jax_engine(mode)
    assert tstats["outcomes"] == jstats["outcomes"]
    assert set(tout) == set(jout) and jout
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid],
                                      err_msg=f"{mode}: request {rid}")
    for key in ("decode_steps", "preemptions", "pages_reclaimed",
                "prefill_tokens_skipped", "accepted_tokens"):
        assert tstats[key] == jstats[key], key


_MESH_MODES = {
    "eager": ((8, 12, 2, 3), 24, {"poison_reclaimed": True}),
    "lazy_preempt": ((4, 8, 2, 8), 32, {"lazy": True}),
    "prefix_chunk": ((4, 26, 2, 8), 16,
                     {"share_prefix": True, "prefill_chunk": 6}),
}


def _mesh_rank(mesh, device, tcfg, tree, reqs):
    """One rank: llava's engine over the mesh in every mode of
    ``_MESH_MODES``."""
    params = convert.convert_params(tcfg, tree, device=device)
    res = {}
    for mode, (pool, prefill_len, kw) in _MESH_MODES.items():
        eng = tserving.ServingEngine(tcfg, _pcfg(tserving, *pool, N_RANKS),
                                     params, impl="torch", device=device,
                                     mesh=mesh, prefill_len=prefill_len,
                                     torch_chunk=16, **kw)
        out, stats = eng.run(list(reqs))
        res[mode] = {"out": out, "stats": stats}
    return res


def test_llava_sharded_engine_matches_jax():
    """Two gloo ranks, each with half of every layer's page pool, serve
    llava in three modes: both ranks give JAX's single-device tokens."""
    jcfg, tcfg, params, tree, _ = _model("llava")
    reqs = _reqs(tcfg.vocab_size)
    ranks = tmesh.run_ranks(_mesh_rank, N_RANKS, (tcfg, tree, reqs),
                            backend="gloo", device_type="cpu", timeout_s=600)
    for mode, ((ps, n_pages, mb, mp), prefill_len, kw) in _MESH_MODES.items():
        jeng = jserving.ServingEngine(jcfg, _pcfg(jserving, ps, n_pages - 1, mb,
                                                  mp), params, impl="xla",
                                      prefill_len=prefill_len, xla_chunk=16,
                                      **kw)
        jout, _ = jeng.run(list(reqs))
        r0, r1 = (r[mode] for r in ranks)
        assert r0["stats"] == r1["stats"], mode
        for r in (r0, r1):
            assert set(r["out"]) == set(jout)
            for rid in jout:
                np.testing.assert_array_equal(r["out"][rid], jout[rid],
                                              err_msg=f"{mode}: request {rid}")
    assert ranks[0]["lazy_preempt"]["stats"]["preemptions"] > 0


def test_hubert_has_no_decode_step():
    """hubert-xlarge is encoder-only: both serve launchers exit with the
    same refusal, and both engines assert an autoregressive arch."""
    msg = "hubert-xlarge is encoder-only: no decode step"
    with pytest.raises(SystemExit, match=msg):
        jserve.main(["--arch", ENC, "--smoke"])
    with pytest.raises(SystemExit, match=msg):
        tserve.main(["--arch", ENC, "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match=msg):
        tserve.main(["--arch", ENC, "--smoke", "--device", "cpu", "--paged"])
    jcfg, tcfg, params, _, model = _model("hubert")
    pool = (8, 11, 2, 3)
    with pytest.raises(AssertionError, match="autoregressive"):
        jserving.ServingEngine(jcfg, _pcfg(jserving, *pool), params, impl="xla")
    with pytest.raises(AssertionError, match="autoregressive"):
        tserving.ServingEngine(tcfg, _pcfg(tserving, *pool), model,
                               impl="torch", device="cpu")


# ---------------------------------------------------------------------------
# training: the launcher, a JAX checkpoint resumed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [VLM, ENC])
def test_train_launcher_runs_on_cpu(arch, tmp_path, capsys):
    """Both archs through the train launcher from embeds batches, f32 and
    bf16 (with its f32 master copy)."""
    for dtype in ("float32", "bfloat16"):
        res = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "32",
                           "--dtype", dtype, "--ckpt-dir",
                           str(tmp_path / dtype)])
        assert res["stop_step"] == 2 and res["opt"].step == 2
        assert (res["opt"].master is None) == (dtype == "float32")
        assert res["params"].frontend_proj.dtype == getattr(torch, dtype)
    assert "done at step 2" in capsys.readouterr().out


@pytest.mark.parametrize("arch", [VLM, ENC])
def test_trainer_resumes_a_jax_checkpoint(arch, tmp_path):
    """The JAX ``Trainer`` takes two steps on embeds batches and
    checkpoints; the port's ``Trainer`` resumes it and takes the third
    step, which JAX's takes too: every parameter (``frontend_proj`` and
    the embedding, which only AdamW's decay moves, among them) within 1e-6
    of its leaf's max, the loss within 1e-5."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32)
    kw = dict(vocab_size=tcfg.vocab_size, seq_len=24, global_batch=2, seed=1,
              frontend=tcfg.frontend)
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
    jl = jt.metrics_log[0]["loss"]
    assert abs(t.metrics_log[0]["loss"] - jl) <= 1e-5 * abs(jl)
    assert r["opt"].step == 3
    jnamed = convert._named_arrays(tcfg, jparams, r["params"])
    for n, p in r["params"].named_parameters():
        j = np.asarray(jnamed[n], np.float32)
        err = float(np.abs(p.detach().numpy() - j).max())
        assert err <= 1e-6 * max(float(np.abs(j).max()), 1e-30), n
