"""The port's MoE family (deepseek-moe-16b, dbrx-132b) against the JAX
package, on the CPU.

The SMOKE configs (2 layers; deepseek: 8 experts top 2 and 2 shared ones;
dbrx: 4 experts top 2), f32, JAX's params carried across by
``models/convert.py``. The same numpy inputs go through JAX (``impl="xla"``)
and the port (``impl="torch"`` or ``"kernel"``: on the CPU the kernels'
plain versions). Tolerances, the suite's: 2e-5 for an f32 forward
(``apply_moe``), 5e-5 relative to max(1, max|g|) for f32 gradients, logits
at 1e-4 (as ``tests/test_torch_serve.py``: two layers of f32 projections and
a vocab head whose sums XLA and torch order differently), the loss at 1e-5
relative; tokens and the dropped fraction exactly equal. The dropped
fraction of a whole forward is held to JAX's forward run op by op
(``scan_layers=False``, not jitted): XLA's jitted scan rounds its average
over the layers differently, by a few f32 ulps.
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
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.runtime.steps import make_serve_steps as j_make_serve_steps  # noqa: E402
from repro.runtime.steps import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import convert, moe  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime.steps import (make_serve_steps, make_train_step,  # noqa: E402
                                       place_batch, step_seed)
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

ARCHS = ("deepseek_moe_16b", "dbrx_132b")
TOL = 2e-5           # f32 forward
GRAD_TOL = 5e-5      # f32 gradients, relative to max(1, max|g|)
LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5


def _err(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _grad_ok(g, jg) -> bool:
    jg = np.asarray(jg, np.float32)
    return _err(g, jg) <= GRAD_TOL * max(1.0, float(np.abs(jg).max()))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **over):
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype=jnp.float32,
                               remat=False, **over)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32,
                               **over)
    return jcfg, tcfg


def _factor(jcfg, tcfg, factor):
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, capacity_factor=factor)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(
                tcfg.moe, capacity_factor=factor)))


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(JAX cfg, port cfg, JAX params, port params), f32."""
    jcfg, tcfg = _cfgs(arch)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.convert_params(tcfg, _np(params), device="cpu")
    return jcfg, tcfg, params, tparams


def _layer0(arch):
    """Layer 0's MoE leaves: the JAX dict and the port's module."""
    _, _, params, tparams = _model(arch)
    return (jax.tree.map(lambda a: a[0], params["blocks"]["sub_0"]["mlp"]),
            tparams.blocks[0].mlp)


def _x(seed, shape, d):
    return np.random.default_rng(seed).standard_normal(shape + (d,)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# configs and convert
# ---------------------------------------------------------------------------

def test_moe_family_is_ported():
    for arch in ARCHS:
        cfg = tconfigs.get_config(arch)
        assert cfg.family == "moe" and cfg.moe is not None
        assert tconfigs.smoke_config(arch).moe is not None


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_lands_every_moe_leaf(arch):
    """Every JAX leaf lands in one port parameter of its shape and value,
    the MoE's too (router, wi, wo, shared.wi, shared.wo); in a bf16 model
    the router stays f32, as JAX keeps it, and so do all AdamW moments."""
    jcfg, tcfg, params, tparams = _model(arch)
    named = dict(tparams.named_parameters())
    assert sum(x.size for x in jax.tree.leaves(params)) == \
        sum(p.numel() for p in named.values())
    host = _np(params)
    assert set(convert._named_arrays(tcfg, host, tparams)) == set(named)
    want = {"router", "wi", "wo"} | ({"shared"} if tcfg.moe.num_shared_experts
                                     else set())
    for i in range(tcfg.num_layers):
        layer = convert._layer_tree(tcfg, host, i)
        assert set(layer["mlp"]) == want
        for name in ("router", "wi", "wo"):
            assert _err(named[f"blocks.{i}.mlp.{name}"], layer["mlp"][name]) == 0.0
        if "shared" in want:
            for name in ("wi", "wo"):
                assert _err(named[f"blocks.{i}.mlp.shared.{name}"],
                            layer["mlp"]["shared"][name]) == 0.0
    e, d, f = tcfg.moe.num_experts, tcfg.d_model, tcfg.moe.d_ff_expert
    assert named["blocks.0.mlp.wi"].shape == (e, d, 2 * f)
    assert named["blocks.0.mlp.wo"].shape == (e, f, d)
    assert named["blocks.0.mlp.router"].shape == (d, e)

    jb = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tb = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    bparams, _ = jlm.init_params(jb, jax.random.PRNGKey(1))
    assert bparams["blocks"]["sub_0"]["mlp"]["router"].dtype == jnp.float32
    bmodel = convert.convert_params(tb, _np(bparams), device="cpu")
    for name, p in bmodel.named_parameters():
        assert p.dtype == (torch.float32 if name.endswith("mlp.router")
                           else torch.bfloat16), name
    opt = _np(j_adamw_init(bparams, JAdamWConfig(keep_master=True)))
    state = convert.convert_opt_state(tb, (opt.step, opt.m, opt.v, opt.master),
                                      bmodel, device="cpu")
    for tree in (state.m, state.v, state.master):
        assert all(t.dtype == torch.float32 for t in tree.values())
    assert torch.equal(state.master["blocks.1.mlp.router"],
                       bmodel.blocks[1].mlp.router)
    fresh = tlm.init_params(tb, seed=0, device="cpu")
    assert fresh.blocks[0].mlp.router.dtype == torch.float32
    assert fresh.blocks[0].mlp.wi.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

def test_capacity_and_groups_match_jax():
    for g, e, k, f in ((256, 64, 6, 1.25), (512, 16, 4, 1.25), (64, 8, 2, 1.0),
                       (50, 4, 2, 1.0), (4, 64, 6, 1.25), (40, 64, 6, 1.25)):
        assert moe.capacity(g, e, k, f) == jmoe._capacity(g, e, k, f)
    assert moe.group_size(150, 64) == 50 and moe.group_size(128, 64) == 64
    assert moe.group_size(7, 64) == 7 and moe.group_size(97, 64) == 1


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.05, 0.3], [0.2, 0.2, 0.2, 0.2, 0.2]],
                     np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = moe.top_k(_t(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[1, 2, 4], [0, 1, 2]]


def test_one_hot_matches_torch():
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (5, 7, 6)))
    for n in (64, 65):
        got = moe.one_hot(idx, n)
        assert got.dtype == torch.int64
        assert torch.equal(got, torch.nn.functional.one_hot(idx, n))


# (batch, seq): 128 tokens, groups of 64; 150 tokens, which 64 does not
# divide: groups of 50, the largest divisor
SHAPES = ((2, 64), (3, 50))


@pytest.mark.parametrize("factor", [8.0, 1.25, 1.0])
@pytest.mark.parametrize("shape", SHAPES, ids=["n128", "n150"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, shape, factor):
    """``out`` at 2e-5, ``moe_aux`` at 2e-5, ``moe_dropped`` equal: none
    dropped at factor 8, some at factor 1."""
    jcfg, tcfg, _, _ = _model(arch)
    jcfg, tcfg = _factor(jcfg, tcfg, factor)
    jp, tp = _layer0(arch)
    x = _x(sorted(SHAPES).index(shape), shape, tcfg.d_model)
    jout, jmet = jmoe.apply_moe(jp, jnp.asarray(x), JCtx(), jcfg)
    with torch.no_grad():
        out, met = moe.apply_moe(tp, _t(x), Ctx(), tcfg)
    assert out.shape == x.shape
    assert _err(out, jout) < TOL
    assert abs(float(met["moe_aux"]) - float(jmet["moe_aux"])) < TOL
    dropped = float(met["moe_dropped"])
    assert dropped == float(jmet["moe_dropped"])
    if factor == 8.0:
        assert dropped == 0.0
    if factor == 1.0 and shape == (2, 64):
        assert dropped > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_reference_matches_jax(arch):
    jcfg, tcfg, _, _ = _model(arch)
    jp, tp = _layer0(arch)
    x = _x(5, (2, 24), tcfg.d_model)
    jref = jmoe.moe_reference(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        ref = moe.moe_reference(tp, _t(x), tcfg)
        # with room for every choice, the capacity dispatch is the oracle
        out, _ = moe.apply_moe(tp, _t(x), Ctx(), _factor(jcfg, tcfg, 8.0)[1])
    assert _err(ref, jref) < TOL
    assert _err(out, ref) < TOL


@pytest.mark.parametrize("factor", [1.25, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_grads_match_jax(arch, factor):
    """d(Σ out·w + moe_aux)/d(x, router, wi, wo, shared) against
    ``jax.grad``, with choices dropped at factor 1."""
    jcfg, tcfg, _, _ = _model(arch)
    jcfg, tcfg = _factor(jcfg, tcfg, factor)
    jp, tp = _layer0(arch)
    x = _x(7, (2, 64), tcfg.d_model)
    w = _x(8, (2, 64), tcfg.d_model)

    def jloss(p, x):
        out, met = jmoe.apply_moe(p, x, JCtx(), jcfg)
        return jnp.sum(out * w) + met["moe_aux"]
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tx = _t(x).requires_grad_()
    tp.zero_grad(set_to_none=True)
    out, met = moe.apply_moe(tp, tx, Ctx(), tcfg)
    ((out * _t(w)).sum() + met["moe_aux"]).backward()
    assert _grad_ok(tx.grad, jgx)
    jnamed = {"router": jgp["router"], "wi": jgp["wi"], "wo": jgp["wo"]}
    if tcfg.moe.num_shared_experts:
        jnamed.update({"shared.wi": jgp["shared"]["wi"],
                       "shared.wo": jgp["shared"]["wo"]})
    named = dict(tp.named_parameters())
    assert set(named) == set(jnamed)
    for name, g in jnamed.items():
        assert _grad_ok(named[name].grad, g), name
    tp.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# lm: forward, loss_fn
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_dropped_op_by_op(arch, tokens_bytes, shape):
    """JAX's forward ``moe_dropped``, op by op (unrolled, not jitted)."""
    jcfg, _, params, _ = _model(arch)
    jcfg = dataclasses.replace(jcfg, scan_layers=False)
    tokens = np.frombuffer(tokens_bytes, np.int32).reshape(shape)
    _, _, met = jlm.forward(jcfg, params, JCtx(impl="xla", xla_chunk=16),
                            tokens=jnp.asarray(tokens))
    return float(met["moe_dropped"])


def _tokens(jcfg, seed, shape=(2, 40)):
    return np.random.default_rng(seed).integers(0, jcfg.vocab_size, shape
                                                ).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_jax(arch):
    """Logits at 1e-4, ``moe_aux`` (summed over the layers) at 2e-5,
    ``moe_dropped`` (their mean) equal to JAX's op-by-op value."""
    jcfg, tcfg, params, tparams = _model(arch)
    tokens = _tokens(jcfg, 4)
    jlog, _, jmet = jax.jit(lambda p, t: jlm.forward(
        jcfg, p, JCtx(impl="xla", xla_chunk=16), tokens=t))(params, tokens)
    dropped = _jax_dropped_op_by_op(arch, tokens.tobytes(), tokens.shape)
    assert abs(dropped - float(jmet["moe_dropped"])) < 1e-6
    for impl in ("torch", "kernel"):
        with torch.no_grad():
            tlog, caches, met = tlm.forward(tcfg, tparams,
                                            Ctx(impl=impl, torch_chunk=16),
                                            tokens=_t(tokens))
        assert caches is None and set(met) == {"moe_aux", "moe_dropped"}
        assert _err(tlog, jlog) < LOGIT_TOL, impl
        assert abs(float(met["moe_aux"]) - float(jmet["moe_aux"])) < TOL
        assert float(met["moe_dropped"]) == dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_caches_skips_the_moe_metrics(arch):
    """A forward that fills caches (the serving steps, which drop the MoE
    metrics as JAX's jitted steps do) returns none, and the same logits."""
    jcfg, tcfg, _, tparams = _model(arch)
    tokens = _t(_tokens(jcfg, 4)).long()
    ctx = Ctx(impl="torch", torch_chunk=16)
    with torch.no_grad():
        full, _, met = tlm.forward(tcfg, tparams, ctx, tokens=tokens)
        caches = tlm.init_cache(tcfg, tokens.shape[0], tokens.shape[1],
                                device="cpu")
        cached, caches, cmet = tlm.forward(tcfg, tparams, ctx, tokens=tokens,
                                           caches=caches)
    assert set(met) == {"moe_aux", "moe_dropped"} and cmet == {}
    assert len(caches) == tcfg.num_layers
    assert _err(cached, full.numpy()) < LOGIT_TOL


def test_route_recorder_counts_each_expert_not_taken():
    """Replayed routes: a choice flips when its expert is not among the
    forced ones for that token, whatever their order ({2, 3, 4} against
    {1, 2, 3} is one flip); the gates are this run's probabilities of the
    forced experts, and ``moe.top_k`` is restored on exit."""
    from repro_torch.models.moe_routes import RouteRecorder, route_diff

    probs = torch.tensor([[0.05, 0.10, 0.25, 0.35, 0.20, 0.05, 0.0, 0.0],
                          [0.40, 0.30, 0.10, 0.05, 0.05, 0.05, 0.05, 0.0]])
    forced = torch.tensor([[1, 2, 3], [0, 1, 2]])
    top_k = moe.top_k
    with RouteRecorder([forced]) as rec:
        vals, idx = moe.top_k(probs, 3)
    assert moe.top_k is top_k
    assert rec.calls[0].tolist() == [[3, 2, 4], [0, 1, 2]]
    assert (rec.flips, rec.decisions) == (1, 6)
    assert torch.equal(idx, forced) and torch.equal(vals, probs.gather(-1, forced))
    _, tcfg = _cfgs("deepseek_moe_16b")                  # 8 experts
    missing, changed = route_diff(tcfg.moe, rec.calls[0], forced)
    assert missing == 1 and changed.tolist() == [True, False]


@pytest.mark.parametrize("arch", ARCHS)
def test_route_recorder_records_and_replays_a_forward(arch):
    """One call a layer; the dropped fraction of the recorded routes is the
    forward's ``moe_dropped``; a run replaying its own routes flips none
    and gives the same logits bit for bit."""
    from repro_torch.models.moe_routes import RouteRecorder, dropped_fraction

    jcfg, tcfg, _, tparams = _model(arch)
    tokens = _t(_tokens(jcfg, 5)).long()
    ctx = Ctx(impl="torch", torch_chunk=16)
    with torch.no_grad():
        with RouteRecorder() as rec:
            logits, _, met = tlm.forward(tcfg, tparams, ctx, tokens=tokens)
        with RouteRecorder(rec.calls) as again:
            replayed, _, _ = tlm.forward(tcfg, tparams, ctx, tokens=tokens)
    assert len(rec.calls) == tcfg.num_layers
    assert all(c.shape == (tokens.numel(), tcfg.moe.top_k) for c in rec.calls)
    assert abs(dropped_fraction(tcfg.moe, rec.calls)
               - float(met["moe_dropped"])) < 1e-6
    assert (again.flips, again.decisions) == (
        0, tcfg.num_layers * tokens.numel() * tcfg.moe.top_k)
    assert torch.equal(replayed, logits)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, dropout):
    jcfg, tcfg = _cfgs(arch, dropout_rate=dropout)
    _, _, params, _ = _model(arch)
    dc = DataConfig(vocab_size=tcfg.vocab_size, seq_len=48, global_batch=2,
                    seed=11)
    batch = make_batch(dc, 0)
    seed = step_seed(7)

    def jloss(p, b):
        ctx = JCtx(impl="xla", deterministic=dropout == 0.0,
                   seed=jnp.int32(seed), xla_chunk=16)
        return jlm.loss_fn(jcfg, p, b, ctx)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, seed, float(jl), {k: float(v) for k, v in jm.items()}, _np(jg)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(arch, dropout, impl):
    """The loss (cross-entropy plus 0.01 · moe_aux) at 1e-5 relative, its
    metrics, and every gradient leaf (the aux loss's path to the router
    included) at 5e-5 of max(1, max|g|)."""
    _, tcfg = _cfgs(arch, dropout_rate=dropout)
    _, _, params, _ = _model(arch)
    batch, seed, jl, jm, jg = _jax_loss_and_grads(arch, dropout)
    model = convert.convert_params(tcfg, _np(params), device="cpu")
    ctx = Ctx(impl=impl, deterministic=dropout == 0.0, seed=seed,
              torch_chunk=16)
    loss, met = tlm.loss_fn(tcfg, model, place_batch(batch, "cpu"), ctx)
    loss.backward()
    met = {k: float(v.detach()) for k, v in met.items()}
    assert set(met) == {"ce", "loss", "moe_aux", "moe_dropped"}
    assert abs(met["loss"] - jl) <= LOSS_RTOL * abs(jl)
    assert abs(met["ce"] - jm["ce"]) <= LOSS_RTOL * abs(jm["ce"])
    assert abs(met["moe_aux"] - jm["moe_aux"]) < TOL
    assert met["loss"] == float(np.float32(met["ce"])
                                + np.float32(0.01) * np.float32(met["moe_aux"]))
    assert abs(met["moe_dropped"] - jm["moe_dropped"]) < 1e-6
    jnamed = convert._named_arrays(tcfg, jg, model)
    for name, p in model.named_parameters():
        assert _grad_ok(p.grad, jnamed[name]), name
    assert float(model.blocks[0].mlp.router.grad.abs().max()) > 0.0


def test_remat_gives_the_same_loss_grads_and_metrics():
    _, tcfg = _cfgs("deepseek_moe_16b", dropout_rate=0.1)
    batch = place_batch(make_batch(DataConfig(
        vocab_size=tcfg.vocab_size, seq_len=32, global_batch=2, seed=2), 0), "cpu")
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = tlm.init_params(cfg, seed=1, device="cpu")
        loss, met = tlm.loss_fn(cfg, model, batch, Ctx(impl="kernel",
                                                      deterministic=False,
                                                      seed=5, torch_chunk=16))
        loss.backward()
        out.append((float(loss.detach()),
                    {k: float(v.detach()) for k, v in met.items()},
                    [p.grad.clone() for p in model.parameters()]))
    assert out[0][0] == out[1][0] and out[0][1] == out[1][1]
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# serving: contiguous, the paged steps, the engine, --mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill of 2 × 24 tokens and 8 greedy decode steps (groups of 48,
    then of 2 tokens): logits at 1e-4 at every step, tokens equal."""
    jcfg, tcfg, params, tparams = _model(arch)
    b, s, steps = 2, 24, 8
    prompt = _tokens(jcfg, 3, (b, s))
    jarts = j_make_serve_steps(jcfg, impl="xla", max_len=s + steps + 1,
                               batch=b, xla_chunk=16)
    caches = jarts.cache_init_fn()
    logits, caches = jarts.prefill_fn(params, jnp.asarray(prompt), None, caches)
    jlogits = [np.asarray(logits)]
    jtoks = [np.asarray(jnp.argmax(logits[:, :jcfg.vocab_size], axis=-1))]
    for i in range(steps):
        logits, caches = jarts.decode_fn(params, jnp.asarray(jtoks[-1]), caches,
                                         jnp.int32(s + i))
        jlogits.append(np.asarray(logits))
        jtoks.append(np.asarray(jnp.argmax(logits[:, :jcfg.vocab_size], axis=-1)))
    arts = make_serve_steps(tcfg, impl="kernel", max_len=s + steps + 1,
                            batch=b, torch_chunk=16, device="cpu")
    res = tserve.greedy_generate(arts, tparams, _t(prompt).long(), steps + 1,
                                 tcfg.vocab_size)
    for step, (tl, jl) in enumerate(zip(res.logits, jlogits)):
        assert _err(tl, jl) < LOGIT_TOL, f"step {step}"
    np.testing.assert_array_equal(res.tokens.numpy(), np.stack(jtoks, 1))


def test_lm_paged_steps_match_jax():
    """Packed prefill of two prompts and padding (padding tokens go through
    the experts and take capacity, as in JAX), a decode step with slot 2
    idle, a chunk continuing prompt 0 and a verify step: logits at 1e-4 and
    the pools against JAX's jitted paged steps."""
    arch = "deepseek_moe_16b"
    jcfg, tcfg, jparams, tparams = _model(arch)
    ps, t, n_pages, width, mb = 4, 6, 14, 16, 3
    jpcfg = jserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                      max_batch=mb, max_pages_per_seq=t)
    pcfg = tserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                     max_batch=mb, max_pages_per_seq=t)
    jarts = j_make_serve_steps(jcfg, impl="xla", paged=jpcfg, xla_chunk=16)
    tarts = make_serve_steps(tcfg, impl="kernel", paged=pcfg, torch_chunk=16,
                             device="cpu")
    jcaches, tcaches = jarts.cache_init_fn(), tarts.cache_init_fn()
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
            jlayer = convert._layer_tree(tcfg, _np(jcaches), i)
            for key, val in layer.items():
                assert _err(val, jlayer[key]) < 1e-4, (step, i, key)

    lens = (9, 5)
    tokens = np.zeros((1, width), np.int32)
    seg = np.full((1, width), -1, np.int32)
    pos = np.zeros((1, width), np.int32)
    dest = np.zeros((1, width), np.int32)
    off = 0
    for i, n in enumerate(lens):
        tokens[0, off:off + n] = r.integers(0, jcfg.vocab_size, n)
        seg[0, off:off + n] = i
        pos[0, off:off + n] = np.arange(n)
        dest[0, off:off + n] = slots(i, 0, n)
        off += n
    no_state = np.full((1, width), -1, np.int32)
    args = (tokens, seg, pos, dest, no_state)
    check("prefill", jarts.prefill_fn(jparams, *map(jnp.asarray, args), jcaches),
          tarts.prefill_fn(tparams, *map(_t, args), tcaches),
          ends=np.cumsum(lens) - 1)

    kv_len = np.array(list(lens) + [0], np.int32)
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
    # the span's decode slot (row 0): the port's chunk step returns the
    # logits of the rows that end a span of it
    sl = np.where(kvl > 0, 0, -1).astype(np.int32)
    args = (tokens, pos, dest, ttab, kvl, sl, np.zeros((1, 8), np.int32))
    check("chunk", jarts.chunk_prefill_fn(jparams, *map(jnp.asarray, args),
                                          jcaches),
          tarts.chunk_prefill_fn(tparams, *map(_t, args), tcaches),
          ends=[4])
    kv_len[0] = b

    w = 3
    vtok = r.integers(0, jcfg.vocab_size, (mb, w)).astype(np.int32)
    vpos = np.zeros((mb, w), np.int32)
    vkvl = np.zeros((mb, w), np.int32)
    vdest = np.zeros((mb, w), np.int32)
    vtab = np.zeros((mb, w, t), np.int32)
    for row in range(2):
        n = int(kv_len[row])
        vpos[row] = np.arange(n, n + w)
        vkvl[row] = vpos[row] + 1
        vdest[row] = slots(row, n, n + w)
        vtab[row] = tables[row]
    args = (vtok, vpos, vdest, vtab, vkvl)
    check("verify", jarts.verify_fn(jparams, *map(jnp.asarray, args), jcaches),
          tarts.verify_fn(tparams, *map(_t, args), tcaches))


_LENS = ((12, 6), (7, 8), (9, 4), (10, 5))
_MODES = {
    # name: (pool (page_size, num_pages, max_batch, max_pages_per_seq),
    #        prefill_len, engine kwargs, request kwargs)
    "eager": ((8, 11, 2, 3), 24, {}, {}),
    "lazy_preempt": ((4, 6, 2, 8), 32, {"lazy": True}, {}),
    "chunked_prefill": ((8, 11, 2, 3), 24, {"prefill_chunk": 5}, {}),
    "prefix_chunk": ((4, 25, 2, 8), 16,
                     {"share_prefix": True, "prefill_chunk": 6},
                     {"system": 8, "dup": True}),
    "speculate_3": ((8, 11, 2, 3), 24, {"speculate_k": 3}, {"motif": True}),
    "num_splits_2": ((4, 13, 2, 6), 24, {"num_splits": 2}, {}),
}


def _reqs(vocab, lens, system=0, motif=False, dup=False):
    """As tests/test_torch_engine.py: random prompts, a common ``system``
    prefix, a tiled 4-token ``motif``, or the first request again (``dup``)."""
    rs = np.random.RandomState(0)
    head = rs.randint(0, vocab, size=system)
    out = []
    for n, g in lens:
        tail = (np.tile(rs.randint(0, vocab, size=4), -(-n // 4))[:n] if motif
                else rs.randint(0, vocab, size=n))
        out.append((np.concatenate([head, tail]).astype(np.int32), g))
    return out + out[:1] if dup else out


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch, mode):
    """The port's engine (impl="torch") against JAX's (impl="xla") at the
    config's capacity factor, drops included: tokens, outcomes and the
    scheduler's counts equal."""
    (ps, n_pages, mb, mp), prefill_len, kw, rkw = _MODES[mode]
    jcfg, tcfg, params, tparams = _model(arch)
    jeng = jserving.ServingEngine(
        jcfg, jserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                        max_batch=mb, max_pages_per_seq=mp),
        params, impl="xla", prefill_len=prefill_len, xla_chunk=16, **kw)
    teng = tserving.ServingEngine(
        tcfg, tserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                        max_batch=mb, max_pages_per_seq=mp),
        tparams, impl="torch", device="cpu", prefill_len=prefill_len,
        torch_chunk=16, **kw)
    reqs = _reqs(jcfg.vocab_size, _LENS, **rkw)
    jout, jstats = jeng.run(list(reqs))
    tout, tstats = teng.run(list(reqs))
    assert tstats["outcomes"] == jstats["outcomes"]
    assert set(tout) == set(jout) and jout
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], jout[rid],
                                      err_msg=f"{mode}: request {rid}")
    for key in ("decode_steps", "preemptions", "pages_grown", "prefill_tokens",
                "prefill_tokens_skipped", "pages_shared", "cow_copies",
                "drafted_tokens", "accepted_tokens"):
        assert tstats[key] == jstats[key], key
    if mode == "lazy_preempt":
        assert tstats["preemptions"] > 0
    if mode == "prefix_chunk":
        assert tstats["prefill_tokens_skipped"] > 0
    if mode == "speculate_3":
        assert tstats["accepted_tokens"] > 0
    alloc = teng.scheduler.tables.allocator
    assert alloc.num_allocated == 0


def test_paged_mesh_cli_matches_one_device(capsys):
    """``--paged --mesh 2 --dist-backend gloo`` (the gated partials' plain
    version on the MoE path): tokens equal to the run on one device."""
    base = ["--arch", "deepseek_moe_16b", "--smoke", "--device", "cpu",
            "--paged", "--requests", "4", "--prompt-len", "16", "--gen", "5",
            "--max-batch", "2"]
    out, _, ranks = tserve.main(base + ["--mesh", "2", "--dist-backend", "gloo"])
    assert "mesh: 2 ranks on the pool axis" in capsys.readouterr().out
    assert len(ranks) == 2 and len(out) == 4
    single, _, _ = tserve.main(base)
    for rid in single:
        np.testing.assert_array_equal(out[rid], single[rid])


# ---------------------------------------------------------------------------
# training: a JAX checkpoint resumed, the launchers
# ---------------------------------------------------------------------------

def test_trainer_resumes_a_jax_moe_checkpoint(tmp_path):
    """The JAX ``Trainer`` takes two steps of deepseek-moe SMOKE and
    checkpoints; the port's ``Trainer`` resumes it and takes the third,
    which JAX's takes too from a copy: every parameter within 1e-6 of each
    leaf's max, the loss within 1e-5 relative."""
    from repro.runtime.trainer import Trainer as JTrainer
    from repro.runtime.trainer import TrainerConfig as JTrainerConfig

    jcfg, tcfg = _cfgs("deepseek_moe_16b")
    kw = dict(vocab_size=tcfg.vocab_size, seq_len=24, global_batch=2, seed=1)
    tc = dict(ckpt_every=100, log_every=1000)
    jarts = j_make_train_step(jcfg, opt=JAdamWConfig(lr=1e-3), impl="xla",
                              xla_chunk=16, donate=False)
    JTrainer(arts=jarts, data_cfg=JDataConfig(**kw), tcfg=JTrainerConfig(
        ckpt_dir=str(tmp_path / "jax"), **tc)).run(2)
    assert tckpt.is_jax_layout(str(tmp_path / "jax"), 1)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jt = JTrainer(arts=jarts, data_cfg=JDataConfig(**kw), tcfg=JTrainerConfig(
        ckpt_dir=str(tmp_path / "jax"), **tc))
    jparams = _np(jt.run(3)["params"])
    arts = make_train_step(tcfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                           torch_chunk=16, device="cpu")
    t = Trainer(arts=arts, data_cfg=DataConfig(**kw), tcfg=TrainerConfig(
        ckpt_dir=str(tmp_path / "port"), **tc))
    r = t.run(3)
    jl = jt.metrics_log[0]["loss"]
    assert [m["step"] for m in t.metrics_log] == [2]
    assert abs(t.metrics_log[0]["loss"] - jl) <= LOSS_RTOL * abs(jl)
    jnamed = convert._named_arrays(tcfg, jparams, r["params"])
    for name, p in r["params"].named_parameters():
        jg = np.asarray(jnamed[name], np.float32)
        assert _err(p.data, jg) <= 1e-6 * max(float(np.abs(jg).max()), 1e-30), name


def test_microbatch_metrics_are_the_last_microbatch():
    """With microbatches, the MoE metrics are the last microbatch's (JAX's
    scan keeps ``ms[-1]``) and the loss is the mean."""
    _, tcfg = _cfgs("dbrx_132b")
    dc = DataConfig(vocab_size=tcfg.vocab_size, seq_len=24, global_batch=4,
                    seed=3)
    batch = place_batch(make_batch(dc, 0), "cpu")
    arts = make_train_step(tcfg, impl="kernel", microbatch=2, torch_chunk=16,
                           device="cpu")
    params, opt = arts.init_fn(0)
    ctx = Ctx(impl="kernel", torch_chunk=16)
    with torch.no_grad():
        parts = [tlm.loss_fn(tcfg, params, {k: v[i:i + 2] for k, v in
                                            batch.items()}, ctx)
                 for i in (0, 2)]
    _, _, met = arts.step_fn(params, opt, batch, 0)
    assert float(met["moe_aux"]) == float(parts[1][1]["moe_aux"])
    assert float(met["moe_dropped"]) == float(parts[1][1]["moe_dropped"])
    mean = (float(parts[0][0]) + float(parts[1][0])) / 2
    assert abs(float(met["loss"]) - mean) <= 1e-6 * abs(mean)


def test_serve_cli_drives_the_moe_family(capsys):
    base = ["--arch", "deepseek_moe_16b", "--smoke", "--device", "cpu"]
    res = tserve.main(base + ["--batch", "2", "--prompt-len", "16", "--gen",
                              "4"])
    assert res.tokens.shape == (2, 4)
    assert all(torch.isfinite(x).all() for x in res.logits)
    out, stats, _ = tserve.main(base + ["--paged", "--requests", "4",
                                        "--prompt-len", "16", "--gen", "6",
                                        "--lazy", "--num-pages", "8",
                                        "--speculate", "2"])
    assert stats["outcomes"]["completed"] == 4 and len(out) == 4
    res = tserve.main(["--arch", "dbrx_132b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert res.tokens.shape == (2, 3)
    text = capsys.readouterr().out
    assert "served 4 requests" in text and "speculation:" in text


def test_train_cli_drives_the_moe_family(tmp_path, capsys):
    res = ttrain.main(["--arch", "deepseek_moe_16b", "--smoke", "--device",
                       "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
                       "--ckpt-dir", str(tmp_path)])
    assert res["stop_step"] == 2 and not res["preempted"]
    assert res["opt"].master is None
    assert res["params"].blocks[0].mlp.router.dtype == torch.float32
    assert "done at step 2" in capsys.readouterr().out
    t = Trainer(arts=make_train_step(
        _cfgs("dbrx_132b")[1], impl="kernel", torch_chunk=16, device="cpu"),
        data_cfg=DataConfig(vocab_size=256, seq_len=16, global_batch=2),
        tcfg=TrainerConfig(ckpt_dir=str(tmp_path / "log"), log_every=1))
    t.run(1)
    assert "moe_aux" in capsys.readouterr().out
