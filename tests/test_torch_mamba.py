"""The port's Mamba-1 mixer (falcon-mamba-7b, the ssm family) against the
JAX package, on the CPU: the config, the converter, the chunk scan, the
step, the packed scan, the mixer's gradients and ``lm.forward``.

falcon-mamba-7b SMOKE (d 64, Di 128, N 4, conv 4, dt_rank 4; 2 or 3
mixer-only layers), f32, JAX's params carried across by
``models/convert.py``. The same numpy inputs go through JAX (jit-compiled)
and the port. Tolerances: the scan, step and packed scan at 2e-5 of
max(1, max|JAX|) (the JAX suite's f32 forward tolerance; the port's
doubling scan and ``associative_scan`` associate the products differently,
and the port carries a chunk's state in through its first source term),
gradients at 5e-5 of each leaf's max (the JAX suite's f32 gradient
tolerance), logits at 1e-4 (as ``tests/test_torch_hybrid.py``).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import convert, mamba  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402

ARCH = "falcon_mamba_7b"
TOL = 2e-5           # the JAX suite's f32 forward tolerance
GRAD_TOL = 5e-5      # the JAX suite's f32 gradient tolerance
LOGIT_TOL = 1e-4     # as tests/test_torch_hybrid.py
LEAVES = ("in_proj", "conv", "w_bc", "w_dt1", "w_dt2", "dt_bias", "A_log",
          "D", "out_proj")


def _err(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _rel(a, b):
    """max |a - b| over max(1, max |b|)."""
    return _err(a, b) / max(1.0, float(np.abs(np.asarray(b)).max()))


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _model(num_layers=2):
    """(JAX cfg, port cfg, JAX params, port params), f32."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), dtype=jnp.float32,
                               remat=False, num_layers=num_layers)
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH), dtype=torch.float32,
                               num_layers=num_layers)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.convert_params(tcfg, jax.tree.map(np.asarray, params),
                                     device="cpu")
    return jcfg, tcfg, params, tparams


# ---------------------------------------------------------------------------
# config and convert
# ---------------------------------------------------------------------------

def test_config_matches_jax():
    for get in ("get_config", "smoke_config"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab_size", "block_pattern",
                  "causal", "mlp_type"):
            assert getattr(t, f) == getattr(j, f), f
        assert dataclasses.asdict(t.mamba) == dataclasses.asdict(j.mamba)
        assert t.mamba.dt_rank == -(-t.d_model // 16)
        assert t.param_count() == j.param_count()
    assert tconfigs.get_config(ARCH).mamba.dt_rank == 256
    assert tconfigs.get_config(ARCH).family == "ssm"


@pytest.mark.parametrize("num_layers", [2, 3])
def test_convert_lands_every_leaf(num_layers):
    """Every JAX leaf lands in one port parameter of its shape and value;
    the blocks are mixer-only (no norm2, no mlp); dt_bias, A_log and D
    stay f32 in a bf16 model."""
    jcfg, tcfg, params, tparams = _model(num_layers)
    leaves = jax.tree.leaves(params)
    named = dict(tparams.named_parameters())
    assert len(leaves) == 3 + 10                    # stacked over the layers
    assert len(named) == 3 + 10 * num_layers
    assert sum(x.size for x in leaves) == sum(p.numel() for p in named.values())
    host = jax.tree.map(np.asarray, params)
    for i, blk in enumerate(tparams.blocks):
        assert blk.kind == "ssm"
        assert not hasattr(blk, "norm2") and not hasattr(blk, "mlp")
        layer = convert._layer_tree(tcfg, host, i)
        assert set(layer) == {"norm1", "mixer"}
        assert set(layer["mixer"]) == set(LEAVES)
        for name in LEAVES:
            assert _err(named[f"blocks.{i}.mixer.{name}"],
                        layer["mixer"][name]) == 0.0, (i, name)
    bf16 = convert.convert_params(dataclasses.replace(tcfg, dtype=torch.bfloat16),
                                  host, device="cpu")
    for name, w in bf16.blocks[0].mixer.named_parameters():
        want = torch.float32 if name in ("dt_bias", "A_log", "D") else torch.bfloat16
        assert w.dtype == want, name


def test_init_params_matches_jax_init():
    """The port's random init has JAX's shapes, dtypes and fixed leaves:
    A_log = log(1..N) in every channel, dt_bias 0, D 1, unit norms."""
    _, tcfg, params, _ = _model()
    model = tlm.init_params(tcfg, seed=0, device="cpu")
    host = jax.tree.map(np.asarray, params)
    named = dict(model.named_parameters())
    for name, arr in convert._named_arrays(tcfg, host, model).items():
        assert tuple(named[name].shape) == arr.shape, name
    p = model.blocks[0].mixer
    jp = convert._layer_tree(tcfg, host, 0)["mixer"]
    for name in ("A_log", "dt_bias", "D"):
        assert _err(getattr(p, name), jp[name]) == 0.0, name
    assert abs(float(p.conv.detach().std()) - 0.1) < 0.02
    assert float(model.blocks[0].norm1.detach().min()) == 1.0


# ---------------------------------------------------------------------------
# the scan, the step and the packed scan
# ---------------------------------------------------------------------------

def _scan_inputs(seed, b, s, di, n):
    r = np.random.default_rng(seed)
    u = r.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, di)) - 1.0)).astype(np.float32)
    bm = r.standard_normal((b, s, n)).astype(np.float32)
    cm = r.standard_normal((b, s, n)).astype(np.float32)
    a = -np.exp(r.standard_normal((di, n)) * 0.5).astype(np.float32)
    d = r.standard_normal(di).astype(np.float32)
    return u, dt, bm, cm, a, d


@pytest.mark.parametrize("s,chunk", [(24, 8), (20, 8)])
def test_ssm_scan_matches_jax(s, chunk):
    """S a multiple of the chunk (three chunks: the state is carried twice)
    and not (the chunk becomes the whole sequence, as in JAX)."""
    args = _scan_inputs(1, 2, s, 6, 4)
    jy, jh = jax.jit(functools.partial(jmamba._ssm_scan, chunk=chunk))(*args)
    y, h = mamba._ssm_scan(*map(_t, args), chunk=chunk)
    assert _rel(y, jy) < TOL and _rel(h, jh) < TOL
    assert [sl.stop - sl.start for sl in mamba._chunks(s, chunk)] == \
        ([chunk] * (s // chunk) if s % chunk == 0 else [s])


def test_ssm_step_rollout_equals_the_scan():
    """The step chain (the port's oracle ``_ssm_steps``) against the chunk
    scan and against JAX's steps, token by token."""
    u, dt, bm, cm, a, d = _scan_inputs(2, 2, 24, 6, 4)
    y, h = mamba._ssm_scan(*map(_t, (u, dt, bm, cm, a, d)), chunk=8)
    ys, hs = mamba._ssm_steps(*map(_t, (u, dt, bm, cm, a, d)))
    assert _rel(ys, y.numpy()) < TOL and _rel(hs, h.numpy()) < TOL
    jstep = jax.jit(jmamba._ssm_step)
    jh = np.zeros((2, 6, 4), np.float32)
    th = torch.zeros(2, 6, 4)
    for t in range(24):
        jy, jh = jstep(u[:, t], dt[:, t], bm[:, t], cm[:, t], a, d, jh)
        ty, th = mamba._ssm_step(*map(_t, (u[:, t], dt[:, t], bm[:, t],
                                           cm[:, t], a, d)), th)
        assert _rel(ty, jy) < TOL and _rel(th, jh) < TOL, t
        assert _rel(ty, ys[:, t].numpy()) < TOL, t


def test_ssm_scan_packed_matches_jax():
    """Two packed rows over three chunks of 8: a fresh span, a continuation
    resuming its slot's stored state, spans that straddle chunk boundaries,
    a one-token span, and padding; state rows [n_slots + 1, Di, N] whose
    trash row holds 1e6. Outputs at live tokens and the scattered rows
    against JAX's."""
    n_slots, s, di, n = 4, 24, 6, 4
    u, dt, bm, cm, a, d = _scan_inputs(3, 2, s, di, n)
    slots = np.full((2, s), -1, np.int32)
    local = np.zeros((2, s), np.int32)
    pos = np.zeros((2, s), np.int32)
    spans = {0: ((0, 0, 11, 0), (2, 11, 9, 5), (1, 20, 1, 0)),
             1: ((3, 3, 14, 7),)}
    for row, row_spans in spans.items():
        for slot, start, length, p0 in row_spans:
            slots[row, start:start + length] = slot
            local[row, start:start + length] = np.arange(length)
            pos[row, start:start + length] = p0 + np.arange(length)
    seg = mamba._packed_seg({"state_slots": _t(slots), "state_local": _t(local)},
                            _t(pos))
    _, _, is_start, inject, is_end = (x.numpy() for x in seg)
    assert inject.sum() == 2                      # slots 2 and 3 resume
    state = np.random.default_rng(4).standard_normal(
        (n_slots + 1, di, n)).astype(np.float32)
    state[-1] = 1e6
    jy, jst = jax.jit(functools.partial(jmamba._ssm_scan_packed, chunk=8))(
        u, dt, bm, cm, a, d, state, slots, is_start, inject, is_end)
    st = _t(state)
    y = mamba._ssm_scan_packed(*map(_t, (u, dt, bm, cm, a, d)), st,
                               *map(_t, (slots, is_start, inject, is_end)),
                               chunk=8)
    live = slots >= 0
    assert _rel(y.numpy()[live], np.asarray(jy)[live]) < TOL
    assert _rel(st[:n_slots], np.asarray(jst)[:n_slots]) < TOL


# ---------------------------------------------------------------------------
# the mixer and the model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mixer():
    jcfg, tcfg, _, _ = _model()
    jp, _ = jmamba.init_mamba(jax.random.PRNGKey(11), jcfg, jnp.float32)
    # a non-trivial dt_bias and D, so that their gradients are exercised
    jp = dict(jp, dt_bias=jp["dt_bias"] - 1.0,
              D=jp["D"] + 0.1 * jax.random.normal(jax.random.PRNGKey(12),
                                                  jp["D"].shape))
    tp = mamba.Mamba(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, w in tp.named_parameters():
            w.copy_(_t(jp[name]))
    return jcfg, tcfg, jp, tp


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def test_apply_mamba_and_its_decode_match_jax():
    """Prefill (the scan, with its final state) and a decode chain, against
    JAX's, and the port's chain against its own scan (as
    tests/test_models.py pins step = scan for JAX)."""
    jcfg, tcfg, jp, tp = _mixer()
    b, s = 2, 12
    x = _x(1, b, s, tcfg.d_model)
    jctx = JCtx(impl="xla")
    jout, jcache = jax.jit(lambda x: jmamba.apply_mamba(
        jp, x, jctx, jcfg, cache=jmamba.init_mamba_cache(jcfg, b)))(x)
    cache = mamba.init_mamba_cache(tcfg, b, "cpu")
    assert cache["h"].shape == (b, 128, 4) and cache["conv"].shape == (b, 3, 128)
    with torch.no_grad():
        out, cache = mamba.apply_mamba(tp, _t(x), Ctx(impl="torch"), tcfg,
                                       cache=cache)
        assert _rel(out, jout) < TOL
        for key in ("h", "conv"):
            assert _rel(cache[key], jcache[key]) < TOL, key
        jstep = jax.jit(lambda x, c: jmamba.apply_mamba(
            jp, x, dataclasses.replace(jctx, decode=True), jcfg, cache=c))
        tc = mamba.init_mamba_cache(tcfg, b, "cpu")
        jc = jmamba.init_mamba_cache(jcfg, b)
        dctx = Ctx(impl="torch", decode=True)
        for t in range(s):
            o_t, tc = mamba.apply_mamba(tp, _t(x[:, t:t + 1]), dctx, tcfg,
                                        cache=tc)
            jo_t, jc = jstep(x[:, t:t + 1], jc)
            assert _rel(o_t[:, 0], out[:, t].numpy()) < TOL, f"step {t}"
            assert _rel(o_t, jo_t) < TOL, f"step {t}"
        for key in ("h", "conv"):
            assert _rel(tc[key], cache[key].numpy()) < TOL, key


def test_apply_mamba_grads_match_jax():
    """Gradients of the mixer (every weight and the input) at S 512, two
    chunks of 256 with the state carried between them: the port's doubling
    scan and carry against JAX's ``associative_scan`` and ``a_cum``
    injection, each leaf within 5e-5 of its max."""
    jcfg, tcfg, jp, tp = _mixer()
    b, s = 1, 512
    x = _x(5, b, s, tcfg.d_model)
    w = _x(6, b, s, tcfg.d_model)
    jctx = JCtx(impl="xla")
    jgp, jgx = jax.jit(jax.grad(lambda p, x: (jmamba.apply_mamba(
        p, x, jctx, jcfg)[0] * w).sum(), argnums=(0, 1)))(jp, x)
    xt = _t(x).requires_grad_()
    out, _ = mamba.apply_mamba(tp, xt, Ctx(impl="torch"), tcfg)
    (out * _t(w)).sum().backward()
    grads = dict(jgp, x=jgx)
    named = dict(tp.named_parameters(), x=xt)
    for name, g in grads.items():
        g = np.asarray(g)
        assert _err(named[name].grad, g) <= GRAD_TOL * float(np.abs(g).max()), name
    tp.zero_grad(set_to_none=True)


@pytest.mark.parametrize("num_layers", [2, 3])
def test_lm_forward_matches_jax(num_layers):
    jcfg, tcfg, params, tparams = _model(num_layers)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 40)
                                               ).astype(np.int32)
    jlog, _, _ = jax.jit(lambda p, t: jlm.forward(
        jcfg, p, JCtx(impl="xla"), tokens=t))(params, tokens)
    for impl in ("torch", "kernel"):
        with torch.no_grad():
            tlog, caches, metrics = tlm.forward(tcfg, tparams, Ctx(impl=impl),
                                                tokens=_t(tokens))
        assert caches is None and metrics == {}
        assert _err(tlog, jlog) < LOGIT_TOL, impl
