"""The port's training slice against the JAX package, on the CPU.

Both frameworks start from one state: the JAX params (and AdamW state) are
carried over by ``models/convert.py``; batches come from each package's own
``make_batch``, which must agree bit for bit. JAX runs ``impl="xla"``; the
port runs ``impl="kernel"`` (the kernels' plain versions on CPU tensors) and
``impl="torch"``. Tolerances: loss 1e-5 relative and each gradient leaf
1e-4 of that leaf's max |g| (both compute in f32, with sums ordered
differently over two layers); the 5-step trajectory 1e-4; AdamW alone and
the cross-entropy 1e-6.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import make_batch as j_make_batch  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.runtime.steps import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import (_named_arrays, convert_opt_state,  # noqa: E402
                                        convert_params)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.runtime.steps import (make_train_step, place_batch,  # noqa: E402
                                       step_seed)
from repro_torch.runtime.trainer import (StragglerMonitor, Trainer,  # noqa: E402
                                         TrainerConfig)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 48


def _cfgs(arch, **over):
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype=jnp.float32,
                               **over)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32,
                               **over)
    return jcfg, tcfg


def _leaf_err(g, jg):
    """max |g - jg| over max |jg| (1 where the leaf is all zeros)."""
    jg = np.asarray(jg, np.float32)
    scale = max(float(np.abs(jg).max()), 1e-30)
    return float(np.abs(g.detach().float().numpy() - jg).max()) / scale


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_softmax_cross_entropy_matches_jax():
    r = np.random.default_rng(0)
    logits = r.standard_normal((3, 7, 40)).astype(np.float32) * 3
    labels = r.integers(0, 33, (3, 7)).astype(np.int32)
    weights = (r.random((3, 7)) > 0.3).astype(np.float32)
    for w in (None, weights):
        jce = jlayers.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels), 33,
            weights=None if w is None else jnp.asarray(w))
        tce = tlayers.softmax_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels), 33,
            weights=None if w is None else torch.from_numpy(w))
        assert abs(float(tce) - float(jce)) <= 1e-6 * abs(float(jce))


def _batch(cfg, seed, pack=False):
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                    seed=seed, pack=pack, min_seg_len=5, max_seg_len=20)
    return make_batch(dc, 0)


@pytest.mark.parametrize("arch,impl,pack,dropout", [
    ("granite_3_2b", "kernel", False, 0.0),
    ("qwen3_14b", "kernel", False, 0.0),
    ("granite_3_2b", "kernel", True, 0.0),
    ("granite_3_2b", "kernel", False, 0.1),
    ("granite_3_2b", "torch", True, 0.0),
    ("qwen3_14b", "torch", False, 0.1),
    ("recurrentgemma_2b", "kernel", False, 0.0),
    ("recurrentgemma_2b", "kernel", False, 0.1),
    ("recurrentgemma_2b", "torch", False, 0.1),
])
def test_loss_and_grads_match_jax(arch, impl, pack, dropout):
    _, tcfg = _cfgs(arch, dropout_rate=dropout)
    jparams, batch, seed, jl, jg = _jax_loss_and_grads(arch, pack, dropout)
    model = convert_params(tcfg, jparams, device="cpu")
    ctx = tlayers.Ctx(impl=impl, deterministic=dropout == 0.0, seed=seed,
                      torch_chunk=16)
    loss, metrics = tlm.loss_fn(tcfg, model, place_batch(batch, "cpu"), ctx)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - jl) <= LOSS_RTOL * abs(jl)
    assert float(metrics["ce"].detach()) == loss
    jnamed = _named_arrays(tcfg, jg, model)
    for name, p in model.named_parameters():
        assert _leaf_err(p.grad, jnamed[name]) <= GRAD_TOL, name


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, pack, dropout):
    """(params, batch, seed, loss, grads) of JAX ``loss_fn`` (impl="xla"),
    compiled once; params and grads as numpy pytrees."""
    jcfg, tcfg = _cfgs(arch, dropout_rate=dropout)
    jparams, _ = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    batch = _batch(tcfg, 11, pack)
    seed = step_seed(7)

    def jloss(p, b):
        ctx = jlayers.Ctx(impl="xla", deterministic=dropout == 0.0,
                          seed=jnp.int32(seed), xla_chunk=16)
        return jlm.loss_fn(jcfg, p, b, ctx)
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return _np(jparams), batch, seed, float(jl), _np(jg)


def test_remat_gives_the_same_grads():
    """Checkpointing each layer changes what autograd keeps, not the math."""
    _, tcfg = _cfgs("granite_3_2b", dropout_rate=0.1)
    batch = place_batch(_batch(tcfg, 2, pack=True), "cpu")
    grads = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        model = tlm.init_params(cfg, seed=1, device="cpu")
        ctx = tlayers.Ctx(impl="kernel", deterministic=False, seed=-12345)
        tlm.loss_fn(cfg, model, batch, ctx)[0].backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("keep_master,dtype", [(True, np.float32),
                                               (False, np.float32),
                                               (True, "bfloat16")])
def test_adamw_matches_jax(keep_master, dtype):
    r = np.random.default_rng(5)
    shapes = {"a": (6, 5), "b": (7,), "c": (3, 2, 4)}
    init = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = {k: jnp.asarray(v, jdtype) for k, v in init.items()}
    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(
            torch.from_numpy(np.array(jp[k], np.float32)).to(tdtype)))
    jopt = JAdamWConfig(lr=1e-2, grad_clip=0.5, keep_master=keep_master)
    topt = AdamWConfig(lr=1e-2, grad_clip=0.5, keep_master=keep_master)
    jstate, tstate = j_adamw_init(jp, jopt), adamw_init(module, topt)
    for _ in range(3):
        g = {k: (r.standard_normal(s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        jp, jstate, jm = j_adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                        jstate, jp, jopt)
        _, tstate, tm = adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                                     tstate, module, topt)
        assert float(jm["grad_norm"]) > 0.5                 # clipping is active
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
    assert tstate.step == int(jstate.step) == 3
    for k, p in module.named_parameters():
        assert p.dtype == tdtype
        tol = 1e-6 if dtype == np.float32 else 2.0 ** -8   # one bf16 ulp
        assert _leaf_err(p.data, np.asarray(jp[k], np.float32)) <= tol
        assert _leaf_err(tstate.m[k], jstate.m[k]) <= 1e-6
        assert _leaf_err(tstate.v[k], jstate.v[k]) <= 1e-6
        if keep_master:
            assert _leaf_err(tstate.master[k], jstate.master[k]) <= 1e-6


@pytest.mark.parametrize("pack", [False, True])
def test_make_batch_is_bit_identical_to_jax(pack):
    kw = dict(vocab_size=251, seq_len=70, global_batch=3, seed=4, pack=pack)
    for step in range(3):
        jb = j_make_batch(JDataConfig(**kw), step)
        tb = make_batch(DataConfig(**kw), step)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k])


def test_step_seed_matches_jax():
    for step in (0, 1, 2, 7, 12345, 2**31 - 1):
        want = int((jnp.int32(step).astype(jnp.uint32) * jnp.uint32(2654435761)
                    ).astype(jnp.int32))
        assert step_seed(step) == want


@pytest.mark.parametrize("microbatch,dropout", [(None, 0.0), (2, 0.1)])
def test_five_step_trajectory_matches_jax(microbatch, dropout):
    _five_steps("granite_3_2b", microbatch, dropout)


def test_hybrid_five_step_trajectory_matches_jax():
    """recurrentgemma-2b SMOKE (rec, rec, attn; window 32 over the 32 tokens
    of a row), as granite's first case. With dropout 0.1 AdamW's per-element
    normalisation lifts f32 noise in near-zero gradient elements of
    ``embed`` to O(lr) updates: JAX against itself (``xla_chunk`` 8 vs 16)
    ends 1.0e-3 of the leaf's max apart after five steps, so a 1e-4 bound
    on the parameters holds no implementation to anything there; the
    hybrid's dropout gradients are held per step by
    ``test_loss_and_grads_match_jax``."""
    _five_steps("recurrentgemma_2b", None, 0.0)


def _five_steps(arch, microbatch, dropout):
    """Five ``make_train_step`` steps of JAX (impl "xla") and the port
    (impl "kernel") from one converted state on packed batches: loss each
    step, lr, and every parameter at the end within 1e-4."""
    jcfg, tcfg = _cfgs(arch, dropout_rate=dropout)
    kw = dict(total_steps=5, warmup_steps=2, microbatch=microbatch)
    jarts = j_make_train_step(jcfg, opt=JAdamWConfig(lr=1e-3), impl="xla",
                              xla_chunk=16, donate=False, **kw)
    jparams, jopt, _ = jarts.init_fn(jax.random.PRNGKey(1))
    tarts = make_train_step(tcfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                            torch_chunk=16, device="cpu", **kw)
    params = convert_params(tcfg, _np(jparams), device="cpu")
    opt = convert_opt_state(tcfg, _np(jopt), params, device="cpu")
    dc = DataConfig(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=4,
                    seed=2, pack=True, min_seg_len=6, max_seg_len=24)
    for step in range(5):
        batch = make_batch(dc, step)
        jparams, jopt, jm = jarts.step_fn(
            jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.int32(step))
        params, opt, tm = tarts.step_fn(params, opt, place_batch(batch, "cpu"),
                                        step)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-4 * abs(float(jm["loss"]))
        assert abs(tm["lr"] - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
    jnamed = _named_arrays(tcfg, _np(jparams), params)
    for name, p in params.named_parameters():
        assert _leaf_err(p.data, jnamed[name]) <= 1e-4, name
    assert opt.step == int(jopt.step) == 5


# ---------------------------------------------------------------------------
# checkpoints and the trainer
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "h": torch.linspace(-3, 3, 9).to(torch.bfloat16)},
            "n": 7}


def _zeros_like(tree):
    return {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5, dtype=torch.int32),
                                          "h": torch.zeros(9, dtype=torch.bfloat16)},
            "n": 0}


def test_checkpoint_roundtrip_with_bf16_leaf(tmp_path):
    import json
    tree = _tree()
    tckpt.save(str(tmp_path), 7, tree)
    assert tckpt.latest_step(str(tmp_path)) == 7
    meta = json.loads((tmp_path / "step_00000007" / "metadata.json").read_text())
    assert meta["dtypes"]["b/h"] == "bfloat16" and meta["step"] == 7
    assert sorted(meta) == ["digest", "dtypes", "keys", "shapes", "step"]
    like = _zeros_like(tree)
    out = tckpt.restore(str(tmp_path), 7, like)
    assert out["b"]["h"] is like["b"]["h"]               # restored in place
    assert torch.equal(out["a"], tree["a"]) and out["n"] == 7
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["h"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["h"], tree["b"]["h"])


def test_checkpoint_async_snapshot_and_keep_ring(tmp_path):
    tree = _tree()
    for step in range(5):
        t = tckpt.save_async(str(tmp_path), step, tree, keep=2)
        tree["a"].add_(1.0)                # in-place update after the snapshot
        t.join()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    out = tckpt.restore(str(tmp_path), 4, _zeros_like(tree))
    assert torch.equal(out["a"], torch.arange(12.0).reshape(3, 4) + 4)


def test_checkpoint_ignores_partial_tmp(tmp_path):
    tckpt.save(str(tmp_path), 3, {"w": torch.ones(4)})
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert tckpt.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_damaged_checkpoint_raises_corrupt(tmp_path, damage):
    tree = {"a": torch.arange(64.0), "b": torch.ones(8, 8)}
    tckpt.save(str(tmp_path), 2, tree)
    arrays = tmp_path / "step_00000002" / "arrays.npz"
    blob = bytearray(arrays.read_bytes())
    if damage == "truncate":
        blob = blob[:len(blob) // 2]
    else:
        blob[len(blob) // 2] ^= 0xFF
    arrays.write_bytes(bytes(blob))
    with pytest.raises(tckpt.CorruptCheckpointError, match="integrity"):
        tckpt.restore(str(tmp_path), 2, {"a": torch.zeros(64),
                                         "b": torch.zeros(8, 8)})


def _trainer(path, ckpt_every=100, arch="granite_3_2b", num_layers=1):
    _, tcfg = _cfgs(arch, dropout_rate=0.1)
    tcfg = dataclasses.replace(tcfg, num_layers=num_layers)
    arts = make_train_step(tcfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                           torch_chunk=16, device="cpu")
    dc = DataConfig(vocab_size=tcfg.vocab_size, seq_len=24, global_batch=2, seed=1)
    return Trainer(arts=arts, data_cfg=dc,
                   tcfg=TrainerConfig(ckpt_dir=str(path), ckpt_every=ckpt_every,
                                      log_every=1000))


def test_trainer_resume_after_preemption_is_identical(tmp_path):
    """6 steps straight ≡ 3 steps, a preemption, then 3 more from the
    checkpoint: identical losses and parameters."""
    _preempt_and_resume(tmp_path, functools.partial(_trainer))


def test_trainer_without_final_ckpt_writes_only_its_cadence(tmp_path):
    """``final_ckpt=False``: a run to its last step commits the cadence's
    checkpoints and no final one; a preempted run still commits one."""
    t = _trainer(tmp_path, ckpt_every=2)
    t.tcfg = dataclasses.replace(t.tcfg, final_ckpt=False)
    assert t.run(3)["stop_step"] == 3
    assert tckpt.latest_step(str(tmp_path)) == 1
    t = _trainer(tmp_path, ckpt_every=100)
    t.tcfg = dataclasses.replace(t.tcfg, final_ckpt=False)
    t.hooks["pre_step"] = lambda s: s == 4 and t.request_preemption()
    assert t.run(6)["preempted"]
    assert tckpt.latest_step(str(tmp_path)) == 4


def test_hybrid_trainer_resume_after_preemption_is_identical(tmp_path):
    """The same for recurrentgemma-2b SMOKE (rec, rec, attn), its RG-LRU
    leaves (lambda f32) and their AdamW state restored in place."""
    _preempt_and_resume(tmp_path, functools.partial(
        _trainer, arch="recurrentgemma_2b", num_layers=3))


def _preempt_and_resume(tmp_path, trainer):
    t1 = trainer(tmp_path / "a")
    r1 = t1.run(6)
    t2 = trainer(tmp_path / "b")
    t2.hooks["pre_step"] = lambda step: (t2.request_preemption()
                                         if step == 2 else None)
    r2 = t2.run(6)
    assert r2["preempted"] and r2["stop_step"] == 3
    assert tckpt.latest_step(str(tmp_path / "b")) == 2
    t3 = trainer(tmp_path / "b")
    r3 = t3.run(6)
    assert r3["stop_step"] == 6 and not r3["preempted"]
    resumed = t2.metrics_log + t3.metrics_log
    assert [m["step"] for m in resumed] == list(range(6))
    assert [m["loss"] for m in resumed] == [m["loss"] for m in t1.metrics_log]
    for a, b in zip(r1["params"].parameters(), r3["params"].parameters()):
        assert torch.equal(a, b)
    assert r1["opt"].step == r3["opt"].step == 6


@pytest.mark.parametrize("arch", ["granite_3_2b", "recurrentgemma_2b"])
def test_trainer_resumes_a_jax_checkpoint(tmp_path, arch):
    """The JAX ``Trainer`` takes two steps and checkpoints (its layout:
    stacked superblocks, ``opt/.m/...``); the port's ``Trainer`` resumes
    that checkpoint and takes the third step, which JAX's ``Trainer`` takes
    too from a copy of the directory: every parameter within 1e-6 of each
    leaf's max, the loss within ``LOSS_RTOL``. Without dropout (see
    ``test_hybrid_five_step_trajectory_matches_jax``)."""
    import shutil

    from repro.runtime.trainer import Trainer as JTrainer
    from repro.runtime.trainer import TrainerConfig as JTrainerConfig

    jcfg, tcfg = _cfgs(arch)
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
    assert [m["step"] for m in t.metrics_log] == [2] == [m["step"] for m in jt.metrics_log]
    jl = jt.metrics_log[0]["loss"]
    assert abs(t.metrics_log[0]["loss"] - jl) <= LOSS_RTOL * abs(jl)
    assert r["opt"].step == 3
    jnamed = _named_arrays(tcfg, jparams, r["params"])
    for name, p in r["params"].named_parameters():
        assert _leaf_err(p.data, jnamed[name]) <= 1e-6, name
    # the port's own checkpoint of step 2 now resumes in its own layout
    assert tckpt.latest_step(str(tmp_path / "port")) == 2
    assert not tckpt.is_jax_layout(str(tmp_path / "port"), 2)


def test_from_jax_keeps_the_master_copy_the_optimizer_keeps():
    """``from_jax`` drops a JAX master copy that the port's optimizer does
    not keep (f32 params: the params themselves) and refuses a checkpoint
    without one for an optimizer that keeps one."""
    jcfg, tcfg = _cfgs("recurrentgemma_2b")
    jparams, _ = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tree = {"params": _np(jparams)}
    for keep in (True, False):
        jopt = _np(j_adamw_init(jparams, JAdamWConfig(keep_master=keep)))
        tree["opt"] = {k: v for k, v in jopt._asdict().items() if v is not None}
        for port_keep in (True, False):
            arts = make_train_step(tcfg, opt=AdamWConfig(keep_master=port_keep),
                                   device="cpu")
            if port_keep and not keep:
                with pytest.raises(ValueError, match="no f32 master copy"):
                    arts.from_jax(tree)
                continue
            params, opt = arts.from_jax(tree)
            assert (opt.master is not None) == port_keep and opt.step == 0
            jnamed = _named_arrays(tcfg, tree["params"], params)
            for name, p in params.named_parameters():
                assert np.array_equal(p.detach().numpy(), jnamed[name]), name


def test_read_tree_of_a_jax_checkpoint(tmp_path):
    """A tree saved by the JAX package's ``ckpt.save`` (a NamedTuple, a
    bf16 leaf, which numpy stores as raw 2-byte records) reads back as
    nested numpy: the NamedTuple's fields without their dot, bf16 as its
    exact f32 values."""
    from repro.checkpoint import ckpt as jckpt
    from repro.optim.adamw import AdamWState as JAdamWState

    r = np.random.default_rng(2)
    w = r.standard_normal((3, 5)).astype(np.float32)
    h = jnp.asarray(r.standard_normal(7), jnp.bfloat16)
    tree = {"params": {"w": jnp.asarray(w), "h": h},
            "opt": JAdamWState(step=jnp.int32(4), m={"w": jnp.asarray(w * 2)},
                               v={"w": jnp.asarray(w * w)}, master=None),
            "step": jnp.int32(3)}
    jckpt.save(str(tmp_path), 3, tree)
    assert tckpt.is_jax_layout(str(tmp_path), 3)
    out = tckpt.read_tree(str(tmp_path), 3)
    assert sorted(out) == ["opt", "params", "step"]
    assert sorted(out["opt"]) == ["m", "step", "v"]
    assert int(out["opt"]["step"]) == 4 and int(out["step"]) == 3
    assert np.array_equal(out["opt"]["m"]["w"], w * 2)
    assert np.array_equal(out["params"]["w"], w)
    assert out["params"]["h"].dtype == np.float32
    assert np.array_equal(out["params"]["h"], np.asarray(h, np.float32))


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=3.0)
    for i in range(10):
        mon.observe(i, 0.1)
    assert not mon.flagged
    mon.observe(10, 0.5)                 # 5× the median
    assert len(mon.flagged) == 1 and mon.flagged[0][0] == 10


def test_train_launcher_runs_on_cpu(tmp_path, capsys):
    res = ttrain.main(["--arch", "granite_3_2b", "--smoke", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "32",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert res["stop_step"] == 3 and not res["preempted"]
    assert tckpt.latest_step(str(tmp_path)) == 2
    assert "done at step 3" in capsys.readouterr().out


def test_train_launcher_runs_the_hybrid_on_cpu(tmp_path, capsys):
    """recurrentgemma-2b SMOKE through the launcher; f32 params take no
    f32 master copy (as at full size on the card), bf16 ones do."""
    res = ttrain.main(["--arch", "recurrentgemma_2b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "48",
                       "--ckpt-dir", str(tmp_path / "f32")])
    assert res["stop_step"] == 2 and not res["preempted"]
    assert res["opt"].master is None and res["opt"].step == 2
    assert [b.kind for b in res["params"].blocks] == ["rec", "rec", "attn"]
    assert "done at step 2" in capsys.readouterr().out
    res = ttrain.main(["--arch", "recurrentgemma_2b", "--smoke", "--device", "cpu",
                       "--steps", "1", "--batch", "2", "--seq", "48", "--dtype",
                       "bfloat16", "--ckpt-dir", str(tmp_path / "bf16")])
    assert res["opt"].master is not None
