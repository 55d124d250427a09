"""Training over a mesh of ranks against the JAX package, on the CPU.

The ranks are gloo processes on the CPU (``launch.mesh.run_ranks``), spawned
once for the four-rank meshes ``(2, 2)`` and ``(4,)`` and once for the
two-rank ``(1, 2)``; a rank imports this module and runs the jobs it is
handed. Every job starts from one JAX state (``init_params`` with the
mesh's vocab padding and ``adamw_init``), carried over by
``TrainArtifacts.from_jax``, and takes packed batches whose weights differ
between the data-parallel ranks, with dropout 0.1.

References and tolerances:
* JAX's single-device step (``impl="xla"``; its microbatches as its scan
  takes them): the loss 1e-5 relative, every gathered gradient leaf 1e-4 of
  its max |g|, a 5-step trajectory 1e-4 (``tests/test_torch_train.py``'s);
* the port's single-device step on the same state: the loss 1e-5 relative,
  every gradient leaf 1e-5 of its max |g|, and the parameters after the
  step 1e-5 absolute against the single-device AdamW update applied to the
  mesh's gathered gradients (the sharded update, its global norm included).
  Held against the single-device *step* instead, the parameters after one
  AdamW step are no measure at 1e-5: the update is ``lr · g / (|g| +
  eps)``, and a gradient element near eps moves it by up to ``lr`` with its
  f32 rounding. Two single-device runs of the port that differ only in the
  order of their sums (the kernel's plain version and ``impl="torch"``)
  end one step apart by 5.4e-5 in JAX's own sharded-step setting
  (``tests/test_distributed.py``: 2 layers, d 32, lr 1e-2, no dropout) and
  by 7.6e-5 on hubert-xlarge SMOKE at lr 1e-3 (``blocks.1.mlp.wi[25, 76]``,
  |g| 1.6e-9 against 2.7e-9); JAX's test passes on JAX because XLA rounds
  its sharded and unsharded programs alike. That setting runs here too
  (``tiny_*``). The parameters are also held against the single-device
  step itself at 0.1 lr, a limit set above the readings (7.6e-5 at lr
  1e-3 above; the mesh against one device 1.7e-4 at lr 1e-2 on
  ``tiny_4``);
* the elastic resume ``(2, 2)`` → ``(1, 2)`` against an uninterrupted
  single-device run: 5e-5 absolute (JAX's).

The MoE cases replay the port's single-device routes on the mesh
(``moe_routes.RouteRecorder``, each rank its share of the tokens), so
logits and gradients are compared where routed alike; a forward without
replay counts the choices that differ from the single-device run's, at
most ``MOE_FLIP_TOL`` of them (``chip_smoke.py``'s).
"""

import dataclasses
import functools
import os
import pickle
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import compression as jcompression  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.runtime.steps import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import DataConfig, PrefetchLoader, make_batch  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed.mesh import TrainMesh, join_train_mesh  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed.parallel import NamedSharding  # noqa: E402
from repro_torch.distributed.sharding import vocab_pad_for  # noqa: E402
from repro_torch.kernels import flash_bwd as tbwd  # noqa: E402
from repro_torch.kernels import flash_fwd as tfwd  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe_routes  # noqa: E402
from repro_torch.models.convert import _named_arrays  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.runtime.steps import (make_train_step, place_batch,  # noqa: E402
                                       step_seed)
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # against JAX
MESH_GRAD_TOL = 1e-5     # against the port on one device
PARAM_TOL = 1e-5         # JAX's sharded-step test
STEP_PARAM_REL_LR = 0.1  # the mesh's params after a step against the port's
                         # single-device step: 0.1 lr (an element's update
                         # moves by up to lr; see above)
ELASTIC_TOL = 5e-5       # JAX's elastic-resume test
TRAJ_TOL = 1e-4
MOE_FLIP_TOL = 1e-3      # routing choices that differ from one device's
B, S = 4, 32
MESH_2X2 = {"data": 2, "model": 2}

# name: (arch, config overrides, mesh, microbatch, steps)
CASES = {
    "tp_dp": ("granite_3_2b", {}, {"data": 2, "model": 2}, None, 5),
    "microbatch": ("granite_3_2b", {}, {"data": 2, "model": 2}, 2, 1),
    "fsdp": ("granite_3_2b", {"fsdp": True}, {"data": 2, "model": 2}, None, 1),
    "fsdp_profile": ("granite_3_2b", {"fsdp": True, "sharding_profile": "fsdp"},
                     {"data": 2, "model": 2}, None, 1),
    # kv heads 2 on model 4 (replicated, a kv head read by two ranks' q
    # heads), vocab 251 padded to 252
    "kv_replicated": ("granite_3_2b", {}, {"model": 4}, None, 1),
    "qk_norm": ("qwen3_14b", {}, {"model": 4}, None, 1),
    "vlm": ("llava_next_34b", {}, {"data": 2, "model": 2}, None, 1),
    "encoder": ("hubert_xlarge", {}, {"data": 1, "model": 2}, None, 1),
    "vocab_251": ("granite_3_2b", {}, {"data": 1, "model": 2}, 2, 1),
    # heads 2 (1 a rank), kv 1 replicated; rnn 64 split; the RG-LRU's and
    # attention's mixer.wo under other specs
    "hybrid": ("recurrentgemma_2b", {}, MESH_2X2, None, 1),
    # heads 2 on model 4: seq_full, every head on a rank's 8 query rows;
    # rnn still split
    "hybrid_model4": ("recurrentgemma_2b", {}, {"model": 4}, None, 1),
    # a dense seq_full case: 6 q heads over 2 kv heads on model 4, qk-norm
    "dense_ctx": ("qwen3_14b", {"num_heads": 6, "num_kv_heads": 2,
                                "head_dim": 16}, {"model": 4}, None, 1),
    # S 30 on model 4: seq falls back, the residual stream replicated
    "seq_fallback": ("granite_3_2b", {}, {"model": 4}, None, 1),
    # 8 experts, 4 a rank; shared experts tensor-parallel; 2 groups, one a
    # data rank
    "moe": ("deepseek_moe_16b", {}, MESH_2X2, None, 1),
    # one group of B·S tokens spanning the data ranks
    "moe_one_group": ("deepseek_moe_16b", {"moe": {"group_size": B * S}},
                      MESH_2X2, None, 1),
    # the experts' embed dim over data, gathered; kv heads 2
    "moe_fsdp": ("dbrx_132b", {"fsdp": True}, MESH_2X2, None, 1),
    # no tensor or expert parallelism: batch and groups over (data, model),
    # 4 groups of 32 over 4 ranks
    "moe_fsdp_profile": ("deepseek_moe_16b",
                         {"fsdp": True, "sharding_profile": "fsdp",
                          "moe": {"group_size": 32}}, MESH_2X2, None, 1),
    # in_proj's [x | z] split half by half, w_bc / w_dt1 rows, w_dt2 columns
    "ssm": ("falcon_mamba_7b", {}, MESH_2X2, None, 1),
}
MOE_CASES = [n for n, c in CASES.items() if c[0] in ("deepseek_moe_16b",
                                                      "dbrx_132b")]
#: a case's sequence length where it is not S
CASE_SEQ = {"seq_fallback": 30}
#: each case's rows a rank runs (JAX's layout): its residual stream's
#: between blocks, and attention's query rows (None: no attention)
LAYOUT = {"tp_dp": (16, 32), "microbatch": (16, 32), "fsdp": (32, 32),
          "fsdp_profile": (32, 32), "kv_replicated": (8, 32),
          "qk_norm": (8, 32), "vlm": (16, 32), "encoder": (16, 32),
          "vocab_251": (16, 32), "hybrid": (16, 32), "hybrid_model4": (8, 8),
          "dense_ctx": (8, 8), "seq_fallback": (30, 30), "moe": (16, 32),
          "moe_one_group": (16, 32), "moe_fsdp": (16, 32),
          "moe_fsdp_profile": (32, 32), "ssm": (16, None),
          "tiny_2x2": (16, 32), "tiny_4": (8, 32), "tiny_1x2": (16, 32)}
# JAX's sharded-step test's setting (tests/test_distributed.py tiny_cfg)
TINY = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
            vocab_size=64)
TINY_MESHES = {"tiny_2x2": {"data": 2, "model": 2}, "tiny_4": {"model": 4},
               "tiny_1x2": {"data": 1, "model": 2}}


def _size(shape):
    return int(np.prod(list(shape.values())))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, over, dropout=0.1):
    """(JAX's, the port's) SMOKE config of ``arch`` in f32 with ``over``
    (``over["moe"]``: fields of the MoE config)."""
    over = dict(over, dropout_rate=dropout)
    moe = over.pop("moe", None)

    def cfg(c, dtype):
        if moe is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
        return dataclasses.replace(c, dtype=dtype, **over)
    return (cfg(jconfigs.smoke_config(arch), jnp.float32),
            cfg(tconfigs.smoke_config(arch), torch.float32))


def _data(cfg, tiny=False, name=None):
    if tiny:
        return dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    pack = cfg.frontend is None
    return dict(vocab_size=cfg.vocab_size, seq_len=CASE_SEQ.get(name, S),
                global_batch=B, seed=2, pack=pack, min_seg_len=5,
                max_seg_len=20, frontend=cfg.frontend)


def _case(name):
    """(arch, overrides, mesh, microbatch, steps, dropout, lr, tiny)."""
    if name in TINY_MESHES:
        return ("granite_3_2b", TINY, TINY_MESHES[name], None, 1, 0.0, 1e-2, True)
    arch, over, shape, mb, steps = CASES[name]
    return arch, over, shape, mb, steps, 0.1, 1e-3, False


@functools.lru_cache(maxsize=None)
def _jax_state(name):
    """The JAX state of a case: params with the mesh's vocab padding and
    ``adamw_init``, as numpy trees (``{"params", "opt"}``, read_tree's)."""
    arch, over, shape, _, _, dropout, lr, _ = _case(name)
    jcfg, _ = _cfgs(arch, over, dropout)
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(3),
                                vocab_pad_to=shape.get("model", 1))
    opt = j_adamw_init(params, JAdamWConfig(lr=lr))
    return {"params": _np(params),
            "opt": {"step": np.asarray(opt.step), "m": _np(opt.m),
                    "v": _np(opt.v), "master": _np(opt.master)}}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """JAX's single-device run of a case: step-0 (loss, grads) as its step
    computes them, the losses of every step, the params at the end (of a
    run of more than one step)."""
    arch, over, shape, mb, steps, dropout, lr, tiny = _case(name)
    jcfg, tcfg = _cfgs(arch, over, dropout)
    state = _jax_state(name)
    params = jax.tree.map(jnp.asarray, state["params"])
    dc = DataConfig(**_data(tcfg, tiny, name))
    batch = {k: jnp.asarray(v) for k, v in make_batch(dc, 0).items()}
    seed = jnp.int32(step_seed(0))

    def loss_of(p, b):
        ctx = jlayers.Ctx(impl="xla", deterministic=dropout == 0.0, seed=seed,
                          xla_chunk=16)
        return jlm.loss_fn(jcfg, p, b, ctx)[0]
    vg = jax.jit(jax.value_and_grad(loss_of))
    rows = batch["labels"].shape[0] if mb is None else mb
    n = batch["labels"].shape[0] // rows
    parts = [vg(params, {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()})
             for i in range(n)]
    loss0 = sum(float(p[0]) for p in parts) / n
    grads = jax.tree.map(lambda *g: sum(g) / n, *[p[1] for p in parts])
    if steps == 1:           # the step's loss is loss0
        return loss0, _np(grads), [loss0], None
    arts = j_make_train_step(jcfg, opt=JAdamWConfig(lr=lr), impl="xla",
                             xla_chunk=16, donate=False, microbatch=mb,
                             total_steps=5, warmup_steps=2)
    opt = j_adamw_init(params, JAdamWConfig(lr=lr))
    losses = []
    for step in range(steps):
        b = {k: jnp.asarray(v) for k, v in make_batch(dc, step).items()}
        params, opt, m = arts.step_fn(params, opt, b, jnp.int32(step))
        losses.append(float(m["loss"]))
    return loss0, _np(grads), losses, _np(params)


def _port_arts(name, mesh=None):
    arch, over, _, mb, _, dropout, lr, _ = _case(name)
    _, tcfg = _cfgs(arch, over, dropout)
    return tcfg, make_train_step(tcfg, mesh=mesh, opt=AdamWConfig(lr=lr),
                                 impl="kernel", total_steps=5, warmup_steps=2,
                                 microbatch=mb, torch_chunk=16, device="cpu")


@functools.lru_cache(maxsize=None)
def _port_run(name):
    """The port's single-device run of a case on JAX's state: step-0 (loss,
    grads by name), every step's loss, the params after the first step, and
    the MoE router's choices of every call (None for other archs)."""
    _, _, _, _, steps, _, _, tiny = _case(name)
    tcfg, arts = _port_arts(name)
    params, opt = arts.from_jax(_jax_state(name))
    dc = DataConfig(**_data(tcfg, tiny, name))
    with moe_routes.RouteRecorder() as rec:
        loss0, _, grads = arts.grad_fn(params, place_batch(make_batch(dc, 0), "cpu"), 0)
        grads = {n: g.numpy().copy() for n, g in grads.items()}
        losses, first = [], None
        for step in range(steps):
            params, opt, m = arts.step_fn(params, opt,
                                          place_batch(make_batch(dc, step), "cpu"), step)
            losses.append(float(m["loss"]))
            if first is None:
                first = {n: p.detach().numpy().copy() for n, p in params.named_parameters()}
    routes = [c.numpy() for c in rec.calls] if tcfg.moe is not None else None
    return float(loss0), grads, losses, first, routes


# ---------------------------------------------------------------------------
# what a rank runs
# ---------------------------------------------------------------------------

def _gathered(arts, named):
    return {n: arts.shardings["params"][n].gather(t.detach()).numpy().copy()
            for n, t in named.items()}


def _route_flips(arts, params, batch, routes, part):
    """(choices that differ from the single-device ``routes``, choices) of
    a forward on the mesh without replay."""
    ctx = Ctx(impl="kernel", deterministic=False, seed=step_seed(0),
              torch_chunk=16, plan=arts.plan)
    with torch.no_grad(), moe_routes.RouteRecorder() as rec:
        tlm.loss_fn(arts.plan.cfg, params, batch, ctx)
    flips = decisions = 0
    i, n = part
    for got, ref in zip(rec.calls, routes):
        if got.shape[0] != ref.shape[0]:
            rows = ref.shape[0] // n
            ref = ref[i * rows:(i + 1) * rows]
        flips += int(moe_routes._missing(got, ref).sum())
        decisions += got.numel()
    return flips, decisions


def _step_job(mesh, name, state, routes=None):
    """A case on this rank's mesh: step-0 (loss, gathered grads), the losses,
    the gathered params after the first and the last step. With ``routes``
    (an MoE case's single-device choices): the choices of a forward without
    replay that differ from them, and the steps replaying them."""
    _, _, _, _, steps, _, _, tiny = _case(name)
    tcfg, arts = _port_arts(name, mesh)
    params, opt = arts.from_jax(state)
    dc = DataConfig(**_data(tcfg, tiny, name))
    sh = arts.shardings["batch"]
    out = {}
    rec = moe_routes.RouteRecorder()
    if routes is not None:
        routes = [torch.from_numpy(r) for r in routes]
        part = (mesh.index(arts.plan.batch), arts.plan.batch_ranks)
        out["flips"], out["decisions"] = _route_flips(
            arts, params, place_batch(make_batch(dc, 0), "cpu", sh), routes, part)
        rec = moe_routes.RouteRecorder(replay=routes, part=part)
    with rec:
        out.update(_steps(arts, params, opt, dc, sh, steps))
    out["replay_flips"], out["replay_decisions"] = rec.flips, rec.decisions
    return out


def _steps(arts, params, opt, dc, sh, steps):
    arts.plan.rows_log = []
    loss0, metrics, grads = arts.grad_fn(
        params, place_batch(make_batch(dc, 0), "cpu", sh), 0)
    rows = {what: sorted({n for w, n in arts.plan.rows_log if w == what})
            for what in ("residual", "query")}
    arts.plan.rows_log = None
    out = {"loss0": float(loss0), "grads": _gathered(arts, grads), "losses": [],
           "aux": {k: float(v) for k, v in metrics.items()}, "rows": rows}
    for step in range(steps):
        params, opt, m = arts.step_fn(
            params, opt, place_batch(make_batch(dc, step), "cpu", sh), step)
        out["losses"].append(float(m["loss"]))
        if step == 0:
            out["first"] = _gathered(arts, dict(params.named_parameters()))
    out["last"] = _gathered(arts, dict(params.named_parameters()))
    out["local_rows"] = int(place_batch(make_batch(dc, 0), "cpu", sh)["labels"].shape[0])
    return out


#: the elastic resume of each family: arch → (steps on (2, 2), checkpoint
#: cadence, steps in all after the resume on (1, 2))
ELASTIC_FAMILIES = {"recurrentgemma_2b": (4, 2, 6), "falcon_mamba_7b": (4, 2, 6)}


def _elastic_cfg(arch=None):
    """JAX's elastic test's config (granite-3-2b at ``TINY``), or the
    SMOKE config of ``arch``, in f32."""
    if arch is None:
        return dataclasses.replace(tconfigs.smoke_config("granite_3_2b"),
                                   dtype=torch.float32, **TINY)
    return dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32)


def _elastic_job(mesh, ckpt_dir, steps, arch=None, every=3):
    """JAX's elastic test on the port: a Trainer on this mesh with
    ``batch_shardings=None`` (JAX's test passes None), checkpoints every
    ``every`` steps, up to ``steps``; returns the gathered params at the
    end."""
    cfg = _elastic_cfg(arch)
    arts = make_train_step(cfg, mesh=mesh, opt=AdamWConfig(lr=1e-3),
                           impl="kernel", torch_chunk=32, device="cpu")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    tr = Trainer(arts=arts, data_cfg=dc, batch_shardings=None,
                 tcfg=TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=every,
                                    log_every=1000))
    res = tr.run(steps)
    return {"stop": res["stop_step"], "losses": [m["loss"] for m in tr.metrics_log],
            "params": _gathered(arts, dict(res["params"].named_parameters()))}


def _resume_job(mesh, ckpt_dir, steps, arch):
    """A Trainer on this mesh resuming ``ckpt_dir`` up to ``steps``: its
    losses, or the name of the error it raised."""
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32)
    arts = make_train_step(cfg, mesh=mesh, opt=AdamWConfig(lr=1e-3),
                           impl="kernel", torch_chunk=16, device="cpu")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=24, global_batch=2, seed=1)
    tr = Trainer(arts=arts, data_cfg=dc, batch_shardings=arts.shardings["batch"],
                 tcfg=TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=100,
                                    log_every=1000))
    try:
        tr.run(steps)
    except tckpt.CheckpointShapeError as e:
        return {"error": type(e).__name__, "msg": str(e)}
    return {"losses": [(m["step"], m["loss"]) for m in tr.metrics_log]}


def _quant_job(mesh, g, e, steps=20):
    """One ``quantize_psum`` of this rank's row (mean, new error), then JAX's
    error-feedback loop: ``steps`` reductions of the same gradient, each
    with the last one's error; (one step's mean, the mean of the steps)."""
    mine = torch.from_numpy(g[mesh.rank])
    out_g, out_e = compression.quantize_psum(mine, None,
                                             torch.from_numpy(e[mesh.rank]))
    err, acc = torch.zeros_like(mine), torch.zeros_like(mine)
    for _ in range(steps):
        mean, err = compression.quantize_psum(mine, None, err)
        acc += mean
    return out_g.numpy(), out_e.numpy(), mean.numpy(), (acc / steps).numpy()


def _reduce_scatter_job(mesh):
    """``collectives.reduce_scatter`` over ``model`` and over every axis on
    rank-dependent inputs: (its outputs, the gradients of its inputs under
    a rank-dependent upstream gradient)."""
    out = {}
    for entry in ("model", ("data", "model")):
        n = mesh.size(entry)
        x = (torch.arange(3 * 4 * n, dtype=torch.float32).view(3, 4 * n)
             * (mesh.rank + 1)).requires_grad_()
        y = C.reduce_scatter(x, 1, mesh, entry)
        g = torch.full_like(y, float(mesh.rank + 1)) + torch.arange(4.0)
        y.backward(g)
        out[entry] = (y.detach().numpy(), x.grad.numpy(), mesh.index(entry))
    return out


#: the dry run's cell against a real rank: granite SMOKE at 2 layers, f32,
#: one step of batch B x S
DRY_SHAPE = ("granite_3_2b", 2)


def _dry_cfg():
    arch, layers = DRY_SHAPE
    return dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32,
                               num_layers=layers)


def _held(params, grads, opt):
    """The bytes a rank holds by family (the dry run's ``held_bytes``)."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    held = {"params": nbytes(params.parameters()),
            "grads": nbytes(grads.values()),
            "optimizer": nbytes([*opt.m.values(), *opt.v.values(),
                                 *(opt.master or {}).values()])}
    held["total"] = sum(held.values())
    return held


def _dryrun_job(mesh):
    """One training step of ``_dry_cfg`` on this rank, as the launcher
    takes it (``make_train_step``'s state, ``place_batch``, ``step_fn``,
    ``impl="torch"``): every collective it logs, and the bytes it holds
    (the gradients those of ``grad_fn`` on the same state)."""
    cfg = _dry_cfg()
    opt_cfg = AdamWConfig()
    arts = make_train_step(cfg, mesh=mesh, impl="torch", opt=opt_cfg,
                           device="cpu")
    params, opt = arts.init_fn(0)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    batch = place_batch(make_batch(dc, 0), "cpu", arts.shardings["batch"])
    _, _, grads = arts.grad_fn(params, batch, 0)
    held = _held(params, grads, opt)
    C.log = []
    try:
        arts.step_fn(params, opt, batch, 0)
        log = C.log
    finally:
        C.log = None
    return {"log": log, "held": held}


def _rank_jobs(pool, device, shape, path):
    """Run the jobs pickled at ``path`` ((name, function name, args) each)
    on this rank's mesh, the host's cores shared out among the ranks."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _size(shape)))
    with open(path, "rb") as f:
        jobs = pickle.load(f)
    mesh = join_train_mesh(shape)
    out = {}
    for name, fn, args in jobs:
        res = globals()[fn](mesh, *args)
        out[name] = res if mesh.rank == 0 or fn != "_step_job" else {
            k: v for k, v in res.items() if k not in ("grads", "first", "last")}
    return out


def _run(shape, jobs, root):
    """Spawn the ranks of ``shape`` on ``jobs``, handed over in a file: a
    spawned rank reads its arguments from a pipe only once it has imported
    this module, so arguments of megabytes would start the ranks one at a
    time."""
    path = root / f"jobs_{_size(shape)}_{len(jobs)}.pkl"
    with open(path, "wb") as f:
        pickle.dump(jobs, f)
    return tmesh.run_ranks(_rank_jobs, _size(shape), (shape, str(path)),
                           backend="gloo", device_type="cpu", timeout_s=900)


# ---------------------------------------------------------------------------
# the two spawns
# ---------------------------------------------------------------------------

def _quant_inputs():
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 64, 64))) * 0.01
    return g.astype(np.float32), np.zeros((4, 64, 64), np.float32)


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_ckpt")


@pytest.fixture(scope="module")
def four(ckpt_root):
    """The four-rank jobs: ``(2, 2)`` and ``(4,)`` cases, the first half of
    the elastic run, int8 all-reduce steps."""
    by_mesh = {}
    for name in list(CASES) + list(TINY_MESHES):
        shape = _case(name)[2]
        if _size(shape) == 4:
            routes = _port_run(name)[4] if name in MOE_CASES else None
            by_mesh.setdefault(tuple(shape.items()), []).append(
                (name, "_step_job", (name, _jax_state(name), routes)))
    two_by_two = by_mesh[tuple(MESH_2X2.items())]
    two_by_two.append(("elastic", "_elastic_job", (str(ckpt_root / "elastic"), 6)))
    for arch, (steps, every, total) in ELASTIC_FAMILIES.items():
        two_by_two.append((f"elastic_{arch}", "_elastic_job",
                           (str(ckpt_root / f"elastic_{arch}"), steps, arch, every)))
        two_by_two.append((f"uninterrupted_{arch}", "_elastic_job",
                           (str(ckpt_root / f"uninterrupted_{arch}"), total, arch,
                            total)))
    two_by_two.append(("reduce_scatter", "_reduce_scatter_job", ()))
    two_by_two.append(("dryrun", "_dryrun_job", ()))
    g, e = _quant_inputs()
    by_mesh[(("model", 4),)].append(("quant", "_quant_job", (g, e)))
    out = {}
    for shape, jobs in by_mesh.items():
        res = _run(dict(shape), jobs, ckpt_root)
        for name in res[0]:
            out[name] = [r[name] for r in res]
    return out


@pytest.fixture(scope="module")
def two(four, ckpt_root):
    """The two-rank ``(1, 2)`` jobs: cases, the elastic resume, a JAX-written
    checkpoint resumed, a checkpoint of another vocab padding refused."""
    jobs = [(name, "_step_job", (name, _jax_state(name)))
            for name in list(CASES) + list(TINY_MESHES)
            if _size(_case(name)[2]) == 2]
    jobs.append(("elastic", "_elastic_job", (str(ckpt_root / "elastic"), 9)))
    for arch, (_, every, steps) in ELASTIC_FAMILIES.items():
        jobs.append((f"elastic_{arch}", "_elastic_job",
                     (str(ckpt_root / f"elastic_{arch}"), steps, arch, every)))
    jax_dir = ckpt_root / "jax"
    _jax_trainer(jax_dir, 2)
    jobs.append(("jax_resume", "_resume_job", (str(jax_dir), 4, "qwen3_14b")))
    for arch in JAX_RESUME_FAMILIES:
        _jax_family_losses(str(ckpt_root), arch)
        jobs.append((f"jax_resume_{arch}", "_resume_job",
                     (str(ckpt_root / f"jax_{arch}" / "port"), 4, arch)))
    port_dir = ckpt_root / "port251"
    _port_single_trainer(port_dir, 2)
    jobs.append(("pad_refused", "_resume_job", (str(port_dir), 4, "granite_3_2b")))
    res = _run({"data": 1, "model": 2}, jobs, ckpt_root)
    return {name: [r[name] for r in res] for name in res[0]}


#: the families whose JAX-written checkpoint resumes on (1, 2)
JAX_RESUME_FAMILIES = ("recurrentgemma_2b", "deepseek_moe_16b", "falcon_mamba_7b")


@functools.lru_cache(maxsize=None)
def _jax_family_losses(root, arch):
    """JAX's Trainer on ``arch`` SMOKE takes two steps and checkpoints into
    ``root/jax_<arch>``; a copy of the directory goes to ``.../port`` (for
    the port's Trainer on a mesh), then the same Trainer resumes for steps
    2 and 3: their losses."""
    import shutil
    path = os.path.join(root, f"jax_{arch}")
    tr = _jax_trainer(os.path.join(path, "jax"), 2, arch)
    shutil.copytree(os.path.join(path, "jax"), os.path.join(path, "port"))
    tr.run(4)
    return [m["loss"] for m in tr.metrics_log[2:]]


def _jax_trainer(path, steps, arch="qwen3_14b"):
    """JAX's Trainer (one device) on ``arch`` SMOKE (qwen3-14b's, and the
    families', vocab of 256 needs no padding on a model axis of 2)."""
    from repro.data import DataConfig as JDataConfig
    from repro.runtime.trainer import Trainer as JTrainer
    from repro.runtime.trainer import TrainerConfig as JTrainerConfig
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype=jnp.float32)
    arts = j_make_train_step(jcfg, opt=JAdamWConfig(lr=1e-3), impl="xla",
                             xla_chunk=16, donate=False)
    dc = JDataConfig(vocab_size=jcfg.vocab_size, seq_len=24, global_batch=2,
                     seed=1)
    tr = JTrainer(arts=arts, data_cfg=dc, tcfg=JTrainerConfig(
        ckpt_dir=str(path), ckpt_every=100, log_every=1000, async_ckpt=False))
    tr.run(steps)
    return tr


def _port_single_trainer(path, steps):
    """The port's Trainer on one device (vocab 251, unpadded)."""
    cfg = dataclasses.replace(tconfigs.smoke_config("granite_3_2b"),
                              dtype=torch.float32)
    arts = make_train_step(cfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                           torch_chunk=16, device="cpu")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=24, global_batch=2, seed=1)
    Trainer(arts=arts, data_cfg=dc, tcfg=TrainerConfig(
        ckpt_dir=str(path), ckpt_every=100, log_every=1000)).run(steps)


def _results(four, two, name):
    return (four if _size(_case(name)[2]) == 4 else two)[name]


def _leaf_err(a, b):
    b = np.asarray(b, np.float32)
    return float(np.abs(np.asarray(a) - b).max()) / max(float(np.abs(b).max()), 1e-30)


# ---------------------------------------------------------------------------
# the mesh step against JAX and against the port on one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES) + list(TINY_MESHES))
def test_mesh_step_matches_jax(four, two, name):
    res = _results(four, two, name)
    r0 = res[0]
    jl, jg, jlosses, _ = _jax_run(name)
    assert abs(r0["loss0"] - jl) <= LOSS_RTOL * abs(jl)
    for r in res:                               # the global loss on every rank
        assert r["losses"] == r0["losses"]
    _, tcfg = _cfgs(*_case(name)[:2])
    model = tlm.LM(tcfg, r0["grads"]["embed"].shape[0], device="meta")
    jnamed = _named_arrays(tcfg, jg, model)
    for n, g in r0["grads"].items():
        assert _leaf_err(g, jnamed[n]) <= GRAD_TOL, n
    for a, b in zip(r0["losses"], jlosses):
        assert abs(a - b) <= TRAJ_TOL * abs(b)


@pytest.mark.parametrize("name", list(CASES) + list(TINY_MESHES))
def test_mesh_step_matches_the_port_on_one_device(four, two, name):
    """The loss and every gradient leaf against the port's single-device
    step, and the parameters after the step against the single-device
    AdamW update of the mesh's gathered gradients and against the
    single-device step."""
    r0 = _results(four, two, name)[0]
    loss0, grads, losses, first, _ = _port_run(name)
    assert abs(r0["loss0"] - loss0) <= LOSS_RTOL * abs(loss0)
    assert abs(r0["losses"][0] - losses[0]) <= LOSS_RTOL * abs(losses[0])
    for n, g in grads.items():
        assert _leaf_err(r0["grads"][n], g) <= MESH_GRAD_TOL, n
    lr = _case(name)[6]
    _, arts = _port_arts(name)
    params, opt = arts.from_jax(_jax_state(name))
    adamw_update({n: torch.from_numpy(g.copy()) for n, g in r0["grads"].items()},
                 opt, params, AdamWConfig(lr=lr))
    for n, p in params.named_parameters():
        assert float(np.abs(r0["first"][n] - p.detach().numpy()).max()) < PARAM_TOL, n
    step_err = max((float(np.abs(r0["first"][n] - first[n]).max()), n)
                   for n in first)
    assert step_err[0] < STEP_PARAM_REL_LR * lr, step_err


@pytest.mark.parametrize("name", list(CASES) + list(TINY_MESHES))
def test_mesh_step_lays_out_the_sequence(four, two, name):
    """Every rank's step-0 forward ran JAX's layout: its residual stream's
    rows between blocks ``S / model`` under ``seq`` (``S`` where the rules
    replicate it: the FSDP profile, which granite-3-2b's config names and
    ``fsdp`` then takes, an ``S`` that ``model`` does not divide), and attention's query rows ``S / model`` under ``seq_full``
    (every row, the rank's heads, else)."""
    residual, query = LAYOUT[name]
    for r, res in enumerate(_results(four, two, name)):
        assert res["rows"]["residual"] == [residual], (r, res["rows"])
        assert res["rows"]["query"] == ([] if query is None else [query]), \
            (r, res["rows"])


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_mesh_routes_as_one_device(four, name):
    """Every rank's forward without replay makes the single-device run's
    choices but for at most ``MOE_FLIP_TOL`` of them, and so do the
    replayed steps' own choices; the step's MoE metrics equal one
    device's."""
    for r in four[name]:
        assert r["decisions"] > 0
        assert r["flips"] <= MOE_FLIP_TOL * r["decisions"], r["flips"]
        assert r["replay_decisions"] > 0
        assert r["replay_flips"] <= MOE_FLIP_TOL * r["replay_decisions"]
    r0 = four[name][0]
    _, tcfg = _cfgs(*_case(name)[:2])
    arts = _port_arts(name)[1]
    params, _ = arts.from_jax(_jax_state(name))
    dc = DataConfig(**_data(tcfg))
    with moe_routes.RouteRecorder(replay=[torch.from_numpy(c) for c in
                                          _port_run(name)[4]]):
        _, metrics, _ = arts.grad_fn(params, place_batch(make_batch(dc, 0), "cpu"), 0)
    assert r0["aux"]["moe_dropped"] == float(metrics["moe_dropped"])
    assert abs(r0["aux"]["moe_aux"] - float(metrics["moe_aux"])) <= \
        LOSS_RTOL * abs(float(metrics["moe_aux"]))


def test_reduce_scatter_sums_and_gathers_the_gradient(four):
    """``reduce_scatter`` keeps this rank's columns of the sum over the
    entry; its gradient is every rank's upstream gradient, gathered."""
    for entry, n in (("model", 2), (("data", "model"), 4)):
        xs = [(np.arange(3 * 4 * n, dtype=np.float32).reshape(3, 4 * n) * (r + 1))
              for r in range(4)]
        for rank, res in enumerate(four["reduce_scatter"]):
            y, dx, i = res[entry]
            peers = [r for r in range(4) if n == 4 or r // 2 == rank // 2]
            want = sum(xs[r] for r in peers)[:, 4 * i:4 * (i + 1)]
            np.testing.assert_array_equal(y, want)
            ups = [np.full((3, 4), float(r + 1), np.float32) + np.arange(4.0)
                   for r in peers]
            np.testing.assert_array_equal(dx, np.concatenate(ups, axis=1))


def test_dry_run_logs_and_holds_what_a_real_rank_does(four):
    """``launch/dryrun.trace_step`` of each rank of the 2x2 mesh on meta
    (a ``dry_train_mesh``, no process group) logs the collectives, call
    for call (kind, result bytes, group), and holds the bytes, family by
    family, of the same step on that rank of a real gloo mesh; so do
    their counts and ring bytes by kind."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.mesh import dry_train_mesh
    from repro_torch.launch import dryrun
    from repro_torch.perf.collective_analysis import collective_stats
    shape = ShapeConfig("mesh_step", S, B, "train")
    for rank, real in enumerate(four["dryrun"]):
        dry = dryrun.trace_step(_dry_cfg(), shape,
                                dry_train_mesh(MESH_2X2, rank))
        assert dry["log"] == real["log"], rank
        assert dry["held"] == real["held"], rank
        got, want = collective_stats(dry["log"]), collective_stats(real["log"])
        assert got.count_by_kind == want.count_by_kind
        assert got.bytes_by_kind == want.bytes_by_kind
        assert set(want.count_by_kind) == {"all-reduce", "all-gather",
                                           "reduce-scatter"}


def test_packed_batches_weigh_the_data_ranks_differently():
    """The ranks' weight sums differ, so a mean of the ranks' means would
    not be the global mean the step computes."""
    _, tcfg = _cfgs("granite_3_2b", {})
    seg = make_batch(DataConfig(**_data(tcfg)), 0)["segment_ids"]
    w = ((seg[:, :-1] == seg[:, 1:]) & (seg[:, 1:] >= 0)).sum(axis=1)
    halves = w[:B // 2].sum(), w[B // 2:].sum()
    assert halves[0] != halves[1]


def test_five_step_trajectory_matches_jax(four):
    """Case ``tp_dp`` over five steps: the params at the end within 1e-4 of
    each leaf's max (the losses are held above)."""
    r0 = four["tp_dp"][0]
    _, _, _, jparams = _jax_run("tp_dp")
    _, tcfg = _cfgs("granite_3_2b", {})
    model = tlm.LM(tcfg, r0["last"]["embed"].shape[0], device="meta")
    jnamed = _named_arrays(tcfg, jparams, model)
    for n, p in r0["last"].items():
        assert _leaf_err(p, jnamed[n]) <= TRAJ_TOL, n


def test_microbatch_splits_each_microbatch_over_the_data_ranks(four):
    """With microbatch 2 on data 2, a rank holds one row of each of the two
    microbatches: two rows, one from each half of the batch."""
    assert [r["local_rows"] for r in four["microbatch"]] == [2, 2, 2, 2]
    sh = NamedSharding(_fake_mesh({"data": 2, "model": 2}, rank=2),
                       (("data",), None), (2,))
    rows = sh.shard(np.arange(8).reshape(4, 2))[:, 0]
    assert rows.tolist() == [2, 6]


# ---------------------------------------------------------------------------
# elastic checkpoints
# ---------------------------------------------------------------------------

def test_elastic_resume_matches_an_uninterrupted_run(four, two):
    """(2, 2) for 6 steps (checkpoints at 2 and 5), resumed on (1, 2) to 9,
    against 9 single-device steps: every parameter within 5e-5."""
    assert four["elastic"][0]["stop"] == 6 and two["elastic"][0]["stop"] == 9
    assert len(two["elastic"][0]["losses"]) == 3
    cfg = _elastic_cfg()
    arts = make_train_step(cfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                           torch_chunk=32, device="cpu")
    params = tlm.init_params(cfg, seed=0, device="cpu", vocab_pad_to=2)
    opt = adamw_init(params, AdamWConfig(lr=1e-3))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    losses = []
    for s in range(9):
        params, opt, m = arts.step_fn(params, opt, place_batch(make_batch(dc, s), "cpu"), s)
        losses.append(float(m["loss"]))
    got = two["elastic"][0]["params"]
    for n, p in params.named_parameters():
        assert float(np.abs(got[n] - p.detach().numpy()).max()) < ELASTIC_TOL, n
    mesh_losses = four["elastic"][0]["losses"] + two["elastic"][0]["losses"]
    for a, b in zip(mesh_losses, losses):
        assert abs(a - b) <= TRAJ_TOL * abs(b)


@pytest.mark.parametrize("arch", list(ELASTIC_FAMILIES))
def test_elastic_resume_of_each_family(four, two, arch):
    """The hybrid and the ssm on (2, 2) with checkpoints, resumed on
    (1, 2), against the uninterrupted run on (2, 2): every parameter within
    ``ELASTIC_TOL``; the losses within 1e-4 of it and of the single-device
    run's. (Against the single-device run one element of recurrentgemma's
    ``blocks.0.mlp.wi`` is 5.2e-5 apart after the first step already: its
    gradient sits near AdamW's eps, where the update moves by up to lr
    with the order of the gradient's sums, the effect the step tests hold
    at 0.1 lr.)"""
    first, every, total = ELASTIC_FAMILIES[arch]
    a, b = four[f"elastic_{arch}"][0], two[f"elastic_{arch}"][0]
    full = four[f"uninterrupted_{arch}"][0]
    assert a["stop"] == first and b["stop"] == total and full["stop"] == total
    assert len(b["losses"]) == total - first
    for n, p in full["params"].items():
        assert float(np.abs(b["params"][n] - p).max()) < ELASTIC_TOL, n
    for x, y in zip(a["losses"] + b["losses"], full["losses"]):
        assert abs(x - y) <= TRAJ_TOL * abs(y)
    cfg = _elastic_cfg(arch)
    arts = make_train_step(cfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                           torch_chunk=32, device="cpu")
    params = tlm.init_params(cfg, seed=0, device="cpu", vocab_pad_to=2)
    opt = adamw_init(params, AdamWConfig(lr=1e-3))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    losses = []
    for s in range(total):
        params, opt, m = arts.step_fn(params, opt, place_batch(make_batch(dc, s), "cpu"), s)
        losses.append(float(m["loss"]))
    for x, y in zip(a["losses"] + b["losses"], losses):
        assert abs(x - y) <= TRAJ_TOL * abs(y)


def test_jax_checkpoint_resumes_on_a_mesh(two, tmp_path):
    """JAX's Trainer takes two steps and checkpoints; the port's Trainer on
    (1, 2) resumes it for steps 2 and 3, which JAX's takes too from a copy
    of the directory: the losses within 1e-4."""
    import shutil
    got = two["jax_resume"][0]["losses"]
    assert [s for s, _ in got] == [2, 3]
    assert two["jax_resume"][1]["losses"] == got
    jdir = tmp_path / "jax"
    _jax_trainer(jdir, 2)
    copy = tmp_path / "copy"
    shutil.copytree(jdir, copy)
    tr = _jax_trainer(copy, 4)
    want = [m["loss"] for m in tr.metrics_log]
    for (_, a), b in zip(got, want):
        assert abs(a - b) <= TRAJ_TOL * abs(b)


@pytest.mark.parametrize("arch", JAX_RESUME_FAMILIES)
def test_jax_checkpoint_of_each_family_resumes_on_a_mesh(two, ckpt_root, arch):
    """JAX's Trainer on each family takes two steps and checkpoints; the
    port's Trainer on (1, 2) resumes a copy for steps 2 and 3, which JAX's
    takes too: the losses within 1e-4, equal on both ranks."""
    got = two[f"jax_resume_{arch}"][0]["losses"]
    assert [s for s, _ in got] == [2, 3]
    assert two[f"jax_resume_{arch}"][1]["losses"] == got
    want = _jax_family_losses(str(ckpt_root), arch)
    for (_, a), b in zip(got, want):
        assert abs(a - b) <= TRAJ_TOL * abs(b)


def test_checkpoint_of_another_vocab_padding_is_refused(two):
    """A one-device checkpoint (vocab 251) on a mesh that pads it to 252."""
    for r in two["pad_refused"]:
        assert r["error"] == "CheckpointShapeError"
        assert "embed" in r["msg"] and "padded" in r["msg"]


def _fake_mesh(shape, rank=0):
    """A TrainMesh without process groups: enough for sharding host arrays."""
    mesh = TrainMesh(shape=dict(shape), rank=rank, coords={}, groups={})
    from repro_torch.distributed.mesh import _coords
    mesh.coords = _coords(mesh.shape, rank)
    return mesh


def test_make_train_mesh_joins_a_group(tmp_path):
    """``make_train_mesh`` joins the process group and builds the mesh (a
    world of one rank: every axis of size 1, no group)."""
    import torch.distributed as dist
    from repro_torch.distributed.mesh import make_train_mesh
    mesh = make_train_mesh({"data": 1, "model": 1}, 0, backend="gloo",
                           init_method="file://" + str(tmp_path / "rv"))
    try:
        assert (mesh.world, mesh.rank, mesh.coords) == (1, 0, {"data": 0, "model": 0})
        assert mesh.groups == {} and mesh.group(("data", "model")) is None
        with pytest.raises(ValueError, match="order"):
            mesh.axes(("model", "data"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name,rank", [("fsdp_profile", 3), ("kv_replicated", 1),
                                       ("vlm", 2), ("moe", 1), ("moe_fsdp", 2),
                                       ("ssm", 3), ("hybrid", 2)])
def test_mesh_state_is_made_one_full_leaf_at_a_time(name, rank, monkeypatch):
    """``init_fn`` and ``from_jax`` on a mesh rank drop each full leaf
    before the next is sharded (no whole model is ever built), and keep
    exactly this rank's part of the single-device tensors."""
    arch, over, shape = _case(name)[:3]
    _, tcfg = _cfgs(arch, over)
    mesh = _fake_mesh(shape, rank)
    arts = make_train_step(tcfg, mesh=mesh, device="cpu")
    single = make_train_step(tcfg, device="cpu")
    alive, shard = [], NamedSharding.shard

    def counted(self, x):
        assert all(r() is None for r in alive), "a full leaf outlived its shard"
        alive.append(weakref.ref(x))
        return shard(self, x)

    p_sh = arts.shardings["params"]
    full = tlm.init_params(tcfg, seed=5, device="cpu",
                           vocab_pad_to=vocab_pad_for(mesh))
    monkeypatch.setattr(NamedSharding, "shard", counted)
    params, _ = arts.init_fn(seed=5)
    n_params = len(alive)
    assert n_params == len(p_sh)
    state = _jax_state(name)
    jparams, jopt = arts.from_jax(state)
    assert len(alive) == n_params * 5       # + params, m, v, master
    monkeypatch.setattr(NamedSharding, "shard", shard)
    sparams, sopt = single.from_jax(state)
    for n, p in params.named_parameters():
        assert torch.equal(p, p_sh[n].shard(full.get_parameter(n))), n
    for n, p in jparams.named_parameters():
        assert torch.equal(p, p_sh[n].shard(sparams.get_parameter(n))), n
        for part in ("m", "v", "master"):
            assert torch.equal(getattr(jopt, part)[n],
                               p_sh[n].shard(getattr(sopt, part)[n])), (part, n)


def test_from_jax_refuses_another_vocab_padding():
    _, tcfg = _cfgs("granite_3_2b", {})
    arts = make_train_step(tcfg, mesh=_fake_mesh({"model": 2}),
                           opt=AdamWConfig(lr=1e-3), device="cpu")
    jcfg, _ = _cfgs("granite_3_2b", {})
    params, _ = jlm.init_params(jcfg, jax.random.PRNGKey(0))     # 251 rows
    opt = j_adamw_init(params, JAdamWConfig())
    with pytest.raises(tckpt.CheckpointShapeError, match="padded to 251"):
        arts.from_jax({"params": _np(params), "opt": {
            "step": np.asarray(opt.step), "m": _np(opt.m), "v": _np(opt.v),
            "master": _np(opt.master)}})


# ---------------------------------------------------------------------------
# the launcher, the refusals
# ---------------------------------------------------------------------------

def test_launcher_trains_on_a_2x2_mesh(tmp_path):
    """``launch/train.py --mesh 2x2 --dist-backend gloo --device cpu``:
    every rank reports the same losses, those of the port's single-device
    step on the same state (vocab padded to 2) within 1e-5."""
    argv = ["--arch", "granite_3_2b", "--smoke", "--device", "cpu", "--mesh",
            "2x2", "--dist-backend", "gloo", "--steps", "3", "--batch", "4",
            "--seq", "32", "--ckpt-dir", str(tmp_path / "ck")]
    res = ttrain.main(argv)
    assert res["stop_step"] == 3 and len(res["ranks"]) == 4
    for r in res["ranks"]:
        assert r["losses"] == res["losses"]
    cfg = dataclasses.replace(tconfigs.smoke_config("granite_3_2b"),
                              dtype=torch.float32)
    arts = make_train_step(cfg, opt=AdamWConfig(lr=3e-4, keep_master=False),
                           total_steps=3, warmup_steps=20, torch_chunk=32,
                           device="cpu")
    params = tlm.init_params(cfg, seed=0, device="cpu", vocab_pad_to=2)
    opt = adamw_init(params, AdamWConfig(lr=3e-4, keep_master=False))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    for s, got in enumerate(res["losses"]):
        params, opt, m = arts.step_fn(params, opt, place_batch(make_batch(dc, s), "cpu"), s)
        assert abs(got - float(m["loss"])) <= LOSS_RTOL * abs(float(m["loss"]))
    assert tckpt.latest_step(str(tmp_path / "ck")) == 2


@pytest.mark.parametrize("arch", JAX_RESUME_FAMILIES)
def test_launcher_trains_each_family_on_a_2x2_mesh(arch, tmp_path):
    """``launch/train.py --mesh 2x2`` on the hybrid, the MoE and the ssm:
    every rank reports the same losses, the single-device step's within
    1e-5."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--mesh", "2x2",
            "--dist-backend", "gloo", "--steps", "2", "--batch", "4",
            "--seq", "32", "--ckpt-dir", str(tmp_path / "ck")]
    res = ttrain.main(argv)
    assert res["stop_step"] == 2 and len(res["ranks"]) == 4
    for r in res["ranks"]:
        assert r["losses"] == res["losses"]
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32)
    arts = make_train_step(cfg, opt=AdamWConfig(lr=3e-4, keep_master=False),
                           total_steps=2, warmup_steps=20, torch_chunk=32,
                           device="cpu")
    params = tlm.init_params(cfg, seed=0, device="cpu", vocab_pad_to=2)
    opt = adamw_init(params, AdamWConfig(lr=3e-4, keep_master=False))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    for s, got in enumerate(res["losses"]):
        params, opt, m = arts.step_fn(params, opt, place_batch(make_batch(dc, s), "cpu"), s)
        assert abs(got - float(m["loss"])) <= LOSS_RTOL * abs(float(m["loss"]))


def _plan(name, rank=0):
    arch, over, shape = _case(name)[:3]
    _, tcfg = _cfgs(arch, over)
    return make_train_step(tcfg, mesh=_fake_mesh(shape, rank), device="cpu").plan


@pytest.mark.parametrize("name,rank,want", [
    ("hybrid", 3, dict(heads=True, kv=False, rnn=True, hq_local=1, head_offset=1)),
    ("hybrid_model4", 2, dict(heads=False, rnn=True, hq_local=2, head_offset=0)),
    ("moe", 1, dict(heads=True, kv=True, experts=True, experts_local=4,
                    expert_offset=4)),
    ("moe_fsdp", 2, dict(experts=True, experts_local=2, expert_offset=0)),
    ("moe_fsdp_profile", 3, dict(heads=False, experts=False, experts_local=8,
                                 batch_ranks=4)),
    ("ssm", 1, dict(heads=False, rnn=True, hq_local=0, experts=False)),
])
def test_plan_of_each_family(name, rank, want):
    """The plan's flags, each for the blocks that have the leaf."""
    plan = _plan(name, rank)
    assert {k: getattr(plan, k) for k in want} == want


def test_plan_keys_the_hybrids_two_wo_by_block_kind():
    """On model 4 the RG-LRU's ``wo`` (rnn 64) splits and attention's (2
    heads) does not; the rules' ``seq`` and ``seq_full`` are carried out
    (the plan's ``seq`` and ``ctx``), so nothing is left to the layout
    alone."""
    plan = _plan("hybrid_model4")
    kinds = tlm.block_kinds(plan.cfg)
    rec, attn = kinds.index("rec"), kinds.index("attn")
    assert plan.specs[f"blocks.{rec}.mixer.wo"] == ("model", None)
    assert plan.specs[f"blocks.{attn}.mixer.wo"] == (None, None)
    assert plan.sharded_embed() == {} and plan.seq and plan.ctx
    hybrid = _plan("hybrid")
    assert hybrid.sharded_embed() == {} and hybrid.seq and not hybrid.ctx


@pytest.mark.parametrize("name,s,want", [
    ("hybrid_model4", 32, True), ("hybrid_model4", 30, False),
    ("hybrid_model4", 1, False), ("tp_dp", 30, True), ("tp_dp", 31, False),
    ("fsdp_profile", 32, False), ("tiny_1x2", 2, True)])
def test_plan_lays_the_sequence_out_where_model_divides_it(name, s, want):
    """``seq_rows``: the residual stream over ``model`` for an ``S`` that
    ``model`` divides, JAX's fallback (replicated) for one it does not and
    under the FSDP profile, whose rules set no ``seq``."""
    assert _plan(name).seq_rows(s) is want


def test_plan_sums_the_partial_gradients_over_model_under_seq():
    """After a forward under ``seq`` a leaf replicated over ``model``
    (the norms; attention's weights under ``seq_full``) is summed over
    ``model`` as well as the batch axes; a leaf split over ``model`` or
    entered by ``copy_to`` (qk-norm under split heads) is not; without
    ``seq`` only the batch axes remain."""
    ctx = _plan("hybrid_model4")
    attn = tlm.block_kinds(ctx.cfg).index("attn")
    for leaf in ("norm1", "mixer.wq", "mixer.wo", "mixer.wk"):
        assert ctx.reduce_entry(f"blocks.{attn}.{leaf}", True) == ("model",)
        assert ctx.reduce_entry(f"blocks.{attn}.{leaf}") == ()
    assert ctx.reduce_entry("blocks.0.mixer.wx", True) == ()
    assert ctx.reduce_entry("final_norm", True) == ("model",)
    qk = _plan("qk_norm")
    assert qk.reduce_entry("blocks.0.mixer.q_norm", True) == ()
    assert qk.reduce_entry("blocks.0.norm2", True) == ("model",)
    tp = _plan("tp_dp")
    assert tp.reduce_entry("blocks.0.norm1", True) == ("data", "model")
    assert tp.reduce_entry("blocks.0.mixer.wq", True) == ("data",)
    assert tp.reduce_entry("blocks.0.norm1") == ("data",)


def test_plan_splits_in_proj_half_by_half():
    """Mamba's ``in_proj [d, 2·Di]`` is ``[x | z]``: a rank holds its
    channels of both halves, the checkpoint JAX's layout."""
    plan = _plan("ssm", rank=1)
    assert plan.block("blocks.0.mixer.in_proj") == (None, plan.cfg.mamba.d_inner)
    full = np.arange(2 * 8).reshape(2, 8)
    sh = NamedSharding(plan.mesh, (None, "model"), (None, 4))
    assert sh.shard(full).tolist() == [[2, 3, 6, 7], [10, 11, 14, 15]]


def test_plan_refuses_a_spec_it_cannot_carry_out():
    """A recurrent mixer whose channels split in some leaves and not in
    others raises with the leaves' names and specs."""
    from repro_torch.distributed.parallel import ShardPlan
    from repro_torch.distributed.sharding import default_rules
    _, tcfg = _cfgs("falcon_mamba_7b", {})
    mesh = _fake_mesh(MESH_2X2)
    rules = default_rules(mesh, tcfg)
    logical = tlm.param_specs(tcfg)
    shapes = {n: tuple(p.shape) for n, p in
              tlm.LM(tcfg, 256, device="meta").named_parameters()}
    specs = rules.tree_specs(shapes, logical)
    for i in range(tcfg.num_layers):
        specs[f"blocks.{i}.mixer.w_bc"] = (None, None)
    with pytest.raises(ValueError, match=r"mixer\.w_bc \(None, None\)"):
        ShardPlan(tcfg, mesh, rules, specs, logical)


@pytest.mark.parametrize("bad", ["2x2x2x2", "ax2", "0x2", "2x"])
def test_bad_mesh_strings_are_refused(bad):
    with pytest.raises(ValueError, match="--mesh"):
        ttrain.parse_mesh(bad)


def test_parse_mesh_takes_jax_forms():
    assert ttrain.parse_mesh("") is None
    assert ttrain.parse_mesh("4") == {"model": 4}
    assert ttrain.parse_mesh("2x4") == {"data": 2, "model": 4}
    assert ttrain.parse_mesh("2x16x16") == {"pod": 2, "data": 16, "model": 16}


# ---------------------------------------------------------------------------
# the int8 error-feedback all-reduce
# ---------------------------------------------------------------------------

def test_quantize_psum_matches_jax(four):
    """Four ranks' ``quantize_psum`` against JAX's under ``vmap`` over a
    named axis (its psum and pmax in one process): equal to f32 rounding;
    and JAX's own check, error feedback over 20 steps."""
    g, e = _quant_inputs()
    jg, je = jax.vmap(lambda a, b: jcompression.quantize_psum(a, "data", b),
                      axis_name="data")(jnp.asarray(g), jnp.asarray(e))
    for r, (tg, te, _, _) in enumerate(four["quant"]):
        np.testing.assert_allclose(tg, np.asarray(jg[r]), rtol=0, atol=1e-7)
        np.testing.assert_allclose(te, np.asarray(je[r]), rtol=0, atol=1e-7)


def test_int8_error_feedback_reduces_the_bias(four):
    """JAX's assertion (``tests/test_distributed.py``) on the four ranks:
    one step within int8 noise of the exact mean, and the mean of 20
    error-fed steps closer to it than one step, on every rank."""
    g, _ = _quant_inputs()
    exact = g.mean(axis=0)
    for _, _, one_mean, avg_mean in four["quant"]:
        one = float(np.abs(one_mean - exact).max())
        avg = float(np.abs(avg_mean - exact).max())
        assert one < 5e-4 and avg < one


def test_error_buffers_and_tree():
    grads = {"a": torch.ones(3, 2), "b": torch.zeros(4, dtype=torch.bfloat16)}
    errs = compression.init_error_buffers(grads)
    assert {k: (tuple(v.shape), v.dtype) for k, v in errs.items()} == \
        {"a": ((3, 2), torch.float32), "b": ((4,), torch.float32)}


# ---------------------------------------------------------------------------
# PrefetchLoader
# ---------------------------------------------------------------------------

def test_prefetch_loader_keeps_order_and_ends():
    dc = DataConfig(vocab_size=251, seq_len=16, global_batch=4, seed=3)
    batches = [make_batch(dc, s) for s in range(5)]
    got = list(PrefetchLoader(iter(batches), None, prefetch=2, device="cpu"))
    assert len(got) == 5
    for a, b in zip(got, batches):
        assert set(a) == set(b)
        for k in b:
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_prefetch_loader_places_this_ranks_rows():
    mesh = _fake_mesh({"data": 2, "model": 2}, rank=3)     # data index 1
    sh = {"tokens": NamedSharding(mesh, ("data", None))}
    batch = {"tokens": np.arange(12).reshape(4, 3), "labels": np.ones((4, 3))}
    (got,) = list(PrefetchLoader(iter([batch]), sh, device="cpu"))
    assert got["tokens"].tolist() == [[6, 7, 8], [9, 10, 11]]
    assert tuple(got["labels"].shape) == (4, 3)      # no sharding: whole


def test_prefetch_loader_raises_the_workers_error():
    def host():
        yield {"x": np.zeros(2)}
        raise RuntimeError("host pipeline broke")
    it = PrefetchLoader(host(), None, device="cpu")
    assert next(it)["x"].shape == (2,)
    with pytest.raises(RuntimeError, match="host pipeline broke"):
        next(it)
    with pytest.raises(RuntimeError, match="host pipeline broke"):
        next(it)


def test_prefetch_loader_stops():
    it = PrefetchLoader(iter([]), None, device="cpu")
    with pytest.raises(StopIteration):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


# ---------------------------------------------------------------------------
# the dropout offsets on the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv,h0,h1,kv0,kv1", [(8, 2, 4, 8, 1, 2),
                                                  (4, 4, 1, 3, 1, 3)])
# the shards hold whole GQA groups, as a rank's heads do
def test_offsets_give_the_full_calls_masks_on_the_plain_versions(hq, hkv, h0, h1,
                                                                 kv0, kv1):
    """A shard's rows and heads with ``batch_offset`` / ``head_offset`` draw
    the full call's keep mask: the forward (o, lse) and the backward of the
    plain versions equal the full call's slice; without offsets they do
    not."""
    g = torch.Generator().manual_seed(0)
    b, s, d = 3, 70, 16
    q, do = (torch.randn(b, hq, s, d, generator=g) for _ in range(2))
    k, v = (torch.randn(b, hkv, s, d, generator=g) for _ in range(2))
    kw = dict(causal=True, dropout_rate=0.3, dropout_seed=1234)
    o, lse = tfwd.flash_fwd(q, k, v, **kw)
    dq, dk, dv = tbwd.flash_bwd(q, k, v, o, lse, do, **kw)
    sl, kl = (slice(1, 3), slice(h0, h1)), (slice(1, 3), slice(kv0, kv1))
    off = dict(batch_offset=1, head_offset=h0)
    os_, lses = tfwd.flash_fwd(q[sl], k[kl], v[kl], **kw, **off)
    assert torch.equal(os_, o[sl]) and torch.equal(lses, lse[sl])
    dqs, dks, dvs = tbwd.flash_bwd(q[sl], k[kl], v[kl], os_, lses, do[sl],
                                   **kw, **off)
    assert torch.equal(dqs, dq[sl])
    assert torch.equal(dks, dk[kl]) and torch.equal(dvs, dv[kl])
    assert not torch.equal(tfwd.flash_fwd(q[sl], k[kl], v[kl], **kw)[0], o[sl])


@pytest.mark.parametrize("hkv,s,d,window,packed", [
    (1, 256, 16, None, False), (2, 256, 16, 100, True), (1, 128, 256, 40, False),
    (1, 64, 16, None, False), (2, 64, 16, 24, True)])
def test_query_shards_give_the_full_calls_rows_on_the_plain_versions(
        hkv, s, d, window, packed):
    """Context parallelism on the plain versions: each of 4 shards of the
    query rows, ``[a, b)``, against K/V (and segment ids) cut to ``[0,
    b)``, q their suffix, with dropout, gives the full call's rows; the
    shards' dK/dV (zero past ``b``) sum to the full call's within 1e-6 of
    their max (f32 rounding of the sum's order). Where ``b`` is a multiple
    of the kv tile (64, 32 at D 256; a mesh's ``S / model`` of 768 rows at
    D 256) the plain versions fold the full call's tiles, and o, lse and dQ
    are its rows bit for bit; where it cuts a tile (S 64: 16 rows a shard)
    the last tile's products are shorter sums, within 1e-6 of max |o|."""
    g = torch.Generator().manual_seed(2)
    b, hq, m = 2, 4, 4
    q, do = (torch.randn(b, hq, s, d, generator=g) for _ in range(2))
    k, v = (torch.randn(b, hkv, s, d, generator=g) for _ in range(2))
    seg = None
    if packed:        # three segments and padding, and two
        cut = [s * 5 // 16, s * 12 // 16, s * 15 // 16]
        seg = torch.tensor([[0] * cut[0] + [1] * (cut[1] - cut[0])
                             + [2] * (cut[2] - cut[1]) + [-1] * (s - cut[2]),
                             [0] * (s * 10 // 16) + [1] * (s - s * 10 // 16)],
                           dtype=torch.int32)
    kw = dict(causal=True, window=window, dropout_rate=0.3, dropout_seed=99,
              segment_ids=seg)
    o, lse = tfwd.flash_fwd(q, k, v, **kw)
    dq, dk, dv = tbwd.flash_bwd(q, k, v, o, lse, do, **kw)
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    rows = s // m
    exact = rows % tfwd.kv_tile(d) == 0
    for r in range(m):
        a, e = r * rows, (r + 1) * rows
        kws = dict(kw, segment_ids=None if seg is None else seg[:, :e])
        qs, ks, vs = q[:, :, a:e], k[:, :, :e], v[:, :, :e]
        os_, lses = tfwd.flash_fwd(qs, ks, vs, **kws)
        dqs, dks, dvs = tbwd.flash_bwd(qs, ks, vs, os_, lses, do[:, :, a:e], **kws)
        for got, want in ((os_, o), (lses, lse), (dqs, dq)):
            want = want[:, :, a:e]
            if exact:
                assert torch.equal(got, want), r
            else:
                assert float((got - want).abs().max()) <= \
                    1e-6 * float(want.abs().max()), r
        dk_sum[:, :, :e] += dks
        dv_sum[:, :, :e] += dvs
    for got, want in ((dk_sum, dk), (dv_sum, dv)):
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("impl", ["torch", "naive"])
def test_offsets_on_the_other_impls(impl):
    from repro_torch.core.attention import spark_attention
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 4, 40, 16, generator=g)
    k, v = (torch.randn(2, 2, 40, 16, generator=g) for _ in range(2))
    kw = dict(impl=impl, causal=True, dropout_rate=0.3, seed=7, torch_chunk=16)
    full = spark_attention(q, k, v, **kw)
    part = spark_attention(q[1:, 2:], k[1:, 1:], v[1:, 1:], batch_offset=1,
                           head_offset=2, **kw)
    torch.testing.assert_close(part, full[1:, 2:], rtol=0, atol=1e-6)
