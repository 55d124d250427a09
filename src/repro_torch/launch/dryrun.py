"""Dry run of every (arch × shape × mesh) cell on the ``meta`` device, with
no card and no process group (counterpart of ``repro.launch.dryrun``).

JAX lowers and compiles each cell for 256 or 512 placeholder devices and
reads XLA's memory, cost and collective analyses. The port has no
compiler to ask, so it runs the cell: one rank (rank 0 unless asked) of
the production mesh, ``{"data": 16, "model": 16}`` or ``{"pod": 2,
"data": 16, "model": 16}``, is a ``distributed.mesh.dry_train_mesh``,
whose groups are ``collectives.DryGroup``s: its collectives move nothing
and are logged. The rank builds its ``ShardPlan`` (the training rules, or
``ShardPlan.serving``) and its state on ``meta`` at the config's full
width, depth and dtype (params, gradients and AdamW state for ``train``;
params and ``init_cache`` for ``prefill`` / ``decode``), then takes one
step with ``impl="torch"`` under ``torch.utils.flop_counter.FlopCounterMode``:
the loss-and-grad pass (with remat, as the config says) and the AdamW
update for ``train``, ``make_serve_steps``' prefill, or one decode step
at the cache's last position. No tensor is allocated and no value read.

Each cell reports, in JAX's JSON layout where a field exists:

* ``memory``: the bytes the rank holds, by family, counted from its meta
  tensors (``held_bytes``), against ``roofline.hbm_per_chip()``
  (``fits``); ``memory_model.storage_for`` and ``fits_analytic``;
* ``cost``: the counted flops (``FlopCounterMode`` counts matrix products,
  attention's among them, not elementwise work);
* ``traffic_model``: ``memory_model.traffic_for`` (JAX's layout in bf16);
* ``collectives``: the step's log through
  ``perf/collective_analysis.collective_stats``;
* ``roofline``: ``roofline.build`` on those numbers with
  ``mem_bytes_model = traffic.total``: a model of the card's time, never a
  measurement.

The numbers are one rank's (``--rank``, 0 by default). A layout that
gives the ranks unequal work shows it here, where JAX's one SPMD program
does not: under ``seq_full`` a rank attends its query rows to the keys up
to their end, so the last ``model`` rank counts the most attention flops
and rank 0 the fewest.

Every layer is traced. JAX extrapolates its costs from two shallow
unrolled compiles (``_delta_cost``) because XLA's cost analysis counts a
scan body once and 60–95 unrolled layers compile slowly; a meta trace runs
and counts each layer, so the port needs no extrapolation.

Cells are skipped as ``configs.cells`` says; a cell that raises is written
with its error, as JAX's ``run_cell`` does. Artifacts go to
``artifacts/dryrun_torch/`` (never JAX's ``artifacts/dryrun/``).

Usage (the CPU, no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod | --both-meshes] [--skip-done]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh import dry_train_mesh
from repro_torch.distributed.sharding import (default_rules, uses_fsdp_profile,
                                             vocab_pad_for)
from repro_torch.models import lm
from repro_torch.models.lm import FRONTEND_DIM
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.perf import roofline
from repro_torch.perf.collective_analysis import collective_stats
from repro_torch.perf.memory_model import storage_for, traffic_for
from repro_torch.runtime.steps import make_serve_steps, make_train_step

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

#: the KV chunk of ``impl="torch"`` attention in the traced step: it changes
#: no reported number (the flops count every key, the held bytes hold no
#: activation, the collectives do not see it)
TORCH_CHUNK = 1024

#: JAX's production meshes, by ``multi_pod``
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


def mesh_tag(shape: Dict[str, int]) -> str:
    """``16x16``, ``2x16x16``: the mesh's sizes in axis order."""
    return "x".join(str(n) for n in shape.values())


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _cache_tensors(caches):
    for c in caches:
        yield from (v for v in c.values() if isinstance(v, torch.Tensor))


def meta_params(cfg, plan, vpad: int):
    """The rank's shard of every parameter of ``cfg`` (vocab ``vpad``) on
    ``meta``, under ``plan``'s shardings."""
    model = lm.LM(cfg, vpad, device="meta")
    for n, p in list(model.named_parameters()):
        part = plan.sharding(n).shard(p.detach())
        lm.set_param(model, n, torch.empty(part.shape, dtype=part.dtype,
                                           device="meta"))
    return model


def _meta_batch(cfg, rows: int, seq: int):
    ids = torch.empty((rows, seq), dtype=torch.int32, device="meta")
    if cfg.frontend is None:
        return {"tokens": ids, "labels": ids}
    return {"embeds": torch.empty((rows, seq, FRONTEND_DIM),
                                  dtype=torch.float32, device="meta"),
            "labels": ids}


def trace_step(cfg, shape, mesh):
    """One step of ``shape.kind`` for the rank of ``mesh`` (a
    ``dry_train_mesh``) on ``meta`` (module docstring): ``{"held":
    {family: bytes}, "flops", "log" (the step's collectives),
    "fallbacks", "plan"}``."""
    device = "meta"
    opt = AdamWConfig()
    kind = shape.kind
    held: Dict[str, int] = {}
    vpad = lm.padded_vocab(cfg, vocab_pad_for(mesh))
    flops = FlopCounterMode(display=False)
    C.log = []
    try:
        if kind == "train":
            arts = make_train_step(cfg, mesh=mesh, impl="torch", device=device,
                                   torch_chunk=TORCH_CHUNK, opt=opt)
            plan, fallbacks = arts.plan, arts.rules.fallbacks
            params = meta_params(cfg, plan, vpad)
            state = adamw_init(params, opt)
            rows = shape.global_batch // mesh.size(plan.batch)
            batch = _meta_batch(cfg, rows, shape.seq_len)
            with flops:
                _, _, grads = arts.grad_fn(params, batch, 0)
                held["grads"] = _nbytes(grads.values())
                adamw_update(grads, state, params, opt, plan=plan)
            held["optimizer"] = _nbytes([*state.m.values(), *state.v.values(),
                                         *(state.master or {}).values()])
        else:
            arts = make_serve_steps(cfg, impl="torch", max_len=shape.seq_len,
                                    batch=shape.global_batch,
                                    torch_chunk=TORCH_CHUNK, device=device,
                                    mesh=mesh)
            plan = arts.plan
            rules = default_rules(mesh, cfg, serve=True,
                                  decode=kind == "decode")
            rules.tree_specs({n: tuple(p.shape) for n, p in
                              lm.LM(cfg, vpad, device="meta").named_parameters()},
                             lm.param_specs(cfg))
            fallbacks = rules.fallbacks
            params = meta_params(cfg, plan, vpad)
            caches = arts.cache_init_fn()
            b, s = shape.global_batch, shape.seq_len
            with flops:
                if kind == "prefill":
                    batch = _meta_batch(cfg, b, s)
                    arts.prefill_fn(params, batch.get("tokens"), caches,
                                    embeds=batch.get("embeds"))
                else:
                    token = torch.empty((b,), dtype=torch.int64, device=device)
                    arts.decode_fn(params, token, caches, s - 1)
            held["cache"] = _nbytes(_cache_tensors(caches))
        held["params"] = _nbytes(params.parameters())
        log = C.log
    finally:
        C.log = None
    held = {k: held[k] for k in ("params", "grads", "optimizer", "cache")
            if k in held}
    held["total"] = sum(held.values())
    return {"held": held, "flops": float(flops.get_total_flops()), "log": log,
            "fallbacks": dict(fallbacks), "plan": plan}


def _layout(cfg, mesh_shape):
    """(dp, tp, fsdp) of the memory model, as JAX's dry run reads them."""
    if uses_fsdp_profile(cfg):
        return mesh_shape.get("data", 1) * mesh_shape.get("model", 1), 1, True
    return (mesh_shape.get("data", 1) * mesh_shape.get("pod", 1),
            mesh_shape.get("model", 1), cfg.fsdp)


def trace_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
               rank: int = 0, cfg_override=None) -> dict:
    """One runnable cell traced on ``meta``: its JSON (module docstring)."""
    cfg = cfg_override or get_config(arch_name)
    shape = SHAPES[shape_name]
    mesh_shape = MESHES[multi_pod]
    mesh = dry_train_mesh(mesh_shape, rank)
    t0 = time.perf_counter()
    got = trace_step(cfg, shape, mesh)
    trace_s = time.perf_counter() - t0
    coll = collective_stats(got["log"])
    dp, tp, fsdp = _layout(cfg, mesh_shape)
    traffic = traffic_for(cfg, shape, dp=dp, tp=tp, fsdp=fsdp)
    storage = storage_for(cfg, shape, dp=dp, tp=tp, fsdp=fsdp)
    hbm = roofline.hbm_per_chip()
    rf = roofline.build(cfg, shape, step_kind=shape.kind, chips=mesh.world,
                        hlo_flops_per_dev=got["flops"], hlo_bytes_per_dev=0.0,
                        coll_bytes_per_dev=coll.total_bytes,
                        mem_bytes_model=traffic.total)
    return {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_tag(mesh_shape),
        "chips": mesh.world, "rank": rank, "trace_s": trace_s,
        "dtype": str(cfg.dtype).replace("torch.", ""),
        "memory": {
            "held_bytes": got["held"],
            "hbm_per_chip": hbm,
            "fits": got["held"]["total"] < hbm,
            "storage_analytic": storage,
            "fits_analytic": storage["total"] < hbm,
        },
        "cost": {"flops": got["flops"],
                 "method": f"FlopCounterMode on meta, all {cfg.num_layers} "
                           f"layers traced (matrix products only)"},
        "traffic_model": traffic.as_dict(),
        "collectives": {"bytes_by_kind": coll.bytes_by_kind,
                        "count_by_kind": coll.count_by_kind,
                        "total_bytes_per_dev": coll.total_bytes},
        "roofline": rf.as_dict(),
        "roofline_note": "a model of one H100's time from counted flops, "
                         "modelled traffic and logged collectives; not a "
                         "measurement",
        "sharding_fallbacks": got["fallbacks"],
    }


def _save(meta: dict, path: Path, save: bool) -> None:
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(meta, indent=1))


def run_cell(arch_name, shape_name, *, multi_pod, save=True, verbose=True,
             tag="", cfg_override=None, rank: int = 0):
    """One cell: skipped as ``cells`` says, traced, or written with its
    error (JAX's ``run_cell``). Returns its JSON."""
    cfg = cfg_override or get_config(arch_name)
    runnable, reason = cells(cfg)[shape_name]
    mtag = mesh_tag(MESHES[multi_pod])
    if rank:
        tag += f"__rank{rank}"
    path = ART_DIR / f"{arch_name}__{shape_name}__{mtag}{tag}.json"
    if not runnable:
        meta = {"arch": arch_name, "shape": shape_name, "mesh": mtag,
                "skipped": True, "reason": reason}
        _save(meta, path, save)
        if verbose:
            print(f"SKIP  {arch_name:22s} {shape_name:12s} {mtag}: {reason}")
        return meta
    try:
        meta = trace_cell(arch_name, shape_name, multi_pod=multi_pod,
                          cfg_override=cfg_override, rank=rank)
    except Exception as e:
        meta = {"arch": arch_name, "shape": shape_name, "mesh": mtag,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-3000:]}
        _save(meta, path, save)
        if verbose:
            print(f"FAIL  {arch_name:22s} {shape_name:12s} {mtag}: "
                  f"{meta['error'][:120]}", flush=True)
        return meta
    if tag:
        meta["tag"] = tag
    _save(meta, path, save)
    if verbose:
        rf, m = meta["roofline"], meta["memory"]
        print(f"OK    {arch_name:22s} {shape_name:12s} {mtag} "
              f"trace={meta['trace_s']:6.1f}s "
              f"held/rank={m['held_bytes']['total'] / 1e9:7.2f}GB "
              f"fits={m['fits']} bound={rf['bound']:10s} "
              f"mfu={rf['mfu'] * 100:5.1f}% (model) "
              f"[C={rf['compute_s'] * 1e3:.1f}ms M={rf['memory_s'] * 1e3:.1f}ms "
              f"X={rf['collective_s'] * 1e3:.1f}ms]", flush=True)
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--rank", type=int, default=0,
                    help="the mesh rank to trace (artifacts tagged __rankN)")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multipod]
    archs = configs.ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    ok = fail = skip = 0
    t0 = time.perf_counter()
    for mp in meshes:
        for a in archs:
            for s in shapes:
                rtag = f"__rank{args.rank}" if args.rank else ""
                path = ART_DIR / f"{a}__{s}__{mesh_tag(MESHES[mp])}{rtag}.json"
                if args.skip_done and path.exists():
                    prev = json.loads(path.read_text())
                    if "error" not in prev:
                        print(f"CACHED {a} {s} {mesh_tag(MESHES[mp])}")
                        skip += bool(prev.get("skipped"))
                        ok += not prev.get("skipped")
                        continue
                meta = run_cell(a, s, multi_pod=mp, rank=args.rank)
                if meta.get("skipped"):
                    skip += 1
                elif "error" in meta:
                    fail += 1
                else:
                    ok += 1
    print(f"\ndry-run summary: {ok} ok, {skip} family-skips, {fail} failures "
          f"in {time.perf_counter() - t0:.1f} s")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
