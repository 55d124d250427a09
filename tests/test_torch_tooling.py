"""The port's tooling against the JAX package's, on the CPU: the memory
model (``perf/memory_model.py``), the dry run's shapes and cells
(``configs.SHAPES`` / ``cells``), collective costing
(``perf/collective_analysis.py`` against ``repro.perf.hlo_analysis``),
the dry run's flop count (``launch/dryrun.py``) and the hillclimb
(``launch/hillclimb.py``).

The memory model is pure arithmetic on a config, so its numbers must
equal JAX's exactly; the collective costing must give JAX's bytes for the
HLO line of the same collective. The dry run's counted flops of a forward
without remat must equal the closed form of its matrix products (the
projections, the head, and attention's two products over every key, as
``impl="torch"`` computes them, masked or not). The held bytes and the
collective log of a dry run against a real gloo rank's are in
``tests/test_torch_mesh_train.py``'s 2x2 spawn.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.perf import hlo_analysis as jhlo  # noqa: E402
from repro.perf import memory_model as jmm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun, hillclimb  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402
from repro_torch.perf import collective_analysis as ca  # noqa: E402
from repro_torch.perf import memory_model as tmm  # noqa: E402

# (dp, tp): the 16x16 mesh, the 2x16x16 mesh's batch axes, and the FSDP
# profile's (data x model, no TP)
LAYOUTS = [(16, 16), (32, 16), (256, 1)]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("dp,tp", LAYOUTS)
@pytest.mark.parametrize("shape", list(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_memory_model_equals_jax(arch, shape, dp, tp, fsdp):
    """``traffic_for`` (as ``Traffic.as_dict()``) and ``storage_for``
    equal JAX's, number for number."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jshape, tshape = jconfigs.SHAPES[shape], tconfigs.SHAPES[shape]
    kw = dict(dp=dp, tp=tp, fsdp=fsdp)
    assert tmm.traffic_for(tcfg, tshape, **kw).as_dict() == \
        jmm.traffic_for(jcfg, jshape, **kw).as_dict()
    assert tmm.storage_for(tcfg, tshape, **kw) == \
        jmm.storage_for(jcfg, jshape, **kw)
    assert tmm.traffic_for(tcfg, tshape, **kw).total == \
        jmm.traffic_for(jcfg, jshape, **kw).total


def test_memory_model_constants_and_fallback_equal_jax():
    from repro_torch.perf import autotune
    assert (tmm.BF16, tmm.F32) == (jmm.BF16, jmm.F32) == (2, 4)
    assert autotune.BF16 is tmm.BF16
    for n, by in [(7, 1), (8, 2), (7, 2), (16384, 16), (49155, 16)]:
        assert tmm._div(n, by) == jmm._div(n, by)


def test_shapes_and_cells_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in jconfigs.ARCHS:
        assert tconfigs.cells(tconfigs.get_config(arch)) == \
            jconfigs.cells(jconfigs.get_config(arch)), arch
        assert tconfigs.get_config(arch).sub_quadratic == \
            jconfigs.get_config(arch).sub_quadratic


_DTYPES = {"f32": 4, "bf16": 2}


def _hlo_line(kind, dtype, dims, n):
    t = f"{dtype}[{','.join(map(str, dims))}]{{1,0}}"
    groups = "{{" + ",".join(map(str, range(n))) + "}}"
    return (f"  %x.{n} = {t} {kind}({t} %p), channel_id=1, "
            f"replica_groups={groups}, use_global_device_ids=true")


@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter",
                                  "all-to-all", "collective-permute"])
def test_collective_stats_equal_hlo_analysis(kind, dtype, n):
    """One op of each kind and group size costs JAX's bytes for its HLO
    line (the ring formulas, n at least 2)."""
    dims = (8, 3 * n)
    size = int(np.prod(dims)) * _DTYPES[dtype]
    got = ca.collective_stats([{"kind": kind, "bytes": size, "group": n}])
    want = jhlo.collective_stats(_hlo_line(kind, dtype, dims, n))
    assert want.count_by_kind == {kind: 1}
    assert got.count_by_kind == want.count_by_kind
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.total_bytes == want.total_bytes
    assert got.ops == want.ops


def test_collective_stats_of_a_log_equal_hlo_analysis():
    """A mixed log: the totals by kind are JAX's for the same lines."""
    calls = [("all-reduce", "f32", (4, 8), 2), ("all-gather", "bf16", (2, 64), 4),
             ("reduce-scatter", "f32", (16, 16), 2), ("all-reduce", "bf16", (128,), 16),
             ("all-gather", "f32", (3, 5), 2)]
    log = [{"kind": k, "bytes": int(np.prod(d)) * _DTYPES[t], "group": n}
           for k, t, d, n in calls]
    hlo = "\n".join(_hlo_line(*c) for c in calls)
    got, want = ca.collective_stats(log), jhlo.collective_stats(hlo)
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind
    assert got.total_bytes == want.total_bytes


def _closed_form_flops(cfg, b, s, *, embeds: bool):
    """2·tokens·(every projection) + the head + frontend_proj, and
    attention's QKᵀ and PV over every key: 4·B·Hq·S·S·D a layer."""
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mlp = (3 if cfg.mlp_type == "gated_silu" else 2) * d * cfg.d_ff
    per_tok = 2 * (2 * d * hq * hd + 2 * d * hkv * hd + mlp) * cfg.num_layers
    per_tok += 2 * d * cfg.vocab_size
    if embeds:
        per_tok += 2 * lm.FRONTEND_DIM * d
    return per_tok * b * s + 4 * b * hq * s * s * hd * cfg.num_layers


@pytest.mark.parametrize("arch,embeds", [("granite_3_2b", False),
                                         ("qwen3_14b", False),
                                         ("llava_next_34b", True),
                                         ("hubert_xlarge", True)])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counted_flops_equal_the_closed_form(arch, embeds, device):
    """A no-remat forward's counted flops (the dry run's counter, on the
    CPU and on meta) equal the closed form of its matrix products, over
    two kv chunks."""
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), dtype=torch.float32,
                              remat=False)
    b, s = 2, 48
    params = lm.LM(cfg, cfg.vocab_size, device=device)
    kw = ({"embeds": torch.zeros((b, s, lm.FRONTEND_DIM), device=device)}
          if embeds else
          {"tokens": torch.zeros((b, s), dtype=torch.long, device=device)})
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        lm.forward(cfg, params, Ctx(impl="torch", torch_chunk=32), **kw)
    assert counter.get_total_flops() == _closed_form_flops(cfg, b, s,
                                                           embeds=embeds)


def test_dry_run_skips_exactly_jax_cells(tmp_path, monkeypatch):
    """``run_cell`` of a cell JAX's ``cells()`` skips writes JAX's reason
    and traces nothing."""
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    for arch in jconfigs.ARCHS:
        for shape, (ok, reason) in jconfigs.cells(
                jconfigs.get_config(arch)).items():
            if ok:
                continue
            meta = dryrun.run_cell(arch, shape, multi_pod=False, verbose=False)
            assert meta == {"arch": arch, "shape": shape, "mesh": "16x16",
                            "skipped": True, "reason": reason}
            assert json.loads((tmp_path / f"{arch}__{shape}__16x16.json")
                              .read_text()) == meta


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_dry_run_cell_reports_jax_fields(shape, tmp_path, monkeypatch):
    """A cell (granite SMOKE at the production shapes, 16x16) traced on
    meta: held bytes by family, the analytic storage and traffic, counted
    flops, the collectives by kind and the roofline, in JAX's fields."""
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    cfg = tconfigs.smoke_config("granite_3_2b")
    meta = dryrun.run_cell("granite_3_2b", shape, multi_pod=False,
                           cfg_override=cfg, verbose=False)
    assert "error" not in meta, meta.get("traceback")
    held = meta["memory"]["held_bytes"]
    families = {"train_4k": {"params", "grads", "optimizer"}}.get(
        shape, {"params", "cache"})
    assert set(held) == families | {"total"}
    assert held["total"] == sum(v for k, v in held.items() if k != "total") > 0
    assert meta["memory"]["storage_analytic"] == tmm.storage_for(
        cfg, tconfigs.SHAPES[shape], dp=16, tp=16, fsdp=cfg.fsdp)
    assert meta["traffic_model"]["total"] == meta["roofline"]["mem_bytes_model"]
    assert meta["cost"]["flops"] == meta["roofline"]["hlo_flops_per_dev"] > 0
    coll = meta["collectives"]
    assert coll["total_bytes_per_dev"] == pytest.approx(
        sum(coll["bytes_by_kind"].values()))
    assert coll["count_by_kind"] and meta["chips"] == 256
    for term in ("compute_s", "memory_s", "collective_s", "step_time_s", "mfu"):
        assert meta["roofline"][term] >= 0
    assert (tmp_path / f"granite_3_2b__{shape}__16x16.json").exists()


def _hill_cfg(arch):
    """granite SMOKE at d_model 256, which 256 ranks divide."""
    return dataclasses.replace(tconfigs.smoke_config(arch), d_model=256,
                               head_dim=64)


def test_hillclimb_runs_an_overridden_cell(tmp_path, monkeypatch, capsys):
    """One ROUND3 experiment (the ZeRO-3 profile) on a small granite: the
    tagged artifact beside the baseline's and the before → after report;
    the profile holds every weight's embed dim over all 256 ranks, so a
    rank holds less than under TP over 16."""
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    monkeypatch.setattr(hillclimb, "get_config", _hill_cfg)
    monkeypatch.setattr(hillclimb, "ROUND3", hillclimb.ROUND3[:1])
    dryrun.run_cell("granite_3_2b", "train_4k", multi_pod=False,
                    cfg_override=_hill_cfg("granite_3_2b"), verbose=False)
    out = hillclimb.main(["--round3", "--only", "fsdp_profile"])
    text = capsys.readouterr().out
    after = out[("granite_3_2b", "train_4k", "fsdp_profile")]
    assert after["tag"] == "__fsdp_profile" and "error" not in after
    assert (tmp_path / "granite_3_2b__train_4k__16x16__fsdp_profile.json").exists()
    for term in ("compute_s", "memory_s", "collective_s", "step_time_s", "mfu",
                 "held/rank"):
        assert term in text
    before = hillclimb.load("granite_3_2b", "train_4k")
    assert after["memory"]["held_bytes"]["params"] < \
        before["memory"]["held_bytes"]["params"]


def test_serving_batch_the_batch_axes_do_not_divide_is_replicated():
    """``long_500k``'s one row on data 16: JAX's ``spec_for`` replicates a
    batch its axes do not divide, and so does the serving plan (and its
    cache), where it used to refuse; a batch they divide is split."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.mesh import dry_train_mesh
    from repro_torch.runtime.steps import serving_plan
    cfg = tconfigs.smoke_config("recurrentgemma_2b")
    mesh = dry_train_mesh({"data": 16, "model": 16})
    plan = serving_plan(cfg, mesh, batch=1)
    assert plan.batch is None
    assert serving_plan(cfg, mesh, batch=32).batch == "data"
    for c in lm.init_cache(cfg, 1, 4096, device="meta", plan=plan):
        assert next(iter(c.values())).shape[0] == 1
    got = dryrun.trace_step(cfg, ShapeConfig("one_row", 4096, 1, "decode"),
                            mesh)
    assert got["held"]["cache"] > 0 and got["log"]
