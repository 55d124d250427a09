"""One run of one cell: its configuration, mix and limits found by name,
the precision set, the mix's driver run, the check judged and the metrics
read. ``run.py`` calls :func:`execute` on the card; the CPU tests call it
at a small size with the card's look skipped."""

from __future__ import annotations

import dataclasses
import sys
from types import SimpleNamespace

from bench import checks, spec, trace, traffic

#: host threads of torch's CPU ops: the load comes from one process with few
THREADS = 4


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def arch_config(conf: dict):
    """The port's config of the file: its arch's, with every ``ArchConfig``
    field the file sets (a nested group, such as ``moe``, given as an
    object of the fields it changes) and the file's dtype."""
    import torch
    from repro_torch import configs
    base = configs.get_config(conf["arch"])
    over = {}
    for f in dataclasses.fields(base):
        if f.name in ("name", "dtype") or f.name not in conf:
            continue
        cur, val = getattr(base, f.name), conf[f.name]
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            val = dataclasses.replace(cur, **val)
        elif isinstance(cur, tuple) and isinstance(val, list):
            val = tuple(val)
        over[f.name] = val
    return dataclasses.replace(base, **over, dtype=getattr(torch, conf["dtype"]))


def execute(cell: dict, *, seed: int, seconds: float, trace_on: bool,
            t_start: float, device: str = "cuda", tf32: bool = False,
            config=None, mix=None, limits=None):
    """Run ``cell`` once. ``tf32`` puts every matrix product outside the
    port's kernels on TF32: the control, one precision below the
    configuration's f32. config / mix / limits replace the files' (the CPU
    tests' small sizes). Returns the driver's result with ``correct`` and
    ``checks``."""
    import torch
    conf = config or spec.config(cell["config"])
    mix = mix or traffic.load(cell["traffic"])
    lim = limits or spec.limits(cell["name"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_num_threads(THREADS)
    rec = trace.Recorder()
    trace.install(rec)
    ctx = SimpleNamespace(
        cell=cell["name"], config=conf, mix=mix, cfg=arch_config(conf),
        reference=spec.reference(conf), seed=seed, seconds=seconds,
        device=device, rec=rec, t_start=t_start, log=log,
        profile=trace.Profile(rec) if trace_on else None)
    out = spec.driver(mix["kind"]).run(ctx)
    out.correct, out.checks = checks.judge(out.numbers, lim)
    out.correct = out.correct and out.failed == 0
    return out


def report(bench_spec: dict, cell: dict, out, trace_on: bool, device: dict) -> dict:
    """The result line: the cell's end-to-end metrics (or with ``trace_on``
    its per-layer ones) as their readers find them, the device, the
    traced window and its breakdown, and last the numbers compared."""
    metrics = {}
    for m in spec.metrics_for(bench_spec, cell["name"], trace_on):
        value = spec.reader(m["name"]).read(out.run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(out.correct), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    prof = out.run.profile
    if trace_on and prof is not None:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
        line["launches"] = trace.launch_counts()
    line["checks"] = out.checks
    return line
