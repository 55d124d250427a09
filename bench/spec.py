"""``BENCHMARK.json`` and the files the harness finds by name in it:
``bench/configs/<config>.json``, ``bench/mixes/<traffic>.json``,
``bench/metrics/<metric>.py``, ``bench/limits/<cell>.json`` and
``bench/reference/<reference>.py``. No torch, nothing of the program."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                   f"{', '.join(w['name'] for w in spec['workloads'])})")


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def limits(cell_name: str) -> Dict[str, float]:
    """The limit of each number a cell's ``correct`` compares."""
    return json.loads((BENCH / "limits" / f"{cell_name}.json").read_text())["limits"]


def metrics_for(spec: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metric entries a run of ``cell_name`` reports: the end-to-end
    ones, or with ``trace`` the per-layer ones, each where its
    ``workloads`` names the cell or it has none."""
    entries = spec["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]


def _module(path: Path, name: str) -> ModuleType:
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> ModuleType:
    """``bench/metrics/<metric>.py``: ``read(run)`` gives the metric's value
    or None where the run has nothing to read."""
    return _module(BENCH / "metrics" / f"{metric}.py",
                   "bench_metric_" + re.sub(r"\W", "_", metric))


def reference(config_dict: dict) -> ModuleType:
    """The configuration's plain reference, ``bench/reference/<name>.py``."""
    name = config_dict["reference"]
    return importlib.import_module(f"bench.reference.{name}")


def driver(kind: str) -> ModuleType:
    """The driver of a mix's kind, ``bench/drivers/<kind>.py``."""
    return importlib.import_module(f"bench.drivers.{kind}")
