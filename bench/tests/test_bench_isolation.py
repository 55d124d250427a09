"""What the benchmark may not touch: no module under ``bench/`` imports JAX
or the JAX package (top-level names compared whole: the port's
``repro_torch`` is not ``repro``) or reads the old ``benchmarks/`` folder,
and ``bench/run.py`` refuses to measure without a card or without the
program under test beside it."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(spec.BENCH.rglob("*.py"))


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "importorskip") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.ROOT)))
def test_no_jax_and_no_old_benchmarks(path):
    assert not set(_imported(path)) & FORBIDDEN
    if "tests" not in path.relative_to(spec.BENCH).parts:
        assert "benchmarks" not in path.read_text()


def test_the_reference_imports_torch_alone():
    for path in (spec.BENCH / "reference").glob("*.py"):
        assert set(_imported(path)) <= {"__future__", "contextlib", "typing",
                                         "torch"}, path


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "granite-3-2b.train-4k",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    out = _run(spec.ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "no CUDA card" in out.stderr


def test_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert json.loads((tmp_path / "BENCHMARK.json").read_text()) == spec.benchmark()


def test_result_line_ends_with_the_checks():
    """The report's keys: the contract's, and the numbers compared last."""
    from types import SimpleNamespace
    from bench import cell
    c = spec.cell(spec.benchmark(), "granite-3-2b.train-4k")
    run = SimpleNamespace(kind="train", setup_s=12.5, tokens=8192 * 10,
                          window_s=40.0, model_flops=1.4e15, dtype="float32",
                          profile=None)
    out = SimpleNamespace(run=run, correct=True, attempted=10, failed=0,
                          checks={"loss_gap": {"value": 1e-7, "limit": 1e-5}})
    line = cell.report(spec.benchmark(), c, out, False, {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device",
                          "checks"]
    assert set(line["metrics"]) == {"train_tokens_per_s", "train_mfu", "setup_s"}
    assert line["metrics"]["train_tokens_per_s"]["value"] == 8192 * 10 / 40.0
