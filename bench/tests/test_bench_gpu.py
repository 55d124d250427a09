"""On the card: the control of every cell, the cell run at its own size with
its matrix products on TF32 (a precision below the configuration's f32),
comes out not correct. Marked ``gpu``; the ``cuda`` fixture skips it where
there is no card. On the card:
``python -m pytest -q -m gpu bench/tests/test_bench_gpu.py``."""

import json
import subprocess
import sys

import pytest

from bench import spec

pytestmark = pytest.mark.gpu
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(cuda, name):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name, "--seed", "2147483999",
         "--seconds", "3", "--trace", "0", "--tf32", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
