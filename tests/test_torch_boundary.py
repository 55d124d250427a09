"""Import boundary of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package ``repro``, and no public entry point
defaults to the CPU (the card is the default; the CPU is asked for)."""

import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _trees():
    for path in FILES:
        yield path.relative_to(ROOT), ast.parse(path.read_text(), str(path))


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 10
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in FILES[:-1]}
    assert {"distributed/mesh.py", "distributed/paged.py",
            "launch/mesh.py", "models/moe.py"} <= names


def _import_violations(rel, tree):
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            arg = node.args[0]
            head = arg.values[0] if isinstance(arg, ast.JoinedStr) else arg
            names = [head.value] if isinstance(head, ast.Constant) else []
        bad += [f"{rel}:{node.lineno}: imports {n}" for n in names
                if isinstance(n, str) and _forbidden(n)]
    return bad


def _cpu_default_violations(rel, tree):
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            pos = a.posonlyargs + a.args
            pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
            pairs += [(k, d) for k, d in zip(a.kwonlyargs, a.kw_defaults)
                      if d is not None]
            bad += [f"{rel}:{node.lineno}: {node.name}(device='cpu')"
                    for arg, d in pairs
                    if arg.arg == "device" and isinstance(d, ast.Constant)
                    and d.value == "cpu"]
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"
                and any(isinstance(x, ast.Constant) and x.value == "--device"
                        for x in node.args)):
            bad += [f"{rel}:{node.lineno}: --device defaults to cpu"
                    for kw in node.keywords
                    if kw.arg == "default" and isinstance(kw.value, ast.Constant)
                    and kw.value.value == "cpu"]
    return bad


def test_port_imports_no_jax_and_no_repro():
    bad = [v for rel, tree in _trees() for v in _import_violations(rel, tree)]
    assert not bad, "\n".join(bad)


def test_no_entry_point_defaults_to_cpu():
    bad = [v for rel, tree in _trees()
           for v in _cpu_default_violations(rel, tree)]
    assert not bad, "\n".join(bad)


def test_checker_catches_violations():
    """The walks above are not vacuous: each flags every form it looks for,
    and leaves the port's own names alone."""
    src = ("import jax.numpy as jnp\nfrom repro.core import attention\n"
           "import importlib\nimportlib.import_module(f'repro.configs.{x}')\n"
           "from repro_torch.core import attention\nimport torch\n"
           "def f(x, *, device='cpu'):\n    pass\n"
           "def g(x, device='cuda'):\n    pass\n"
           "ap.add_argument('--device', default='cpu')\n")
    tree = ast.parse(src)
    assert [v.split(": ")[0] for v in _import_violations("m.py", tree)] == \
        ["m.py:1", "m.py:2", "m.py:4"]
    assert [v.split(": ")[0] for v in _cpu_default_violations("m.py", tree)] \
        == ["m.py:7", "m.py:11"]
