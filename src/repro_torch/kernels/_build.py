"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled, at first
use, into ``build/kernels/lib<name>-<digest>.so`` under the repository root
(the digest covers the source, the headers of ``csrc/`` and the flags, so an
edited source or header is rebuilt).
Nothing is prebuilt and nothing is fetched: the checkout plus the CUDA
toolkit's ``nvcc`` are enough. ``build(names)`` starts one nvcc per source,
all at once, and keeps ptxas's register and shared-memory report of each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("flash_fwd", "flash_decode", "flash_bwd")

#: name → ptxas's "registers / smem" lines from the build in this process
ptxas_report: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels are built from source at first use")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):      # csrc/mma.cuh, ...
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, one nvcc each,
    all started together. Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, targets[name])
        ptxas_report[name] = "\n".join(
            ln for ln in out.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def write_variant(name: str, edits, out: Path) -> Path:
    """Copy ``csrc/<name>.cu`` and the headers of ``csrc/`` into ``out``, each
    text edit ``(old, new)`` applied to the one file that holds ``old``;
    returns the copy of the source (for the ablation scripts)."""
    files = {p.name: p.read_text()
             for p in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh")))}
    for old, new in edits:
        holders = [f for f, text in files.items() if old in text]
        if len(holders) != 1:
            raise RuntimeError(f"{old!r} is in {holders or 'no file'} of {name}")
        files[holders[0]] = files[holders[0]].replace(old, new)
    out.mkdir(parents=True, exist_ok=True)
    for f, text in files.items():
        (out / f).write_text(text)
    return out / f"{name}.cu"


def kernel_fn(name: str, symbol: str, argtypes: Sequence):
    """The C function ``symbol`` of kernel library ``name``, built and loaded
    on first use, with ``argtypes`` set and an int (cudaError_t) result."""
    key = (name, symbol)
    if key not in _fns:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(_libs[name], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError`` != 0)."""
    if err != 0:
        lib = _libs[name]
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
