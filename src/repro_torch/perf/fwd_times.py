"""The attention forward kernel's times on the card (row 1 of the kernel
table in PERF.md).

At the serving path's prefill shape (B 8, 32/8 heads, S 512, D 64, causal)
and the training path's attention shape (B 4, S 2048), each in f32 and in
bf16, at the training shape with dropout 0.1 (the call the training path
makes), and at recurrentgemma-2b's prefill (B 4, 10/1 heads, S 3072, D 256,
causal, window 2048) in f32 and bf16, it measures:

* ``ms`` — CUDA events around back-to-back kernel calls on one input;
* ``device_ms`` — the kernel alone: ``torch.profiler``'s device time of the
  ``fwd_kernel`` launches of the same calls;
* ``library_ms`` — ``F.scaled_dot_product_attention`` in the same dtype
  with the same dropout rate (its own random bits; the window as a boolean
  mask), a yardstick the port never calls;
* the bounds: the larger of the bytes (q, k, v read once, o and the f32 lse
  written once) at 3.35 TB/s and the allowed pairs' 4 D flops at the
  dtype's tensor-core peak (TF32 495, bf16 989 TFLOP/s), and for f32 the
  same at three TF32 products a product (``bound_ms_3xtf32``).

Run from the root of a checkout on a machine with the card and nvcc::

    PYTHONPATH=src python3 -m repro_torch.perf.fwd_times [--parent DIR]

``--cases NAME ...`` times only those cases (the hybrid's need a tree
whose kernel takes D 256). ``--parent DIR`` names another tree's
``kernels/csrc`` (its
``flash_fwd.cu`` and headers): that kernel is built into
``build/kernels/fwd_times/`` and timed through the same C entry point beside
this tree's, in turns (parent, this, this, parent) in one process. It prints
the card's ``nvidia-smi`` name and power limit, a line a case and kernel, and
the results as one JSON line. ``chip_smoke.py`` (phase 6) adds this tree's
numbers to the ``flash_fwd`` row.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build, flash_fwd, rng
from repro_torch.perf.roofline import HBM_BW, PEAK_FLOPS
from repro_torch.perf.decode_times import device_ms, time_ms

#: shape -> (B, Hq, Hkv, S, D, window); every shape is causal
SHAPES = {"prefill": (8, 32, 8, 512, 64, None), "train": (4, 32, 8, 2048, 64, None),
          "hybrid_prefill": (4, 10, 1, 3072, 256, 2048)}
#: case name -> (shape, dtype, dropout rate)
CASES = {
    "prefill_f32": ("prefill", torch.float32, 0.0),
    "prefill_bf16": ("prefill", torch.bfloat16, 0.0),
    "train_f32": ("train", torch.float32, 0.0),
    "train_bf16": ("train", torch.bfloat16, 0.0),
    "train_dropout_f32": ("train", torch.float32, 0.1),
    "train_dropout_bf16": ("train", torch.bfloat16, 0.1),
    "hybrid_prefill_f32": ("hybrid_prefill", torch.float32, 0.0),
    "hybrid_prefill_bf16": ("hybrid_prefill", torch.bfloat16, 0.0),
}


def causal_pairs(s: int, window=None) -> int:
    """(q, k) pairs a head may read under causal masking and a window."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window
OUT = _build.BUILD_DIR / "fwd_times"


def bounds(shape: str, dtype) -> dict:
    """The case's bound: bytes or tensor-core operations, whichever is the
    longer (``bound_ms``, ``bound_by``); for f32 also at 3xTF32."""
    b, hq, hkv, s, d, window = SHAPES[shape]
    flops = 4 * b * hq * d * causal_pairs(s, window)   # QK^T and PV on allowed pairs
    el = torch.tensor([], dtype=dtype).element_size()
    nbytes = el * (2 * b * hq * s * d + 2 * b * hkv * s * d) + 4 * b * hq * s
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    out = {"bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops > t_bytes else "bytes"}
    if dtype == torch.float32:
        out["bound_ms_3xtf32"] = max(3 * t_ops, t_bytes) * 1e3
    return out


def library_fn(path: Path):
    """``flash_fwd_launch`` of the kernel library at ``path``."""
    fn = ctypes.CDLL(str(Path(path).resolve())).flash_fwd_launch
    fn.argtypes, fn.restype = flash_fwd._ARGTYPES, ctypes.c_int
    return fn


def raw_call(fn, q, k, v, o, lse, dropout_rate: float = 0.0, seed: int = 0,
             window=None):
    """One causal launch of a ``flash_fwd_launch`` (no segments) into ``o``
    and ``lse``; raises on a CUDA error."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
             *([None] * 6), b, hq, hkv, sq, skv, d, flash_fwd.DTYPES[q.dtype], 0,
             d ** -0.5, 1, window or 0, int(dropout_rate > 0.0), seed,
             rng.keep_threshold(dropout_rate), 1.0 - dropout_rate, 0, 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd_launch: CUDA error {err}")


def build_parent(csrc: Path) -> Path:
    """Build ``csrc/flash_fwd.cu`` of another tree into a library."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "parent.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(csrc / "flash_fwd.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"the parent's flash_fwd.cu did not build:\n{out.stdout}{out.stderr}")
    return lib


def inputs(shape: str, dtype, seed: int = 0):
    b, hq, hkv, s, d, _ = SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


def sdpa_mask(s: int, window):
    """SDPA's boolean mask of causal pairs inside ``window`` [S, S], or None
    (then ``is_causal``)."""
    if window is None:
        return None
    pos = torch.arange(s, device="cuda")
    return (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)


def measure(fns: dict, cases=tuple(CASES)) -> dict:
    """{case: {kernel name: {ms, device_ms, device_ms_method}, "library_ms",
    bounds}} for each kernel of ``fns`` (name -> ``flash_fwd_launch``), in
    the order given, on the same inputs, at ``cases``."""
    import torch.nn.functional as F

    res = {}
    for case in cases:
        shape, dtype, rate = CASES[case]
        window = SHAPES[shape][5]
        long = shape != "prefill"
        q, k, v = inputs(shape, dtype)
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
        row = dict(bounds(shape, dtype))
        for name, fn in fns.items():
            call = lambda fn=fn: raw_call(fn, q, k, v, o, lse, rate, 11,  # noqa: E731
                                          window)
            dev, how = device_ms([call], reps=30 if long else 100,
                                 kernel="fwd_kernel")
            row[name] = {"ms": time_ms(call, 10 if long else 30),
                         "device_ms": dev, "device_ms_method": how}
        mask = sdpa_mask(q.shape[2], window)
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=rate, is_causal=mask is None,
            enable_gqa=True), 10 if long else 30)
        res[case] = row
        del q, k, v, o, lse
    torch.cuda.empty_cache()
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another tree's kernels/csrc, timed beside this tree's")
    ap.add_argument("--cases", nargs="+", choices=list(CASES), default=list(CASES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fwd_times needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    this = library_fn(_build.build(["flash_fwd"])["flash_fwd"])
    if args.parent is None:
        fns = {"this": this}
    else:
        parent = library_fn(build_parent(args.parent))
        fns = {"parent": parent, "this": this, "this_again": this, "parent_again": parent}
    res = measure(fns, args.cases)
    for case, row in res.items():
        for name in fns:
            r = row[name]
            print(f"[fwd_times] {case} {name}: device {r['device_ms']:.5f} ms "
                  f"({r['device_ms_method']}), events {r['ms']:.5f} ms; sdpa "
                  f"{row['library_ms']:.5f} ms; bound {row['bound_ms']:.5f} ms "
                  f"({row['bound_by']})"
                  + (f", 3xTF32 {row['bound_ms_3xtf32']:.5f} ms"
                     if "bound_ms_3xtf32" in row else ""), flush=True)
    print(json.dumps({"nvidia_smi": smi.stdout.strip(), "cases": res}))


if __name__ == "__main__":
    main()
