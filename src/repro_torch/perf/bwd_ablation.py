"""Where the fused backward kernel's time goes, by ablation, on the card.

Builds variants of ``kernels/csrc/flash_bwd.cu`` (one head dim), each
with one part of the work cut out by a text edit of a copy (of the source
or of ``csrc/mma.cuh``, whichever holds the text), and times each at
granite-3-2b's training shape (B 4, 32/8 heads, S 2048, D 64, causal) or,
with ``--hybrid``, recurrentgemma-2b's (B 1, 10/1 heads, S 3072, D 256,
causal, window 2048: 32-row kv blocks, four warps on each 16 rows), in f32
and bf16. A variant's results are wrong by design: only its time means
something, as the time its missing part took (base minus variant, the
parts overlapping). Run from the root of a checkout on a machine with the
card and nvcc:

    PYTHONPATH=src python3 -m repro_torch.perf.bwd_ablation [--hybrid]
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build, flash_bwd, flash_fwd

OUT = _build.BUILD_DIR / "ablation"
#: name -> (B, Hq, Hkv, S, D, window) of a timed shape
SHAPES = {"train": (4, 32, 8, 2048, 64, None),
          "hybrid": (1, 10, 1, 3072, 256, 2048)}
_ATOMIC = ("      if (qr < p.Sq)\n        atomicAdd(",
           "      if (qr < p.Sq && v.x == 1.2345e-30f)\n        atomicAdd(")
#: the dQ adds as one scalar atomic an element (the kernel before its
#: 16-byte vector atomics)
_SCALAR = ("""      if (qr < p.Sq)
        atomicAdd(reinterpret_cast<float4*>(dqg + (size_t)qr * D + dn0 + 8 * j + 2 * (t & ~1)), v);
""", """      (void)v;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = q0 + qm0 + g + 8 * (e >> 1);
        if (r < p.Sq) atomicAdd(dqg + (size_t)r * D + dn0 + 8 * j + 2 * t + (e & 1), dq[j][e]);
      }
""")
#: variant -> text edits of the source (old, new)
VARIANTS = {
    "base": [],
    "scalar dQ atomics": [_SCALAR],
    "no dQ atomics": [_ATOMIC],
    "no dQ product, no atomics": [
        ("kc < BKV; kc += KCQ", "kc < 0; kc += KCQ"), _ATOMIC],
    "no dV, dK products": [
        ("      warp_gemm<T, DW / 8, BQ, false, true>(tmp, sP, LDP, r0, do_s, LD, "
         "d0, 0, lane);\n", ""),
        ("      warp_gemm<T, DW / 8, BQ, false, true>(tmp, sdS, LDP, r0, q_s, LD, "
         "d0, 0, lane);\n", "")],
    "no S, dP products": [
        ("    warp_gemm<T, QW / 8, D, false, false>(s, sK, LD, r0, q_s, LD, c0, 0, "
         "lane);\n", ""),
        ("    warp_gemm<T, QW / 8, D, false, false>(dp, sV, LD, r0, do_s, LD, c0, "
         "0, lane);\n", "")],
    "no exp": [("__expf(sv * p.scale - lse_safe)", "(sv * p.scale - lse_safe)")],
    "one TF32 product (f32)": [("    one(c, a.lo, b.hi);\n    one(c, a.hi, b.lo);\n",
                                "")],
}


def build(d: int = 64) -> dict:
    """{variant: library path} instantiated at head dim ``d`` only, one
    nvcc each, all at once."""
    others = "|".join(str(x) for x in flash_bwd.HEAD_DIMS if x != d)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        cu = _build.write_variant("flash_bwd", edits, OUT / f"d{d}_v{i}")
        cu.write_text(re.sub(
            rf"    case ({others}): return launch<T, \d+, ACC16>\(p, stream\);\n",
            "", cu.read_text()))
        lib = OUT / f"d{d}_v{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{out}")
        libs[name] = lib
    return libs


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hybrid", action="store_true",
                    help="recurrentgemma-2b's training shape (D 256)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_ablation needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    b, hq, hkv, s, d, window = SHAPES["hybrid" if args.hybrid else "train"]
    print(f"[ablation] B {b}, {hq}/{hkv} heads, S {s}, D {d}, causal, window "
          f"{window}", flush=True)
    libs = build(d)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        q, do = (torch.randn((b, hq, s, d), generator=gen, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        o, lse = flash_fwd.flash_fwd(q, k, v, causal=True, window=window)
        delta = flash_bwd.row_delta(o, do).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        base = None
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(Path(lib).resolve())).flash_bwd_launch
            fn.argtypes, fn.restype = flash_bwd._ARGTYPES, ctypes.c_int

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                         lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                         dk.data_ptr(), dv.data_ptr(), *([None] * 6), b, hq, hkv,
                         s, s, d, flash_fwd.DTYPES[dtype], 0, d ** -0.5, 1,
                         window or 0, 0, 0, 0, 1.0, 0, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name!r}: CUDA error {err}")
            ms = time_ms(call)
            base = ms if base is None else base
            print(f"[ablation] {str(dtype).split('.')[-1]} {name}: {ms:.4f} ms "
                  f"({base - ms:+.4f} ms against base)", flush=True)


if __name__ == "__main__":
    main()
