"""Where the attention forward kernel's time goes, by ablation, on the card.

Builds variants of ``kernels/csrc/flash_fwd.cu`` (D 64 only), each with one
part of the work cut out or changed by a text edit of a copy (of the source
or of ``csrc/mma.cuh``, whichever holds the text), and times each at the
training shape (B 4, 32/8 heads, S 2048, D 64, causal) in f32 and bf16, and
with dropout 0.1 in f32 (the training path's call). A variant's results are
wrong by design where it cuts work: only its time means something, as the
time its missing part took (base minus variant, the parts overlapping). The
layout variants (q order, persistent blocks, warps, ring stages, register
caps) compute the same function and are the alternatives the design was
chosen against. Run from the root of a checkout on a machine with the card
and nvcc:

    PYTHONPATH=src python3 -m repro_torch.perf.fwd_ablation [--variants NAME ...]
"""

from __future__ import annotations

import argparse
import re
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.perf import fwd_times
from repro_torch.perf.decode_times import device_ms

OUT = _build.BUILD_DIR / "fwd_ablation"
_QK = ("        M::mma(s[j], a, M::make_b(rb[0], rb[1]));\n"
       "        M::mma(s[j + 1], a, M::make_b(rb[2], rb[3]));\n")
_PV = ("          M::mma(pv[j], a, M::make_b(rb[0], rb[1]));\n"
       "          M::mma(pv[j + 1], a, M::make_b(rb[2], rb[3]));\n")
_MINB = "sizeof(T) == 2 && D <= 64 ? 3 : 1;"
#: variant -> text edits of the source (old, new)
VARIANTS = {
    "base": [],
    "no QK^T products": [(_QK, "")],
    "no P V products": [(_PV, "")],
    "no exp": [("s[j][e] = ex2(s[j][e] - m_safe);", "s[j][e] = s[j][e] - m_safe;")],
    "no dropout hash": [("mix32(mix32(x) * M3 + GOLDEN) >= p.threshold", "x >= p.threshold")],
    "no masks": [("    if (inside)\n", "    if (true)\n")],
    "no K/V loads": [("      load_kv(t_ld, n_ld % NST);\n", "")],
    "no per-warp skip": [("    if (!live || (p.causal && kv_start > qw + 15) ||",
                          "    if (!live || (p.causal && kv_start > qw + 1000000) ||")],
    "natural q order": [("  const int iq = p.nq - 1 - (int)(blockIdx.x / (p.B * p.Hq));",
                         "  const int iq = (int)(blockIdx.x / (p.B * p.Hq));")],
    # one block per resident slot, walking the q tiles heavy first with a
    # stride of the grid (a static schedule; no atomics)
    "persistent blocks": [
        ("  // heavy tiles first: q tile major, from the last q tile down\n"
         "  const int bh = (int)(blockIdx.x % (p.B * p.Hq));\n"
         "  const int iq = p.nq - 1 - (int)(blockIdx.x / (p.B * p.Hq));\n",
         "  for (int item = blockIdx.x; item < p.nq * p.B * p.Hq; item += gridDim.x) {\n"
         "  __syncthreads();\n"
         "  const int bh = item % (p.B * p.Hq);\n"
         "  const int iq = p.nq - 1 - item / (p.B * p.Hq);\n"),
        ("  if (!live) return;\n", "  if (live) {\n"),
        ("m[r] * LN2 + logf(l_safe);\n  }\n}\n", "m[r] * LN2 + logf(l_safe);\n  }\n  }\n  }\n}\n"),
        ("  const unsigned blocks = (unsigned)p.nq * p.Hq * p.B;\n",
         "  int per_sm = 0, dev = 0, sms = 0;\n"
         "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fwd_kernel<T, D, ACC16>,"
         " C::NT, C::SMEM);\n"
         "  cudaGetDevice(&dev);\n"
         "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
         "  const unsigned all = (unsigned)p.nq * p.Hq * p.B, cap = (unsigned)(per_sm * sms);\n"
         "  const unsigned blocks = all < cap ? all : cap;\n")],
    "8 warps a block": [("  static constexpr int NW = 4;", "  static constexpr int NW = 8;")],
    "3 ring stages": [("  static constexpr int NST = 2;", "  static constexpr int NST = 3;")],
    "no register cap (bf16)": [(_MINB, "sizeof(T) == 2 && D <= 64 ? 1 : 1;")],
    "4 blocks an SM (bf16)": [(_MINB, "sizeof(T) == 2 && D <= 64 ? 4 : 1;")],
    "Q from shared, 4 blocks an SM (bf16)": [
        (_MINB, "sizeof(T) == 2 && D <= 64 ? 4 : 1;"),
        ("QREG = (int)sizeof(T) * D <= 256;", "QREG = sizeof(T) == 4 && D <= 64;")],
    "Q from shared, 3 blocks an SM (f32)": [
        (_MINB, "D <= 64 ? 3 : 1;"),
        ("QREG = (int)sizeof(T) * D <= 256;", "QREG = sizeof(T) == 2;")],
    "one TF32 product (f32)": [("    one(c, a.lo, b.hi);\n    one(c, a.hi, b.lo);\n", "")],
}
CASES = ("train_f32", "train_bf16", "train_dropout_f32")


def build(names) -> dict:
    """{variant: library path} for ``names``, one nvcc each, all at once."""
    procs = {}
    for i, name in enumerate(names):
        cu = _build.write_variant("flash_fwd", VARIANTS[name], OUT / f"v{i}")
        cu.write_text(re.sub(
            r"    case (16|32|128): return launch<T, \d+, ACC16>\(p, stream\);\n",
            "", cu.read_text()))
        lib = OUT / f"v{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{out}")
        regs = [ln.split(":", 1)[-1].strip() for ln in out.splitlines()
                if "registers" in ln or ("spill" in ln and " 0 bytes spill s" not in ln)]
        print(f"[fwd_ablation] {name}: ptxas {'; '.join(regs)}")
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fwd_ablation needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    names = ["base"] + [n for n in args.variants if n != "base"]
    fns = {n: fwd_times.library_fn(lib) for n, lib in build(names).items()}
    for case in CASES:
        shape, dtype, rate = fwd_times.CASES[case]
        q, k, v = fwd_times.inputs(shape, dtype)
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
        base = None
        for name, fn in fns.items():
            call = lambda fn=fn: fwd_times.raw_call(fn, q, k, v, o, lse, rate, 11)  # noqa: E731
            ms, how = device_ms([call], reps=30, kernel="fwd_kernel")
            base = ms if base is None else base
            print(f"[fwd_ablation] {case} {name}: {ms:.5f} ms ({how}; "
                  f"{base - ms:+.5f} ms against base)", flush=True)
        del q, k, v, o, lse


if __name__ == "__main__":
    main()
