"""Where the decode template's time goes, by ablation, on the card.

Builds variants of ``kernels/csrc/flash_decode.cu``, each with one part of
the work cut out or one launch choice changed by a text edit of a copy, and
times each (``decode_times.device_ms``: the kernel alone, cold L2) at the
paged engine's decode shape and at a 256-token chunk's shape, f32. A
variant that cuts work is wrong by design: only its time means something.
The ``timeline`` variant stamps the global timer at points of every block
and prints each phase's median and largest duration, and when blocks
start. Run from the root of a checkout on a machine with the card and
nvcc::

    PYTHONPATH=src python3 -m repro_torch.perf.decode_ablation [--variants NAME ...]
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build, decode
from repro_torch.perf import decode_times as dt

OUT = _build.BUILD_DIR / "decode_ablation"
# a timeline: thread 0 of each block stamps %globaltimer at nine points
# into acc_part (which a launch with o ignores), and its SM id last
_STAMP = ("if (tid == 0) {{ unsigned long long t_; asm volatile(\"mov.u64 %0, "
          "%%globaltimer;\" : \"=l\"(t_)); tl_[{}] = t_; }}\n")
TL = 16      # slots a block
TIMELINE = [
    ("  const int nrows = min(p.R, p.B - r0);\n",
     "  const int nrows = min(p.R, p.B - r0);\n"
     "  unsigned long long* tl_ = reinterpret_cast<unsigned long long*>(p.acc_part) +"
     f" ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * {TL};\n"
     + _STAMP.format(0) +
     "  if (tid == 0) { unsigned s_; asm volatile(\"mov.u32 %0, %%smid;\" : "
     f"\"=r\"(s_)); tl_[{TL - 1}] = s_; }}\n"),
    ("  for (int ra = 0; ra < nrows;) {\n", _STAMP.format(1) + "  for (int ra = 0; ra < nrows;) {\n"),
    ("    // this thread's query rows: their readable positions [lo, hi)\n",
     _STAMP.format(2) + "    // this thread's query rows: their readable positions [lo, hi)\n"),
    ("        ++n_ld;\n", "        ++n_ld;\n        if (n_ld == 1) " + _STAMP.format(3)),
    ("    while (n_cp < n_ld) {\n", _STAMP.format(4) + "    while (n_cp < n_ld) {\n"),
    ("stage (n_cp - 1) % NSTAGE free\n",
     "stage (n_cp - 1) % NSTAGE free\n      if (n_cp == 0) " + _STAMP.format(5)),
    ("    cp_async_wait<0>();\n", "    cp_async_wait<0>();\n" + _STAMP.format(6)),
    ("      cluster.sync();\n      if (rank == 0) {",
     "      cluster.sync();\n" + _STAMP.format(7) + "      if (rank == 0) {"),
    ("    ra = rb;\n", _STAMP.format(8) + "    ra = rb;\n"),
]
PHASES = ("setup", "run bounds", "offsets + first copies issued",
          "next offsets resolved, q loaded", "first tile landed", "tiles done",
          "first cluster sync", "merge + write")


#: variant -> text edits of the source (old, new)
VARIANTS = {
    "base": [],
    "timeline": TIMELINE,
    "no scores, softmax or P.V": [("      if (busy) {", "      if (busy && p.scale == 1234.5f) {")],
    "no K/V reads (zero-filled)": [("        const bool ld = off[k] >= 0;",
                                    "        const bool ld = false;")],
    "one block a cluster": [("  p.C = c;", "  p.C = 1;")],
    "no query tiles": [("  p.R = row_tokens <= 1 ? 1 :", "  p.R = true ? 1 :")],
    "no cluster merge": [("    if (p.C > 1) {", "    if (p.C > 1 && p.scale == 1234.5f) {")],
    "an empty kernel": [("  cg::cluster_group cluster = cg::this_cluster();",
                         "  if (p.scale != 1234.5f) return;\n"
                         "  cg::cluster_group cluster = cg::this_cluster();")],
}


def build(names) -> dict:
    """{variant: library path} for ``names``, one nvcc each, all at once."""
    procs = {}
    for i, name in enumerate(names):
        cu = _build.write_variant("flash_decode", VARIANTS[name], OUT / f"v{i}")
        lib = OUT / f"v{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{out}")
        libs[name] = lib
        lines = out.splitlines()     # ptxas: the f32 D 64 paged kernels
        for i, line in enumerate(lines):
            if "decode_kernelIfLi64ENS_10PagedCache" in line:
                print(f"[decode_ablation] {name}: tiled {line.split('ELb')[-1][:1]}: "
                      f"{' '.join(x.strip() for x in lines[i + 1:i + 3])}")
    return libs


_stamps = None


def timeline(stamps, nblocks: int) -> str:
    """The timeline variant's stamps of one launch, summarised: when blocks
    start (waves), each phase's median and largest duration, the SMs used
    and the most blocks an SM held."""
    import numpy as np
    t = stamps[:nblocks * TL].view(nblocks, TL).cpu().numpy().astype(np.int64)
    start = t[:, 0] - t[:, 0].min()
    end = len(PHASES)
    out = [f"{nblocks} blocks on {len(set(t[:, TL - 1].tolist()))} SMs; start "
           f"us p50 {np.median(start) / 1e3:.2f} max {start.max() / 1e3:.2f}; end "
           f"us max {(t[:, end] - t[:, 0].min()).max() / 1e3:.2f}"]
    for k, name in enumerate(PHASES):
        d = t[:, k + 1] - t[:, k]
        d = d[(t[:, k + 1] > 0) & (t[:, k] > 0)]
        if d.size:
            out.append(f"{name} us p50 {np.median(d) / 1e3:.2f} max {d.max() / 1e3:.2f}")
    return "; ".join(out)


def _paged_calls(lib, q, kp, vp, tables, kv_len, row_tokens):
    """One zero-argument launch of ``lib``'s paged decode per table set."""
    fn = lib.flash_paged_decode_launch
    fn.argtypes, fn.restype = decode._PAGED_ARGTYPES, ctypes.c_int
    hkv, n_pages, ps, d = kp.shape
    b, hq, _ = q.shape
    o = torch.empty_like(q)

    def call(bt):
        err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                 kv_len.data_ptr(), o.data_ptr(), _stamps.data_ptr(), None, None,
                 b, hq, hkv,
                 n_pages, ps, bt.shape[1], d, 0, d ** -0.5, 0, 1, row_tokens,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return [dt.warmed(lambda bt=bt: call(bt), q, kv_len, bt) for bt in tables]


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    help="variant names, each one argument (default: all)")
    names = ap.parse_args(argv).variants
    if not torch.cuda.is_available():
        raise SystemExit("decode_ablation needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    global _stamps
    _stamps = torch.zeros(1 << 16, dtype=torch.int64, device="cuda")
    libs = {name: ctypes.CDLL(str(Path(p).resolve()))
            for name, p in build(names).items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = {
        "decode": (torch.randint(528, 577, (8,), generator=gen, device="cuda",
                                 dtype=torch.int32), False),
        "chunk": (torch.arange(301, 557, device="cuda", dtype=torch.int32), True),
    }
    for shape, (kv_len, shared) in shapes.items():
        read = 2 * 4 * dt.HKV * dt.D * dt.PS * dt.T * (1 if shared else 8)
        row_tokens = kv_len.shape[0] if shared else 1     # a chunk: one batch row
        q, kp, vp, tables, _ = dt.paged_inputs(kv_len, rows_per_table=row_tokens,
                                               copies=dt._copies(read))
        base = None
        for name, lib in libs.items():
            calls = _paged_calls(lib, q, kp, vp, tables, kv_len, row_tokens)
            ms, how = dt.device_ms(calls)
            base = ms if base is None else base
            print(f"[decode_ablation] paged {shape} {name}: {ms:.5f} ms ({how}, "
                  f"cold L2; {base - ms:+.5f} ms against base)", flush=True)
            if name == "timeline":
                _stamps.zero_()
                calls[0]()
                torch.cuda.synchronize()
                geo = decode.launch_geometry(q.shape[0], q.shape[1], kp.shape[0],
                                             tables[0].shape[1] * kp.shape[2],
                                             row_tokens=row_tokens)
                print(f"[decode_ablation] paged {shape} timeline ({geo}): "
                      f"{timeline(_stamps, geo['blocks'])}", flush=True)
        del q, kp, vp, tables


if __name__ == "__main__":
    main()
