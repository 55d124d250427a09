#!/usr/bin/env python3
"""Build and drive the PyTorch / CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device  — the card's name, count, and ``nvidia-smi`` name / power limit;
2. build   — nvcc builds the three CUDA kernel libraries from
             ``kernels/csrc`` in parallel and prints ptxas's registers and
             spills per instantiation (the f32 and bf16 D=64 backward
             kernel, the training path's, must not spill) and the count of
             tensor-core instructions (HMMA / HGMMA in ``cuobjdump -sass``)
             of those two, which must not be 0;
3. kernels — each CUDA kernel against its plain-torch version on the same
             inputs, f32 and bf16: the forward and decode at granite-3-2b's
             prefill / decode shapes, the fused backward kernel at its
             training shape (B 4, 32/8 heads, S 2048, D 64, causal), plus
             window, segments, dropout, ragged, q-suffix, head-dim-128 /
             GQA-5 and bf16-ACC cases, and against the naive oracle (autograd
             of it for the backward) on a small input; the backward twice on
             the same inputs (dK, dV bit-equal, dQ within tolerance: its
             atomic adds run in another order); the paged decode at
             page sizes 4, 16 and 32, groups 4 and 5, ragged lengths with 0,
             a 1e6-poisoned trash page past each allocation and out of the
             window, 1 and 3 splits and 256 chunk-prefill token rows, and
             bit for bit against the contiguous kernel on the gathered pages;
             the gated paged decode (one shard of a sharded pool, raw
             partials) at the same cases with about half the table entries
             foreign and their pages 1e6, and two shards' partials (local
             pools, tables remapped to local ids, local trash pages 1e6)
             merged against the ungated kernel on the whole pool;
4. serve   — (a) the contiguous serving path (``launch/serve.py``:
             ``make_serve_steps`` + ``greedy_generate``) on granite-3-2b at
             full width and depth (40 layers, f32, random weights from a
             seed), batch 8, prompt 512, 32 generated tokens, once with
             ``impl="kernel"`` and once with ``impl="torch"`` fed the kernel
             run's tokens; the launch counters must read 40 ``flash_fwd`` and
             40 × 31 ``flash_decode`` launches; (b) the paged path
             (``serving.ServingEngine``, page 16, 8 slots) at the same size
             on 16 seeded requests in four modes (eager; lazy on half the
             pool, which must preempt; shared 256-token system prompt with
             256-token chunked prefill; speculation k 4 on motif prompts),
             each with ``impl="kernel"`` and ``impl="torch"``: every request
             completes, ``flash_fwd`` launches 40 × prefill calls and the
             paged kernel 40 × (decode + chunk + verify calls), and the
             tokens equal the torch run's up to a printed near-tie; (c) the
             distributed paged engine (``ServingEngine(mesh=)``): two ranks
             spawned on the one card with gloo (NCCL refuses two ranks on a
             device), each with the whole model and half of every layer's
             page pool (``--dist-ranks``, ``--dist-backend`` change that), first probing gloo's CUDA all_reduce (MAX, SUM) and
             a page copy across shards, then three of (b)'s modes (eager,
             lazy, prefix + chunk): tokens equal on both ranks and to (b)'s
             kernel run up to a printed near-tie, the gated kernel launched
             40 × (decode + chunk + verify calls) on each rank and the
             ungated one never; host time in the merge collectives;
5. train   — the port's training path on granite-3-2b at full width and
             depth (f32, remat, dropout 0.1, batch 4 × 2048 from
             ``make_batch``): (a) one loss-and-grad pass with
             ``impl="kernel"`` against one with ``impl="torch"`` on the same
             params and batch, the counters reading 80 / 40 launches of
             ``flash_fwd`` / ``flash_bwd`` (forward plus recompute) and 0
             for the torch impl; (b) 4 steps of ``make_train_step`` with the
             counters reset before and read after, then one step under
             ``torch.profiler`` (device time by kernel group, busy share);
             (c) the ``Trainer`` at SMOKE size: 2 steps, a preemption, a
             resume for 2 more;
6. times   — each kernel at its path's shapes beside its plain version, one
             PyTorch library call computing the same function
             (``scaled_dot_product_attention`` forward, or its whole
             backward for the fused backward kernel, in f32 and in bf16 at
             the training shape; on the contiguous equivalent for the
             paged decode, gather excluded; aten's memory-efficient attention
             with its log-sum-exp on the owned rows for the gated kernel: a
             yardstick the port never calls) and its bound at the tensor-core
             peak of its dtype (beside the bound without tensor cores),
             printed as one JSON line.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout, it exits non-zero before printing any result.

``python3 chip_smoke.py --dist-ranks 4 --dist-backend nccl`` on a machine
with four cards gives phase 4c a card a rank and NCCL; every other phase
runs on ``cuda:0`` as without the flags.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): device memory 3.35 TB/s;
# tensor cores 495 TFLOP/s TF32 (the f32 rows: an f32 product on tensor
# cores goes through TF32) and 989 TFLOP/s bf16; 67 TFLOP/s float32 without
# tensor cores, kept beside each bound as ``bound_ms_no_tensor_cores``.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_FLOPS_NO_TENSOR_CORES = 67e12

# kernel vs plain version on the same inputs (module docstrings of
# kernels/flash_fwd.py and kernels/decode.py): both compute in f32 and fold
# the same tiles, so they differ only in the order of f32 sums.
TOL = {
    # the JAX suite's f32 attention tolerance (tests/test_kernel_fwd.py)
    "float32": 2e-5,
    # two bf16 ulps at |o| <= 1: both sides round P and o to bf16, and a
    # probability that lands on the other side of a rounding boundary moves
    # o by about one ulp
    "bfloat16": 2.0 ** -6,
}
LSE_TOL = 1e-4       # f32 lse ~ log(Skv) + max score ~ 10: ten f32 ulps there
# serving path kernel vs torch impl: 40 layers of f32 with differently
# ordered sums (kernel tiles vs cuBLAS / chunked torch) move logits by ~1e-6
# relative; 1e-3 of the largest logit leaves room for that and still catches
# a kernel that is wrong anywhere on the path
LOGIT_REL_TOL = 1e-3
# backward kernel vs plain version, relative to max(1, max|plain|): f32 the
# JAX suite's gradient tolerance (dK and dV sum over up to 2048 q rows and a
# group of 4 in another order); bf16 inputs or bf16-ACC two bf16 ulps (P~,
# dS, the tile products and the outputs are rounded to bf16 on both sides)
BWD_TOL = {"float32": 5e-5, "bfloat16": 2.0 ** -6}
# training pass kernel vs torch impl on one state and batch (40 layers of
# f32 with sums in another order): loss relative, global grad norm relative,
# and selected leaves relative to each leaf's max
TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "leaf": 1e-3}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4
TRAIN_LEAVES = ("blocks.0.mixer.wq", "blocks.0.mixer.wk", "blocks.0.mixer.wv",
                "lm_head")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed ({out.returncode}): {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dist-ranks", type=int, default=DIST_RANKS,
                    help="ranks of phase 4c (rank r on cuda:(r %% cards))")
    ap.add_argument("--dist-backend", default="gloo", choices=("gloo", "nccl"),
                    help="phase 4c's backend: gloo for ranks sharing a card, "
                         "nccl for a card a rank")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch not found next to chip_smoke.py: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")

    # ---------------- phase 1: device ----------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"[device] {name}; count {count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi, flush=True)
    # f32 products in full f32: the plain versions and the model's
    # projections must not drop to TF32 (about three decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import flash_bwd as kbwd
    from repro_torch.kernels import flash_fwd as kfwd

    # ---------------- phase 2: build ----------------
    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
          f"{time.perf_counter() - t0:.1f} s")
    build_report(_build)

    # ---------------- phase 3: kernels vs plain versions ----------------
    errs = kernel_phase(torch, kfwd, kdecode)
    errs.update(paged_kernel_phase(torch, kdecode))
    errs.update(gated_kernel_phase(torch, kdecode))
    errs.update(bwd_kernel_phase(torch, kfwd, kbwd))

    # ---------------- phase 4: the serving paths ----------------
    launches = serve_phase(torch, kfwd, kdecode)
    paged_launches, paged_tokens = paged_serve_phase(torch, kfwd, kdecode)
    dist_launches = dist_serve_phase(torch, paged_tokens, args.dist_ranks,
                                     args.dist_backend)

    # ---------------- phase 5: the training path ----------------
    train_launches = train_phase(torch, kfwd, kbwd)

    # ---------------- phase 6: times ----------------
    rows = times_phase(torch, kfwd, kdecode, launches, errs)
    rows.append(bwd_times_phase(torch, kfwd, kbwd, train_launches, rows[0]))
    rows.append(paged_times_phase(torch, kdecode, paged_launches, errs))
    rows.append(gated_times_phase(torch, kdecode, dist_launches, errs))
    rows[0]["launches_by_path"]["paged_serve"] = paged_launches["flash_fwd"]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


def bounds(flops: float, nbytes: float, dtype: str = "float32") -> dict:
    """The least time the card could take for ``flops`` operations on
    ``nbytes`` bytes: the larger of bytes over the memory rate and operations
    over the tensor-core peak of ``dtype`` (``bound_ms``), and the same at
    the f32 rate without tensor cores (``bound_ms_no_tensor_cores``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_tc = flops / PEAK_FLOPS[dtype]
    t_cc = flops / PEAK_FLOPS_NO_TENSOR_CORES
    return {"bound_ms": max(t_tc, t_bytes) * 1e3,
            "bound_by": "operations" if t_tc > t_bytes else "bytes",
            "bound_ms_no_tensor_cores": max(t_cc, t_bytes) * 1e3}


BWD_D64 = ("flash_bwd_kernel<f32, D64>", "flash_bwd_kernel<bf16, D64>")


def build_report(_build) -> None:
    """ptxas's registers and spills per kernel instantiation, and the
    tensor-core instructions of the backward kernel; fails if the f32 or
    bf16 D=64 backward kernel (the training path's) spills or has none."""
    import re
    for kname in _build.KERNELS:
        report = _build.ptxas_report.get(kname)
        if report is None:
            print(f"[build] {kname}: (already built)")
            continue
        entry, spills = None, ""
        for line in report.splitlines():
            if "Compiling entry" in line:
                m = re.search(r"\d+([a-z_]+_kernel)I(f|13__nv_bfloat16)Li(\d+)E"
                              r"(?:Lb([01]))?", line)
                entry = (f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}, "
                         f"D{m.group(3)}{', acc bf16' if m.group(4) == '1' else ''}"
                         f"{', paged' if 'PagedCache' in line else ''}>"
                         if m else line.split("'")[1][:60])
                continue
            if "spill" in line:
                spills = line.strip()
                n = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                              spills)
                if entry in BWD_D64 and (n is None or n.groups() != ("0", "0")):
                    fail(f"{kname} {entry} spills: {spills}")
                continue
            if "registers" in line:
                regs = line.split(":", 1)[-1].strip()
                print(f"[build] {kname} {entry}: {regs}; {spills}")
    mma = tensor_core_instructions(_build)
    for entry in BWD_D64:
        print(f"[build] flash_bwd {entry}: {mma.get(entry, 0)} tensor-core "
              f"instructions (HMMA / HGMMA in cuobjdump -sass)")
        if not mma.get(entry):
            fail(f"flash_bwd {entry} has no tensor-core instruction")
    sys.stdout.flush()


def tensor_core_instructions(_build) -> dict:
    """{"flash_bwd_kernel<f32, D64>": count, ...}: HMMA and HGMMA lines per
    ACC-f32 backward kernel in ``cuobjdump -sass`` of the built library."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = _build.build(["flash_bwd"])["flash_bwd"]
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed ({out.returncode}): {out.stderr[:500]}")
    counts = {}
    for part in out.stdout.split("Function : ")[1:]:
        m = re.match(r"\S*flash_bwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELb0E", part)
        if m:
            name = (f"flash_bwd_kernel<{'f32' if m.group(1) == 'f' else 'bf16'}, "
                    f"D{m.group(2)}>")
            counts[name] = sum("HMMA" in ln or "HGMMA" in ln
                               for ln in part.splitlines())
    return counts


def _rand(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def _fwd_inputs(torch, gen, b, hq, hkv, sq, skv, d, dtype):
    return (_rand(torch, gen, (b, hq, sq, d), dtype),
            _rand(torch, gen, (b, hkv, skv, d), dtype),
            _rand(torch, gen, (b, hkv, skv, d), dtype))


def _segments(torch, b, skv):
    """Four packed sequences per row of unequal length, then padding (-1)."""
    seg = torch.full((b, skv), -1, dtype=torch.int32, device="cuda")
    bounds = [0, skv // 5, skv // 2, 3 * skv // 4, skv - skv // 16]
    for i in range(4):
        seg[:, bounds[i]:bounds[i + 1]] = i
    return seg


def _maxerr(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_phase(torch, kfwd, kdecode):
    """Every case in f32 and bf16; returns {case: max |kernel - plain|}."""
    from repro_torch.kernels import ops, ref

    print("[kernels] tolerances, kernel vs plain version on the same inputs: "
          f"f32 {TOL['float32']:.0e} (the JAX suite's f32 attention "
          "tolerance; both sides compute in f32 over the same tiles and "
          f"differ only in the order of sums); bf16 {TOL['bfloat16']:.2e} "
          "(two bf16 ulps at |o| <= 1: both sides round P and o to bf16); "
          f"lse {LSE_TOL:.0e} (ten f32 ulps at lse ~ 10)")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    fwd_cases = [
        # name, b, hq, hkv, sq, skv, d, extra kwargs
        ("prefill_s512", 8, 32, 8, 512, 512, 64, dict(causal=True)),
        ("prefill_s2048", 8, 32, 8, 2048, 2048, 64, dict(causal=True)),
        ("window_128", 8, 32, 8, 512, 512, 64, dict(causal=True, window=128)),
        ("segments", 8, 32, 8, 512, 512, 64, dict(causal=True, segments=True)),
        ("dropout_0.1", 8, 32, 8, 512, 512, 64,
         dict(causal=True, dropout_rate=0.1, dropout_seed=-7)),
        ("ragged_500", 8, 32, 8, 500, 500, 64, dict(causal=True)),
        ("q_suffix_200_of_500", 8, 32, 8, 200, 500, 64, dict(causal=True)),
        ("d128_gqa5", 8, 40, 8, 512, 512, 128, dict(causal=True)),
    ]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for name, b, hq, hkv, sq, skv, d, kw in fwd_cases:
            kw = dict(kw)
            q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, sq, skv, d, dtype)
            if kw.pop("segments", False):
                kw["segment_ids"] = _segments(torch, b, skv)
            o, lse = kfwd.flash_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            o_ref, lse_ref = kfwd.flash_fwd_torch(q, k, v, **kw)
            e, el = _maxerr(o, o_ref), _maxerr(lse, lse_ref)
            ok = e <= TOL[dn] and el <= LSE_TOL and bool(torch.isfinite(o).all())
            print(f"[kernels] flash_fwd {name} {dn}: max|o - plain| {e:.3e} "
                  f"(tol {TOL[dn]:.1e}), max|lse - plain| {el:.3e} "
                  f"(tol {LSE_TOL:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"flash_fwd {name} {dn} disagrees with its plain version")
            if "segment_ids" in kw and float(o[:, :, -(skv // 16):].abs().max()) != 0.0:
                fail("flash_fwd: padding rows (segment id -1) are not zero")
            errs[f"flash_fwd/{name}/{dn}"] = e
            del q, k, v, o, lse, o_ref, lse_ref

        kv_len = torch.tensor([4096, 4000, 2500, 1, 0, 1000, 129, 3333],
                              dtype=torch.int32, device="cuda")
        for name, hq, d, window in (("ragged", 32, 64, None),
                                    ("window_1000", 32, 64, 1000),
                                    ("d128_gqa5", 40, 128, None)):
            q = _rand(torch, gen, (8, hq, d), dtype)
            k = _rand(torch, gen, (8, 8, 4096, d), dtype)
            v = _rand(torch, gen, (8, 8, 4096, d), dtype)
            for ns in (1, 4):
                o = kdecode.flash_decode(q, k, v, kv_len=kv_len, window=window,
                                         num_splits=ns)
                torch.cuda.synchronize()
                o_ref = kdecode.flash_decode_torch(q, k, v, kv_len=kv_len,
                                                   window=window, num_splits=ns)
                e = _maxerr(o, o_ref)
                ok = e <= TOL[dn] and float(o[4].abs().max()) == 0.0
                print(f"[kernels] flash_decode {name} splits={ns} {dn}: "
                      f"max|o - plain| {e:.3e} (tol {TOL[dn]:.1e}), "
                      f"kv_len=0 row zero: {float(o[4].abs().max()) == 0.0} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"flash_decode {name} splits={ns} {dn} disagrees "
                         f"with its plain version")
                errs[f"flash_decode/{name}/ns{ns}/{dn}"] = e
            del q, k, v, o, o_ref

    # both kernels against the independent naive oracle, small f32 inputs
    q, k, v = _fwd_inputs(torch, gen, 2, 8, 2, 100, 300, 64, torch.float32)
    seg = _segments(torch, 2, 300)
    o, _ = kfwd.flash_fwd(q, k, v, causal=True, window=90, segment_ids=seg,
                          dropout_rate=0.2, dropout_seed=5)
    o_ref = ref.naive_mha(q, k, v, causal=True, window=90, segment_ids=seg,
                          dropout_rate=0.2, dropout_seed=5)
    e = _maxerr(o, o_ref)
    qd = q[:, :, 0].contiguous()
    kvl = torch.tensor([300, 77], dtype=torch.int32, device="cuda")
    od = kdecode.flash_decode(qd, k, v, kv_len=kvl, num_splits=3)
    ed = _maxerr(od, ops.decode_reference(qd, k, v, kv_len=kvl))
    print(f"[kernels] vs naive oracle (f32): flash_fwd {e:.3e}, "
          f"flash_decode {ed:.3e} (tol {TOL['float32']:.0e})")
    if max(e, ed) > TOL["float32"]:
        fail("a kernel disagrees with the naive oracle")
    torch.cuda.empty_cache()
    return errs


def _paged_case(torch, gen, kv_len, hq, hkv, d, ps, t, dtype, window=None):
    """q [B,Hq,D] and a pool whose rows own exactly the pages their kv_len
    (and, with a window, the window) reaches; every other table entry is the
    trash page 0, filled with 1e6 as the engine's poison hook fills it."""
    b = kv_len.shape[0]
    n_pages = 1 + b * t
    q = _rand(torch, gen, (b, hq, d), dtype)
    kp = _rand(torch, gen, (hkv, n_pages, ps, d), dtype)
    vp = _rand(torch, gen, (hkv, n_pages, ps, d), dtype)
    kp[:, 0], vp[:, 0] = 1e6, 1e6
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = perm.view(b, t).to(torch.int32)
    block = torch.arange(t, device="cuda")[None, :]
    owned = block < (kv_len[:, None] + ps - 1) // ps
    if window is not None:      # reclaimed: every position out of the window
        owned &= (block + 1) * ps - 1 > kv_len[:, None] - 1 - window
    bt = torch.where(owned, bt, 0).to(torch.int32).contiguous()
    return q, kp, vp, bt


def paged_kernel_phase(torch, kdecode):
    """The paged decode kernel against its plain version, f32 and bf16, and
    bit for bit against the contiguous kernel on the gathered pages."""
    gen = torch.Generator(device="cuda").manual_seed(2024)
    cases = [
        # name, kv_len, hq, hkv, d, page size, table width, window
        ("ps16_g4", [576, 0, 528, 1, 300, 129, 555, 17], 32, 8, 64, 16, 37, None),
        ("ps4_g5_d128", [592, 40, 0, 333], 40, 8, 128, 4, 148, None),
        ("ps32_g4_window", [600, 0, 256, 31, 500, 64, 449, 2], 32, 8, 64, 32, 19, 100),
        ("chunk_256_rows", [0] * 16 + list(range(301, 541)), 32, 8, 64, 16, 37, None),
    ]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for name, lens, hq, hkv, d, ps, t, window in cases:
            kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
            q, kp, vp, bt = _paged_case(torch, gen, kv_len, hq, hkv, d, ps, t,
                                        dtype, window)
            if name == "chunk_256_rows":     # every token row reads one table
                bt = bt[-1:].expand(len(lens), t).contiguous()
            kc, vc = kdecode.gather_pages(kp, bt), kdecode.gather_pages(vp, bt)
            zero = kv_len == 0
            for ns in (1, 3):
                o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len,
                                               window=window, num_splits=ns)
                torch.cuda.synchronize()
                o_ref = kdecode.flash_paged_decode_torch(
                    q, kp, vp, bt, kv_len=kv_len, window=window, num_splits=ns)
                o_contig = kdecode.flash_decode(q, kc, vc, kv_len=kv_len,
                                                window=window, num_splits=ns)
                e, ec = _maxerr(o, o_ref), _maxerr(o, o_contig)
                zero_ok = float(o[zero].abs().max()) == 0.0 if bool(zero.any()) else True
                ok = (e <= TOL[dn] and ec == 0.0 and zero_ok
                      and bool(torch.isfinite(o).all()))
                print(f"[kernels] flash_paged_decode {name} splits={ns} {dn}: "
                      f"max|o - plain| {e:.3e} (tol {TOL[dn]:.1e}), max|o - "
                      f"contiguous kernel on gathered pages| {ec:.1e} (must be "
                      f"0), kv_len=0 rows zero: {zero_ok}, trash page 1e6 "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"flash_paged_decode {name} splits={ns} {dn} disagrees "
                         f"with its plain version or the contiguous kernel")
                errs[f"flash_paged_decode/{name}/ns{ns}/{dn}"] = e
            del q, kp, vp, bt, kc, vc
    torch.cuda.empty_cache()
    return errs


def _sharded_case(torch, gen, kv_len, hq, hkv, d, ps, t, dtype, window=None):
    """q and a pool of two shards of ``n_local`` pages (trash pages 0 and
    n_local) whose rows own the pages their kv_len (and window) reach, the
    other entries naming the trash page 0; every trash page holds 1e6."""
    b = kv_len.shape[0]
    n_local = 1 + -(-b * t // 2)
    q = _rand(torch, gen, (b, hq, d), dtype)
    kp = _rand(torch, gen, (hkv, 2 * n_local, ps, d), dtype)
    vp = _rand(torch, gen, (hkv, 2 * n_local, ps, d), dtype)
    for pool in (kp, vp):
        pool[:, 0], pool[:, n_local] = 1e6, 1e6
    usable = torch.tensor([p for p in range(2 * n_local) if p % n_local],
                          device="cuda")
    perm = torch.randperm(usable.numel(), generator=gen, device="cuda")[:b * t]
    bt = usable[perm].view(b, t)
    block = torch.arange(t, device="cuda")[None, :]
    owned = block < (kv_len[:, None] + ps - 1) // ps
    if window is not None:      # reclaimed: every position out of the window
        owned &= (block + 1) * ps - 1 > kv_len[:, None] - 1 - window
    bt = torch.where(owned, bt, 0).to(torch.int32).contiguous()
    return q, kp, vp, bt, n_local


def _state_out(torch, acc, m, l):
    """A partial state's normalised output and log-sum-exp."""
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return acc / l_safe[..., None], m + torch.log(l_safe)


def gated_kernel_phase(torch, kdecode):
    """The gated paged kernel (one shard of a page-sharded pool) against its
    plain version, f32 and bf16: (a) a random half of the table entries
    not owned, their pages and the trash page filled with 1e6; (b) the pool
    cut into two shards (local pools, tables remapped to local ids, local
    trash pages 1e6), the shards' partials merged against the ungated paged
    kernel on the whole pool."""
    from repro_torch.core import online_softmax as osm
    from repro_torch.distributed.paged import _local_ids

    gen = torch.Generator(device="cuda").manual_seed(2025)
    cases = [
        # name, kv_len, hq, hkv, d, page size, table width, window
        ("ps16_g4", [576, 0, 528, 1, 300, 129, 555, 17], 32, 8, 64, 16, 37, None),
        ("ps4_g5_d128", [592, 40, 0, 333], 40, 8, 128, 4, 148, None),
        ("ps32_g4_window", [600, 0, 256, 31, 500, 64, 449, 2], 32, 8, 64, 32, 19, 100),
        ("chunk_256_rows", [0] * 16 + list(range(301, 541)), 32, 8, 64, 16, 37, None),
    ]
    errs, worst = {}, {"gate": 0.0, "lse": 0.0, "shards": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for name, lens, hq, hkv, d, ps, t, window in cases:
            kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
            q, kp, vp, bt, n_local = _sharded_case(torch, gen, kv_len, hq, hkv,
                                                   d, ps, t, dtype, window)
            if name == "chunk_256_rows":     # every token row reads one table
                bt = bt[-1:].expand(len(lens), t).contiguous()
            b = len(lens)
            for ns in (1, 3):
                # (a) the gate alone, on the whole pool
                valid = (torch.rand((b, t), generator=gen, device="cuda") < 0.5
                         ).to(torch.int32)
                if name == "chunk_256_rows":  # one table: one ownership
                    valid = valid[-1:].expand(b, t).contiguous()
                kpa, vpa = kp.clone(), vp.clone()
                foreign = bt[valid == 0].long()
                kpa[:, foreign], vpa[:, foreign] = 1e6, 1e6
                part = kdecode.flash_paged_decode_partials(
                    q, kpa, vpa, bt, kv_len, block_valid=valid, window=window,
                    num_splits=ns)
                torch.cuda.synchronize()
                ref = kdecode.flash_paged_decode_partials_torch(
                    q, kpa, vpa, bt, kv_len=kv_len, block_valid=valid,
                    window=window, num_splits=ns)
                (o, lse), (o_ref, lse_ref) = (_state_out(torch, *part),
                                              _state_out(torch, *ref))
                read = ref[2] > 0                       # rows that read something
                e = _maxerr(o, o_ref)
                el = _maxerr(lse[read], lse_ref[read]) if bool(read.any()) else 0.0
                empty_ok = (float(part[0][~read].abs().max()) == 0.0
                            and bool((part[1][~read] == -1e30).all())
                            ) if bool((~read).any()) else True
                ok_a = (e <= TOL[dn] and el <= LSE_TOL and empty_ok
                        and bool(torch.isfinite(o).all()))
                del kpa, vpa
                # (b) two shards merged against the ungated kernel, whole pool
                whole = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len,
                                                   window=window, num_splits=ns)
                states = []
                for shard in range(2):
                    lo = shard * n_local
                    bt_l, valid_l = _local_ids(bt, n_local, shard)
                    acc, m, l = kdecode.flash_paged_decode_partials(
                        q, kp[:, lo:lo + n_local].contiguous(),
                        vp[:, lo:lo + n_local].contiguous(), bt_l.contiguous(),
                        kv_len, block_valid=valid_l.contiguous(),
                        window=window, num_splits=ns)
                    states.append(osm.SoftmaxState(m=m, l=l, acc=acc))
                merged, _ = osm.finalize(osm.merge(*states), out_dtype=dtype)
                torch.cuda.synchronize()
                es = _maxerr(merged, whole)
                ok = ok_a and es <= TOL[dn]
                worst["gate"] = max(worst["gate"], e / TOL[dn])
                worst["lse"] = max(worst["lse"], el)
                worst["shards"] = max(worst["shards"], es / TOL[dn])
                print(f"[kernels] flash_paged_decode_partials {name} splits={ns} "
                      f"{dn}: ~half the entries foreign (1e6): max|o - plain| "
                      f"{e:.3e} (tol {TOL[dn]:.1e}), max|lse - plain| {el:.3e} "
                      f"(tol {LSE_TOL:.0e}), empty rows exact: {empty_ok}; two "
                      f"shards merged vs the paged kernel on the whole pool "
                      f"{es:.3e} (tol {TOL[dn]:.1e}) {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    fail(f"flash_paged_decode_partials {name} splits={ns} {dn} "
                         f"disagrees with its plain version or the paged kernel")
                errs[f"flash_paged_decode_partials/{name}/ns{ns}/{dn}"] = e
                errs[f"flash_paged_decode_partials/shards/{name}/ns{ns}/{dn}"] = es
            del q, kp, vp, bt
    print(f"[kernels] flash_paged_decode_partials worst: gate {worst['gate']:.3f} "
          f"x tol, lse {worst['lse']:.3e}, two shards {worst['shards']:.3f} x tol")
    torch.cuda.empty_cache()
    return errs


def bwd_kernel_phase(torch, kfwd, kbwd):
    """The fused backward kernel against its plain version, f32 and bf16,
    at the training shape and the edge cases, and against itself on a second
    launch (dK, dV bit-equal; dQ, summed by atomic adds in another order,
    within the tolerance); then against autograd of the naive oracle.
    Returns {case: max |kernel - plain| / max(1, max|plain|)}."""
    from repro_torch.kernels import ref

    print(f"[kernels] backward tolerances, kernel vs plain version, relative "
          f"to max(1, max|plain|): f32 {BWD_TOL['float32']:.0e} (the JAX "
          f"suite's gradient tolerance; dK and dV sum over up to 2048 q rows "
          f"and a group of 4 in another order); bf16 inputs or bf16-ACC "
          f"{BWD_TOL['bfloat16']:.2e} (two bf16 ulps)")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    bf16 = torch.bfloat16
    cases = [
        # name, b, hq, hkv, sq, skv, d, extra kwargs
        ("train_s2048", 4, 32, 8, 2048, 2048, 64, dict(causal=True)),
        ("window_128", 4, 32, 8, 512, 512, 64, dict(causal=True, window=128)),
        ("segments", 4, 32, 8, 512, 512, 64, dict(causal=True, segments=True)),
        ("dropout_0.1", 4, 32, 8, 512, 512, 64,
         dict(causal=True, dropout_rate=0.1, dropout_seed=-7)),
        ("ragged_500", 4, 32, 8, 500, 500, 64, dict(causal=True)),
        ("q_suffix_200_of_500", 4, 32, 8, 200, 500, 64, dict(causal=True)),
        ("d128_gqa5", 4, 40, 8, 512, 512, 128, dict(causal=True)),
        ("bf16_acc", 4, 32, 8, 512, 512, 64, dict(causal=True, acc_dtype=bf16)),
    ]
    errs = {}
    for dtype in (torch.float32, bf16):
        dn = str(dtype).split(".")[-1]
        for name, b, hq, hkv, sq, skv, d, kw in cases:
            kw = dict(kw)
            q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, sq, skv, d, dtype)
            do = _rand(torch, gen, (b, hq, sq, d), dtype)
            if kw.pop("segments", False):
                kw["segment_ids"] = _segments(torch, b, skv)
            tn = "bfloat16" if bf16 in (dtype, kw.get("acc_dtype")) else "float32"
            o, lse = kfwd.flash_fwd(q, k, v, **kw)
            if "acc_dtype" in kw:            # bf16-ACC forward against its plain version
                o_ref, _ = kfwd.flash_fwd_torch(q, k, v, **kw)
                e = _maxerr(o, o_ref)
                print(f"[kernels] flash_fwd {name} {dn}: max|o - plain| {e:.3e} "
                      f"(tol {TOL['bfloat16']:.2e}) {'ok' if e <= TOL['bfloat16'] else 'FAIL'}")
                if e > TOL["bfloat16"]:
                    fail(f"flash_fwd {name} {dn} disagrees with its plain version")
                errs[f"flash_fwd/{name}/{dn}"] = e
                del o_ref
            grads = kbwd.flash_bwd(q, k, v, o, lse, do, **kw)
            again = kbwd.flash_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            plain = kbwd.flash_bwd_torch(q, k, v, lse, do, kbwd.row_delta(o, do),
                                         **kw)
            worst, parts = 0.0, []
            for gname, g, gp in zip(("dq", "dk", "dv"), grads, plain):
                rel = _maxerr(g, gp) / max(1.0, float(gp.float().abs().max()))
                worst = max(worst, rel)
                parts.append(f"{gname} {rel:.3e}")
                if not bool(torch.isfinite(g).all()):
                    fail(f"flash_bwd {name} {dn}: {gname} is not finite")
            ok = worst <= BWD_TOL[tn]
            print(f"[kernels] flash_bwd {name} {dn}: max|g - plain| / max(1, "
                  f"max|plain|): {', '.join(parts)} (tol {BWD_TOL[tn]:.1e}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"flash_bwd {name} {dn} disagrees with its plain version")
            rerun = _maxerr(grads[0], again[0]) / max(1.0, float(plain[0].float().abs().max()))
            same_kv = torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])
            print(f"[kernels] flash_bwd {name} {dn} launched twice: dk, dv "
                  f"{'bit-equal' if same_kv else 'DIFFER'}; dq {rerun:.3e} relative "
                  f"(atomic adds in another order; tol {BWD_TOL[tn]:.1e})")
            if not same_kv or rerun > BWD_TOL[tn]:
                fail(f"flash_bwd {name} {dn} is not reproducible on a second launch")
            if "segment_ids" in kw:
                pad = skv // 16
                if max(float(grads[0][:, :, -pad:].abs().max()),
                       float(grads[1][:, :, -pad:].abs().max()),
                       float(grads[2][:, :, -pad:].abs().max())) != 0.0:
                    fail("flash_bwd: padding tokens (segment id -1) get a gradient")
            errs[f"flash_bwd/{name}/{dn}"] = worst
            del q, k, v, do, o, lse, grads, again, plain

    # the backward kernel against autograd of the naive oracle, small f32
    q, k, v = _fwd_inputs(torch, gen, 2, 8, 2, 100, 300, 64, torch.float32)
    do = _rand(torch, gen, (2, 8, 100, 64), torch.float32)
    kw = dict(causal=True, window=90, segment_ids=_segments(torch, 2, 300),
              dropout_rate=0.2, dropout_seed=5)
    o, lse = kfwd.flash_fwd(q, k, v, **kw)
    grads = kbwd.flash_bwd(q, k, v, o, lse, do, **kw)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    ref.naive_mha(*xs, **kw).backward(do)
    worst = max(_maxerr(g, x.grad) / max(1.0, float(x.grad.abs().max()))
                for g, x in zip(grads, xs))
    print(f"[kernels] flash_bwd vs autograd of the naive oracle (f32, window, "
          f"segments, dropout, q suffix): {worst:.3e} (tol {BWD_TOL['float32']:.0e})")
    if worst > BWD_TOL["float32"]:
        fail("the backward kernel disagrees with autograd of the naive oracle")
    torch.cuda.empty_cache()
    return errs


def serve_phase(torch, kfwd, kdecode):
    """granite-3-2b, full width and depth, through the port's serving path."""
    from repro_torch import configs
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import lm
    from repro_torch.runtime.steps import make_serve_steps

    cfg = dataclasses.replace(configs.get_config("granite_3_2b"),
                              dtype=torch.float32)   # as launch/serve.py forces
    batch, prompt_len, gen_len = 8, 512, 32
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, "
          f"vocab {cfg.vocab_size}; {n_params / 1e9:.2f} B params f32 "
          f"(random, seed 0) in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g,
                           device="cuda")

    def steps(impl):
        return make_serve_steps(cfg, impl=impl, max_len=prompt_len + gen_len,
                                batch=batch, torch_chunk=prompt_len,
                                device="cuda")

    torch.cuda.reset_peak_memory_stats()
    kfwd.launches = kdecode.launches = 0
    run_k = greedy_generate(steps("kernel"), params, prompt, gen_len,
                            cfg.vocab_size)
    launches = {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches}
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": cfg.num_layers,
            "flash_decode": cfg.num_layers * (gen_len - 1)}
    print(f"[serve] impl=kernel: prefill {batch}x{prompt_len} "
          f"{run_k.prefill_s * 1e3:.1f} ms; decode {gen_len - 1} steps "
          f"{run_k.decode_s * 1e3:.1f} ms "
          f"({(gen_len - 1) * batch / run_k.decode_s:.1f} tok/s); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"[serve] launch counters {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"the serving path did not go through the kernels: {launches}")

    print(f"[serve] tolerance kernel vs torch impl: max |d logit| <= "
          f"{LOGIT_REL_TOL:.0e} x max|logit| (40 layers of f32 with sums in "
          f"another order move logits ~1e-6 relative; a wrong kernel moves "
          f"them by far more)")
    run_t = greedy_generate(steps("torch"), params, prompt, gen_len,
                            cfg.vocab_size, feed=run_k.tokens)
    if {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches} != want:
        fail("impl='torch' launched a CUDA kernel")
    worst = 0.0
    for step, (lk, lt) in enumerate(zip(run_k.logits, run_t.logits)):
        if lk.shape != (batch, cfg.vocab_size) or \
                not bool(torch.isfinite(lk).all()):
            fail(f"step {step}: logits of shape {tuple(lk.shape)} or not finite")
        rel = _maxerr(lk, lt) / float(lt.abs().max())
        worst = max(worst, rel)
        if rel > LOGIT_REL_TOL:
            fail(f"step {step}: kernel vs torch logits differ by {rel:.3e} "
                 f"of max|logit| (tol {LOGIT_REL_TOL:.0e})")
    match = float((run_k.tokens == run_t.tokens).float().mean())
    print(f"[serve] impl=torch (fed the kernel run's tokens): prefill "
          f"{run_t.prefill_s * 1e3:.1f} ms; decode {run_t.decode_s * 1e3:.1f} ms")
    print(f"[serve] kernel vs torch logits over prefill + {gen_len - 1} steps: "
          f"max |d| / max|logit| {worst:.3e} (tol {LOGIT_REL_TOL:.0e}); "
          f"greedy token match {match:.4f}", flush=True)
    del params, run_k, run_t
    torch.cuda.empty_cache()
    return launches


PAGED_REQUESTS, PAGED_PROMPT, PAGED_GEN = 16, 512, 64
PAGED_MODES = {
    # name: engine kwargs (beyond page 16, 8 slots, prefill rows of 512)
    "eager": {},
    "lazy": {"lazy": True},
    "prefix_chunk": {"share_prefix": True, "prefill_chunk": 256},
    "speculate_4": {"speculate_k": 4},
}


class StepRecorder:
    """Wraps an engine's four step callables: counts their calls and keeps,
    for every generated token (request id, index in its generation), the
    top-2 logit margin and max |logit| of the row that produced it. The
    engine is not changed; the wrappers read its scheduler to name rows."""

    def __init__(self, torch, eng, vocab):
        self.torch, self.eng, self.vocab = torch, eng, vocab
        self.calls = dict.fromkeys(("prefill", "decode", "chunk", "verify"), 0)
        self.margin = {}
        for attr, kind in (("prefill_fn", "prefill"), ("decode_fn", "decode"),
                           ("chunk_prefill_fn", "chunk"), ("verify_fn", "verify")):
            setattr(eng, attr, self._wrap(getattr(eng, attr), kind))

    def _wrap(self, fn, kind):
        def step(params, *args):
            keys = getattr(self, "_" + kind)(*args)   # before the engine appends
            logits, caches = fn(params, *args)
            self.calls[kind] += 1
            self._record(logits, keys)
            return logits, caches
        return step

    def _key(self, slot, ahead=0):
        seq = self.eng.scheduler.active[int(slot)]
        return seq.request.rid, len(seq.all_generated) + ahead

    def _prefill(self, tokens, seg, pos, dest, slots, caches):
        seg, slots = seg[0].cpu().numpy(), slots[0].cpu().numpy()
        return [(self._key(slots[idx]), (0, int(idx)))
                for idx in (int((seg == i).nonzero()[0][-1])
                            for i in range(int(seg.max()) + 1))]

    def _chunk(self, tokens, pos, dest, ttab, kvl, slots, local, caches):
        pos, slots = pos[0].cpu().numpy(), slots[0].cpu().numpy()
        keys = []
        for slot in set(slots[slots >= 0].tolist()):
            idx = int((slots == slot).nonzero()[0][-1])
            if pos[idx] + 1 == self.eng.scheduler.active[slot].request.prompt_len:
                keys.append((self._key(slot), (0, idx)))
        return keys

    def _decode(self, tok, caches, bt, kvl):
        return [(self._key(slot), (slot,))
                for slot, seq in self.eng.scheduler.active.items()
                if not seq.prefilling]

    def _verify(self, tok, pos, dest, ttab, kvl, caches):
        live = (kvl > 0).sum(dim=1).cpu().numpy()
        return [(self._key(slot, j), (slot, j))
                for slot, seq in self.eng.scheduler.active.items()
                if not seq.prefilling for j in range(int(live[slot]))]

    def _record(self, logits, keys):
        if not keys:
            return
        rows = self.torch.stack([logits[ix][:self.vocab] for _, ix in keys]).float()
        top = rows.topk(2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]).cpu().tolist()
        peak = rows.abs().amax(dim=-1).cpu().tolist()
        for (key, _), m, p in zip(keys, margin, peak):
            self.margin[key] = (m, p)


def _paged_requests(np, vocab, mode, max_prompt):
    """16 seeded requests, prompts 128-512 tokens and 16-64 generated;
    prefix_chunk opens each with one 256-token system prompt (cut to the
    pool's reach, as launch/serve.py cuts it); speculate_4 tiles an 8-token
    motif, as launch/serve.py builds its --speculate prompts."""
    rs = np.random.RandomState(0)
    system = (rs.randint(0, vocab, size=256) if mode == "prefix_chunk"
              else np.zeros(0, np.int64))
    reqs = []
    for _ in range(PAGED_REQUESTS):
        plen = int(rs.randint(PAGED_PROMPT // 4, PAGED_PROMPT + 1))
        gen = int(rs.randint(PAGED_GEN // 4, PAGED_GEN + 1))
        if mode == "speculate_4":
            tail = np.tile(rs.randint(0, vocab, size=8), -(-plen // 8))[:plen]
        else:
            tail = rs.randint(0, vocab, size=plen)
        reqs.append((np.concatenate([system, tail])[:max_prompt], gen))
    return reqs


def paged_serve_phase(torch, kfwd, kdecode):
    """granite-3-2b, full width and depth, through the port's paged serving
    engine in four modes, kernel impl against torch impl. Returns the launch
    counts of the kernel runs, and their tokens and top-2 margins by mode."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import PagedCacheConfig, ServingEngine

    cfg = dataclasses.replace(configs.get_config("granite_3_2b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device="cuda")
    n = cfg.num_layers
    ps, slots = 16, 8
    budget = PAGED_PROMPT + PAGED_GEN
    pages_per_seq = -(-budget // ps) + 1                       # 37
    full_pool = 1 + slots * pages_per_seq                      # 297
    print(f"[paged] {cfg.name}, {n} layers f32 (random, seed 0): page {ps}, "
          f"{slots} slots, {pages_per_seq} pages a sequence, pool {full_pool} "
          f"pages ({(full_pool - 1) // 2 + 1} in lazy mode); {PAGED_REQUESTS} "
          f"requests, prompts {PAGED_PROMPT // 4}-{PAGED_PROMPT} tokens, "
          f"{PAGED_GEN // 4}-{PAGED_GEN} generated; near-tie tolerance: top-2 "
          f"margin <= {LOGIT_REL_TOL:.0e} x max|logit|", flush=True)
    counts = {"flash_fwd": 0, "flash_paged_decode": 0, "by_mode": {}}
    tokens = {}
    for mode, kw in PAGED_MODES.items():
        lazy = kw.get("lazy", False)
        pcfg = PagedCacheConfig(
            page_size=ps, max_batch=slots, max_pages_per_seq=pages_per_seq,
            num_pages=(full_pool - 1) // 2 + 1 if lazy else full_pool)
        # lazy: a preempted row re-prefills prompt + generated, so a row
        # holds a full budget (launch/serve.py's rule)
        prefill_len = budget if lazy else PAGED_PROMPT
        reqs = _paged_requests(np, cfg.vocab_size, mode,
                               pcfg.max_seq_len - PAGED_GEN - 1)
        runs = {}
        for impl in ("kernel", "torch"):
            eng = ServingEngine(cfg, pcfg, params, impl=impl, device="cuda",
                                prefill_len=prefill_len,
                                torch_chunk=PAGED_PROMPT, **kw)
            rec = StepRecorder(torch, eng, cfg.vocab_size)
            torch.cuda.reset_peak_memory_stats()
            kfwd.launches = kdecode.launches = kdecode.launches_paged = 0
            out, stats = eng.run([(t, g) for t, g in reqs])
            torch.cuda.synchronize()
            got = {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches,
                   "flash_paged_decode": kdecode.launches_paged}
            c = rec.calls
            print(f"[paged] {mode} impl={impl}: {stats['generated_tokens']:.0f} "
                  f"tokens in {stats['wall_s']:.3f} s = "
                  f"{stats['tokens_per_s']:.1f} tokens/s; "
                  f"{stats['decode_steps']:.0f} decode steps; calls prefill "
                  f"{c['prefill']} / decode {c['decode']} / chunk {c['chunk']} "
                  f"/ verify {c['verify']}; preemptions "
                  f"{stats['preemptions']:.0f}; page utilization "
                  f"{stats['mean_utilization']:.3f}, pool fraction "
                  f"{stats['mean_pool_fraction']:.3f}; prefill tokens "
                  f"{stats['prefill_tokens']:.0f} ({stats['prefill_tokens_skipped']:.0f} "
                  f"skipped), cow {stats['cow_copies']:.0f}, drafted "
                  f"{stats['drafted_tokens']:.0f} / accepted "
                  f"{stats['accepted_tokens']:.0f}; max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  f"launches {got}", flush=True)
            if stats["outcomes"]["completed"] != len(reqs):
                fail(f"paged {mode} {impl}: outcomes {stats['outcomes']}")
            if impl == "kernel":
                want = {"flash_fwd": n * c["prefill"], "flash_decode": 0,
                        "flash_paged_decode": n * (c["decode"] + c["chunk"]
                                                   + c["verify"])}
                if got != want or want["flash_paged_decode"] == 0:
                    fail(f"paged {mode}: the path did not go through the "
                         f"kernels: {got}, expected {want}")
                counts["flash_fwd"] += got["flash_fwd"]
                counts["flash_paged_decode"] += got["flash_paged_decode"]
                counts["by_mode"][mode] = got["flash_paged_decode"]
            elif any(got.values()):
                fail(f"paged {mode}: impl='torch' launched a CUDA kernel: {got}")
            runs[impl] = (out, rec)
        if lazy and stats["preemptions"] == 0:
            fail("paged lazy: the half pool forced no preemption")
        out_k, rec_k = runs["kernel"]
        tokens[mode] = (out_k, rec_k.margin)
        out_t = runs["torch"][0]
        same, ties = 0, []
        for rid, toks in out_k.items():
            diff = np.nonzero(toks != out_t[rid])[0]
            if diff.size == 0:
                same += 1
                continue
            i = int(diff[0])
            margin, peak = rec_k.margin[(rid, i)]
            ties.append(f"request {rid} token {i}: kernel {toks[i]} vs torch "
                        f"{out_t[rid][i]}, margin {margin:.3e} of max|logit| "
                        f"{peak:.3e}")
            if margin > LOGIT_REL_TOL * peak:
                fail(f"paged {mode}: {ties[-1]}: not a near-tie")
        print(f"[paged] {mode}: kernel vs torch tokens identical for {same} of "
              f"{len(out_k)} requests"
              + ("".join(f"; near-tie {t}" for t in ties)), flush=True)
    del params
    torch.cuda.empty_cache()
    return counts, tokens


DIST_RANKS = 2
DIST_MODES = ("eager", "lazy", "prefix_chunk")


def _dist_pool(lazy: bool, n_shards: int, ps: int = 16, slots: int = 8):
    """Phase 4b's pool with one trash page a shard: the same usable pages
    (296, or 148 lazy), so the scheduler takes the same decisions."""
    pages_per_seq = -(-(PAGED_PROMPT + PAGED_GEN) // ps) + 1
    usable = slots * pages_per_seq // (2 if lazy else 1)
    return pages_per_seq, n_shards + usable


def _record_copies(eng, pairs):
    """Keep the engine's copy-on-write (src, dst) pairs in ``pairs`` as its
    scheduler hands them out."""
    drain = eng.scheduler.tables.drain_copies

    def spy():
        got = drain()
        pairs.extend(got)
        return got

    eng.scheduler.tables.drain_copies = spy


def _dist_rank(mesh, device):
    """One rank of phase 4c: probe the collectives on CUDA tensors, then
    serve granite-3-2b at full size on this rank's shard of the pool in
    each of ``DIST_MODES``. Returns per mode what the parent checks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed import paged as dpaged
    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import flash_fwd as kfwd
    from repro_torch.models import lm
    from repro_torch.serving import PagedCacheConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # gloo's all_reduce on CUDA tensors, MAX and SUM, and the cross-shard
    # page copy (copy-on-write) on the card
    x = torch.full((4,), float(mesh.rank + 1), device=device)
    mx, sm = x.clone(), x.clone()
    dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=mesh.group)
    dist.all_reduce(sm, op=dist.ReduceOp.SUM, group=mesh.group)
    n = mesh.size
    if not (bool((mx == n).all()) and bool((sm == n * (n + 1) / 2).all())):
        raise RuntimeError(f"{dist.get_backend(mesh.group)} all_reduce on CUDA "
                           f"tensors is wrong: MAX {mx.tolist()}, SUM {sm.tolist()}")
    base = torch.arange(24, dtype=torch.float32, device=device).view(1, 2, 3, 4)
    pool = base + 100 * mesh.rank           # two pages a shard: 2r and 2r + 1
    last = 2 * n - 1                        # swap page 1 (rank 0) and the last
    dpaged.copy_pages_sharded([pool], [1, last], [last, 1], mesh)
    peer = {0: n - 1, n - 1: 0}.get(mesh.rank, mesh.rank)
    if n < 2 or not torch.equal(pool[:, 0], base[:, 0] + 100 * mesh.rank) \
            or not torch.equal(pool[:, 1], base[:, 1] + 100 * peer):
        raise RuntimeError("copy_pages_sharded across shards is wrong on the card")
    # the merge's two collectives alone, at the decode step's shape, on an
    # idle stream: what a layer pays for the merge without waiting for work
    m = torch.zeros((8, 32), device=device)
    buf = torch.zeros((8, 32, 65), device=device)
    for i in range(110):
        if i == 10:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.group)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    torch.cuda.synchronize(device)
    merge_ms = (time.perf_counter() - t0) / 100 * 1e3
    probe = (f"all_reduce MAX/SUM on {device} ok, cross-shard page copy ok; "
             f"the merge's two collectives alone (m [8, 32], [acc | l] "
             f"[8, 32, 65] f32, idle stream): {merge_ms:.3f} ms a merge")

    cfg = dataclasses.replace(configs.get_config("granite_3_2b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device=device)
    results = {"probe": probe, "num_layers": cfg.num_layers}
    for mode in DIST_MODES:
        kw = PAGED_MODES[mode]
        lazy = kw.get("lazy", False)
        pages_per_seq, num_pages = _dist_pool(lazy, mesh.size)
        pcfg = PagedCacheConfig(page_size=16, max_batch=8,
                                max_pages_per_seq=pages_per_seq,
                                num_pages=num_pages, num_shards=mesh.size)
        reqs = _paged_requests(np, cfg.vocab_size, mode,
                               pcfg.max_seq_len - PAGED_GEN - 1)
        eng = ServingEngine(cfg, pcfg, params, impl="kernel", device=device,
                            mesh=mesh, prefill_len=(PAGED_PROMPT + PAGED_GEN
                                                    if lazy else PAGED_PROMPT),
                            torch_chunk=PAGED_PROMPT, **kw)
        rec = StepRecorder(torch, eng, cfg.vocab_size)
        pairs = []
        _record_copies(eng, pairs)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        kfwd.launches = kdecode.launches = 0
        kdecode.launches_paged = kdecode.launches_paged_valid = 0
        dpaged.merge_calls, dpaged.merge_s = 0, 0.0
        out, stats = eng.run([(t, g) for t, g in reqs])
        torch.cuda.synchronize(device)
        n_local = num_pages // mesh.size
        results[mode] = {
            "out": out, "stats": stats, "calls": dict(rec.calls),
            "margin": rec.margin, "pool": (num_pages, n_local),
            "launches": {"flash_fwd": kfwd.launches,
                         "flash_decode": kdecode.launches,
                         "flash_paged_decode": kdecode.launches_paged,
                         "flash_paged_decode_partials": kdecode.launches_paged_valid},
            "merge_calls": dpaged.merge_calls, "merge_s": dpaged.merge_s,
            "cow_pairs": len(pairs),
            "cow_across": sum(s // n_local != d // n_local for s, d in pairs),
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
        del eng
        torch.cuda.empty_cache()
    return results


def dist_serve_phase(torch, paged_tokens, n_ranks: int, backend: str):
    """granite-3-2b at full width and depth through the port's distributed
    paged engine: ``n_ranks`` ranks (by default two sharing the card, gloo),
    each holding 1/n of every layer's page pool and all the weights, in
    three modes. Tokens equal on every rank and equal to phase 4b's
    single-device kernel run (or a printed near-tie); the gated kernel
    launched 40 × (decode + chunk + verify calls) on each rank, the ungated
    one never. Returns rank 0's gated launches by mode."""
    import numpy as np

    from repro_torch.launch.mesh import rank_device, run_ranks

    devices = [str(rank_device(r, "cuda")) for r in range(n_ranks)]
    how = ("gloo through host memory on one card, not NVLink; NCCL refuses "
           "two ranks on one card" if backend == "gloo" else
           f"{backend}, a card a rank")
    print(f"[dist] {n_ranks} ranks on {', '.join(devices)} ({how}), each with "
          f"granite-3-2b f32 (random, seed 0) and 1/{n_ranks} of every layer's "
          f"page pool; modes {', '.join(DIST_MODES)}", flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks(_dist_rank, n_ranks, backend=backend,
                      device_type="cuda", timeout_s=900)
    print(f"[dist] {ranks[0]['probe']}; ranks done in "
          f"{time.perf_counter() - t0:.1f} s (spawn, weights, three modes)")
    n_layers = ranks[0]["num_layers"]
    launches = {"total": 0, "by_mode": {}}
    for mode in DIST_MODES:
        r0 = ranks[0][mode]
        ref_out, ref_margin = paged_tokens[mode]
        for rank, res in enumerate(ranks):
            res = res[mode]
            st, c, got = res["stats"], res["calls"], res["launches"]
            steps = c["decode"] + c["chunk"] + c["verify"]
            want = {"flash_fwd": n_layers * c["prefill"], "flash_decode": 0,
                    "flash_paged_decode": 0,
                    "flash_paged_decode_partials": n_layers * steps}
            per_step = res["merge_s"] / max(st["decode_steps"], 1)
            print(f"[dist] {mode} rank {rank}: {st['generated_tokens']:.0f} "
                  f"tokens in {st['wall_s']:.3f} s = {st['tokens_per_s']:.1f} "
                  f"tokens/s; {st['decode_steps']:.0f} decode steps; calls "
                  f"prefill {c['prefill']} / decode {c['decode']} / chunk "
                  f"{c['chunk']} / verify {c['verify']}; preemptions "
                  f"{st['preemptions']:.0f}; pool {res['pool'][0]} pages "
                  f"({res['pool'][1]} a shard); cow {res['cow_pairs']} "
                  f"({res['cow_across']} across shards); max_memory_allocated "
                  f"{res['peak_gib']:.2f} GiB; merges {res['merge_calls']}, host "
                  f"time in their collectives {res['merge_s']:.3f} s = "
                  f"{per_step * 1e3:.2f} ms a step ({how}); launches {got}",
                  flush=True)
            if got != want or steps == 0:
                fail(f"dist {mode} rank {rank}: the path did not go through the "
                     f"gated kernel: {got}, expected {want}")
            if st["outcomes"]["completed"] != PAGED_REQUESTS:
                fail(f"dist {mode} rank {rank}: outcomes {st['outcomes']}")
            if set(res["out"]) != set(r0["out"]) or any(
                    not np.array_equal(res["out"][k], r0["out"][k]) for k in r0["out"]):
                fail(f"dist {mode}: rank {rank}'s tokens differ from rank 0's")
        if mode == "lazy" and r0["stats"]["preemptions"] == 0:
            fail("dist lazy: the half pool forced no preemption")
        if mode == "prefix_chunk" and r0["calls"]["chunk"] == 0:
            fail("dist prefix_chunk: no chunked prefill ran")
        same, ties = 0, []
        for rid, toks in ref_out.items():
            diff = np.nonzero(r0["out"][rid] != toks)[0]
            if diff.size == 0:
                same += 1
                continue
            i = int(diff[0])
            margin, peak = ref_margin[(rid, i)]
            ties.append(f"request {rid} token {i}: sharded {r0['out'][rid][i]} "
                        f"vs one device {toks[i]}, margin {margin:.3e} of "
                        f"max|logit| {peak:.3e}")
            if margin > LOGIT_REL_TOL * peak:
                fail(f"dist {mode}: {ties[-1]}: not a near-tie")
        print(f"[dist] {mode}: tokens equal on every rank; equal to the "
              f"single-device kernel engine for {same} of {len(ref_out)} "
              f"requests" + "".join(f"; near-tie {t}" for t in ties), flush=True)
        n = r0["launches"]["flash_paged_decode_partials"]
        launches["by_mode"][mode] = n
        launches["total"] += n
    return launches


def train_phase(torch, kfwd, kbwd):
    """granite-3-2b at full width and depth through the port's training
    path; returns the launch counts of the ``make_train_step`` run."""
    import tempfile

    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.runtime.steps import make_train_step, place_batch, step_seed
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(configs.get_config("granite_3_2b"),
                              dtype=torch.float32, dropout_rate=0.1, remat=True)
    arts = make_train_step(cfg, opt=AdamWConfig(lr=1e-4), impl="kernel",
                           total_steps=TRAIN_STEPS, warmup_steps=1,
                           torch_chunk=256, device="cuda")
    t0 = time.perf_counter()
    params, opt = arts.init_fn(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {n_params / 1e9:.3f} B params f32 + AdamW m, v, "
          f"master (random, seed 0) in {time.perf_counter() - t0:.1f} s; "
          f"remat {cfg.remat}, dropout {cfg.dropout_rate}; batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens from make_batch", flush=True)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, seed=0)
    batch = place_batch(make_batch(dc, 0), "cuda")

    # (a) one loss-and-grad pass per impl on the same params and batch
    def loss_and_grads(impl):
        ctx = Ctx(impl=impl, deterministic=False, seed=step_seed(0),
                  torch_chunk=256)
        kfwd.launches = kbwd.launches_bwd = 0
        t0 = time.perf_counter()
        loss = lm.loss_fn(cfg, params, batch, ctx)[0]
        loss.backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = (kfwd.launches, kbwd.launches_bwd)
        named = dict(params.named_parameters())
        out = (float(loss.detach()),
               float(global_norm(p.grad for p in params.parameters())),
               {n: named[n].grad.clone() for n in TRAIN_LEAVES}, counts, dt)
        params.zero_grad(set_to_none=True)
        return out

    n = cfg.num_layers
    lk, gk, leaves_k, ck, dtk = loss_and_grads("kernel")
    print(f"[train] (a) impl=kernel: loss {lk:.6f}, grad norm {gk:.6f}, "
          f"{dtk:.2f} s; launches flash_fwd / flash_bwd {ck} (expected "
          f"{(2 * n, n)}: forward plus remat recompute)", flush=True)
    if ck != (2 * n, n):
        fail(f"the training pass did not go through the kernels: {ck}")
    lt, gt, leaves_t, ct, dtt = loss_and_grads("torch")
    print(f"[train] (a) impl=torch (chunk 256): loss {lt:.6f}, grad norm "
          f"{gt:.6f}, {dtt:.2f} s; launches {ct}", flush=True)
    if ct != (0, 0):
        fail("impl='torch' launched a CUDA kernel")
    checks = [("loss", abs(lk - lt) / abs(lt), TRAIN_TOL["loss"]),
              ("grad norm", abs(gk - gt) / gt, TRAIN_TOL["grad_norm"])]
    for name in TRAIN_LEAVES:
        a, b = leaves_k[name], leaves_t[name]
        checks.append((f"grad {name}", _maxerr(a, b) / float(b.abs().max()),
                       TRAIN_TOL["leaf"]))
    for what, err, tol in checks:
        print(f"[train] (a) kernel vs torch {what}: {err:.3e} (tol {tol:.0e}) "
              f"{'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            fail(f"training pass kernel vs torch: {what} differs by {err:.3e}")
    del leaves_k, leaves_t

    # (b) the train step, as a user calls it, counters reset just before
    torch.cuda.reset_peak_memory_stats()
    kfwd.launches = kbwd.launches_bwd = 0
    times = []
    for step in range(TRAIN_STEPS):
        b = place_batch(make_batch(dc, step), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = arts.step_fn(params, opt, b, step)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        print(f"[train] (b) step {step}: loss {loss:.6f}, grad norm "
              f"{float(m['grad_norm']):.4f}, lr reported {m['lr']:.2e} (the "
              f"update applies AdamWConfig.lr, as the JAX step does), "
              f"{times[-1]:.3f} s", flush=True)
        if not math.isfinite(loss):
            fail(f"training step {step}: loss {loss}")
    counts = {"flash_fwd": kfwd.launches, "flash_bwd": kbwd.launches_bwd}
    want = {"flash_fwd": 2 * n * TRAIN_STEPS, "flash_bwd": n * TRAIN_STEPS}
    peak = torch.cuda.max_memory_allocated()
    warm = times[1:]
    tok_s = TRAIN_BATCH * TRAIN_SEQ * len(warm) / sum(warm)
    print(f"[train] (b) {TRAIN_STEPS} steps of make_train_step(impl='kernel'): "
          f"step times {[round(t, 4) for t in times]} s; steps 1-{TRAIN_STEPS - 1} "
          f"mean {sum(warm) / len(warm):.4f} s = {tok_s:.1f} tokens/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"[train] (b) launch counters {counts} (expected {want})", flush=True)
    if counts != want:
        fail(f"the training steps did not go through the kernels: {counts}")
    profile_step(torch, lambda: float(arts.step_fn(params, opt, place_batch(
        make_batch(dc, TRAIN_STEPS), "cuda"), TRAIN_STEPS)[2]["loss"]))
    del params, opt, arts, batch
    torch.cuda.empty_cache()

    # (c) the Trainer at SMOKE size: 2 steps, a preemption, 2 more on resume
    scfg = dataclasses.replace(configs.smoke_config("granite_3_2b"),
                               dtype=torch.float32, dropout_rate=0.1)
    sdc = DataConfig(vocab_size=scfg.vocab_size, seq_len=128, global_batch=4,
                     seed=1, pack=True)

    def trainer(path):
        a = make_train_step(scfg, opt=AdamWConfig(lr=1e-3), impl="kernel",
                            device="cuda")
        return Trainer(arts=a, data_cfg=sdc, tcfg=TrainerConfig(
            ckpt_dir=path, ckpt_every=100, log_every=1000))

    with tempfile.TemporaryDirectory() as tmp:
        straight = trainer(f"{tmp}/a")
        straight.run(4)
        t1 = trainer(f"{tmp}/b")
        t1.hooks["pre_step"] = lambda s: t1.request_preemption() if s == 1 else None
        r1 = t1.run(4)
        t2 = trainer(f"{tmp}/b")
        r2 = t2.run(4)
    resumed = [m["loss"] for m in t1.metrics_log + t2.metrics_log]
    ref_losses = [m["loss"] for m in straight.metrics_log]
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, ref_losses))
    ok = (r1["preempted"] and r1["stop_step"] == 2 and r2["stop_step"] == 4
          and len(resumed) == 4 and worst <= TRAIN_TOL["loss"])
    print(f"[train] (c) Trainer at SMOKE size on the card: preempted at step "
          f"{r1['stop_step']}, resumed to {r2['stop_step']}; losses {resumed} vs "
          f"straight {ref_losses}: max rel diff {worst:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the trainer's preempt / resume run went wrong")
    return counts


def profile_step(torch, step) -> None:
    """One more training step under ``torch.profiler``: device time by kernel
    group (the port's attention kernels, cuBLAS GEMMs, the rest) and the
    device's busy share of the step's wall time. ``step()`` returns the
    step's loss; the step's own errors and a non-finite loss fail the run.
    A profiler that fails or records no device time is reported as not
    measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:   # the profiler is a probe here, not a check
        print(f"[train] profile: not measured ({type(e).__name__}: {e})")
        prof = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not math.isfinite(loss):
        fail(f"the profiled training step: loss {loss}")
    print(f"[train] profiled step: loss {loss:.6f}")
    if prof is None:
        return
    try:
        prof.stop()
        averages = prof.key_averages()
    except Exception as e:
        print(f"[train] profile: not measured ({type(e).__name__}: {e})")
        return
    groups, names = {"attention kernels": 0.0, "GEMMs": 0.0, "other": 0.0}, []
    for e in averages:
        if e.device_type != DeviceType.CUDA:   # kernels only: ops would count twice
            continue
        us = e.self_device_time_total
        name = e.key
        g = ("attention kernels" if any(k in name for k in
                                        ("fwd_kernel", "bwd_kernel"))
             else "GEMMs" if "gemm" in name.lower() else "other")
        groups[g] += us / 1e6
        names.append((us / 1e6, name))
    busy = sum(groups.values())
    if busy == 0.0:
        print("[train] profile: not measured (no device time recorded)")
        return
    parts = ", ".join(f"{g} {t:.4f} s ({100 * t / wall:.1f} %)" for g, t in groups.items())
    print(f"[train] profile of one step (torch.profiler, wall {wall:.4f} s under "
          f"the profiler): device time {parts}; device busy {busy:.4f} s = "
          f"{100 * busy / wall:.1f} % of the step, idle {100 * (1 - busy / wall):.1f} %")
    for t, name in sorted(names, reverse=True)[:8]:
        print(f"[train] profile top kernel: {t:.4f} s {name[:110]}")
    sys.stdout.flush()


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events around the run, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def times_phase(torch, kfwd, kdecode, launches, errs):
    """Kernel, plain version, library call and bound at the serving path's
    shapes (f32, as the path runs): prefill attention of one layer (B 8,
    32/8 heads, 512 tokens, D 64, causal) and one decode step's attention
    (cache of 544 slots, 528 of them filled: the middle of the 31 steps)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(99)
    f32 = torch.float32
    b, hq, hkv, s, d = 8, 32, 8, 512, 64
    q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, f32)
    o, _ = kfwd.flash_fwd(q, k, v, causal=True)
    o_ref, _ = kfwd.flash_fwd_torch(q, k, v, causal=True)
    fwd_err = _maxerr(o, o_ref)
    pairs = s * (s + 1) // 2                    # causal (q, k) pairs per head
    flops = 4 * b * hq * d * pairs              # QK^T and PV, 2 flops per FMA
    nbytes = 4 * (2 * b * hq * s * d + 2 * b * hkv * s * d + b * hq * s)
    fwd = {
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_fwd.py:46",
        "launches": launches["flash_fwd"], "max_abs_err": fwd_err,
        "ms": time_ms(torch, lambda: kfwd.flash_fwd(q, k, v, causal=True), 20),
        "plain_ms": time_ms(torch, lambda: kfwd.flash_fwd_torch(q, k, v, causal=True), 5),
        **bounds(flops, nbytes),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20),
    }
    del q, k, v, o, o_ref

    cap, n = 544, 528
    q = _rand(torch, gen, (b, hq, d), f32)
    kc = _rand(torch, gen, (b, hkv, cap, d), f32)
    vc = _rand(torch, gen, (b, hkv, cap, d), f32)
    kv_len = torch.full((b,), n, dtype=torch.int32, device="cuda")
    o = kdecode.flash_decode(q, kc, vc, kv_len=kv_len)
    dec_err = _maxerr(o, kdecode.flash_decode_torch(q, kc, vc, kv_len=kv_len))
    flops = 4 * b * hq * d * n
    nbytes = 4 * (2 * b * hq * d + 2 * b * hkv * n * d) + 4 * b
    ks, vs = kc[:, :, :n], vc[:, :, :n]
    dec = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/decode.py:131",
        "launches": launches["flash_decode"], "max_abs_err": dec_err,
        "ms": time_ms(torch, lambda: kdecode.flash_decode(q, kc, vc, kv_len=kv_len), 50),
        "plain_ms": time_ms(torch, lambda: kdecode.flash_decode_torch(
            q, kc, vc, kv_len=kv_len), 10),
        **bounds(flops, nbytes),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], ks, vs, enable_gqa=True), 50),
    }
    for row in (fwd, dec):
        print(f"[times] {row['name']}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; TF32 tensor "
              f"cores {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s, "
              f"{HBM_BYTES_PER_S / 1e12} TB/s), without tensor cores "
              f"{row['bound_ms_no_tensor_cores']:.4f} ms "
              f"({PEAK_FLOPS_NO_TENSOR_CORES / 1e12:.0f} TFLOP/s f32)")
    worst = max(errs.values())
    print(f"[times] worst kernel-vs-plain error over the kernel phase {worst:.3e}")
    return [fwd, dec]


def bwd_times_phase(torch, kfwd, kbwd, train_launches, fwd_row):
    """The fused backward kernel at the training path's attention shape (B 4,
    32/8 heads, S 2048, D 64, causal) in f32, as the path runs, and in bf16,
    beside its plain version (f32), the whole backward of
    ``scaled_dot_product_attention`` (dq, dk and dv: the same work) in the
    same dtype and call, its bounds, and max |dQ(run 1) - dQ(run 2)| of two
    launches on the same inputs (dQ's atomic adds run in another order);
    adds the forward kernel's time at that shape and its training launches
    to ``fwd_row``. Returns the kernel's row."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(7)
    b, hq, hkv, s, d = TRAIN_BATCH, 32, 8, TRAIN_SEQ, 64
    pairs = s * (s + 1) // 2                  # causal (q, k) pairs per head
    flops = 10 * d * b * hq * pairs           # S, dP, dV, dK, dQ: 2 D each
    row = {"name": "flash_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
           "replaces": "src/repro/kernels/flash_bwd.py:98, "
                       "src/repro/kernels/flash_bwd.py:164",
           "launches": train_launches["flash_bwd"]}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, dtype)
        do = _rand(torch, gen, (b, hq, s, d), dtype)
        o, lse = kfwd.flash_fwd(q, k, v, causal=True)
        delta = kbwd.row_delta(o, do)
        kw = dict(causal=True, scale=d ** -0.5)
        el = q.element_size()
        q_bytes, kv_bytes = el * b * hq * s * d, el * b * hkv * s * d
        rows_bytes = 4 * 2 * b * hq * s       # lse and delta
        if dtype == torch.float32:            # the forward at the training shape
            o_ref, _ = kfwd.flash_fwd_torch(q, k, v, causal=True)
            fb = bounds(4 * b * hq * d * pairs,
                        2 * q_bytes + 2 * kv_bytes + rows_bytes // 2)
            fwd_row.update({
                "launches_by_path": {"serve": fwd_row["launches"],
                                     "train": train_launches["flash_fwd"]},
                "train_shape_max_abs_err": _maxerr(o, o_ref),
                "train_shape_ms": time_ms(torch, lambda: kfwd.flash_fwd(
                    q, k, v, causal=True), 10),
                "train_shape_plain_ms": time_ms(torch, lambda: kfwd.flash_fwd_torch(
                    q, k, v, causal=True), 2, warmup=1),
                "train_shape_bound_ms": fb["bound_ms"],
                "train_shape_bound_ms_no_tensor_cores": fb["bound_ms_no_tensor_cores"],
                "train_shape_library_ms": time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True), 10),
            })
            del o_ref
            print(f"[times] flash_fwd at the training shape (B {b}, {hq}/{hkv} "
                  f"heads, S {s}, D {d}, causal, f32): kernel "
                  f"{fwd_row['train_shape_ms']:.4f} ms, plain "
                  f"{fwd_row['train_shape_plain_ms']:.4f} ms, sdpa "
                  f"{fwd_row['train_shape_library_ms']:.4f} ms, bound "
                  f"{fb['bound_ms']:.4f} ms (TF32 tensor cores), "
                  f"{fb['bound_ms_no_tensor_cores']:.4f} ms without", flush=True)

        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), 10)
        del qg, kg, vg, out

        call = lambda: kbwd.launch_bwd(q, k, v, lse, do, delta, **kw)  # noqa: E731
        got, again = call(), call()
        rerun = _maxerr(got[0], again[0])
        bd = bounds(flops, 3 * q_bytes + 4 * kv_bytes + rows_bytes, dn)
        part = {"ms": time_ms(torch, call, 10), "library_ms": lib_ms, **bd,
                "dq_rerun_max_abs_diff": rerun}
        if dtype == torch.float32:
            plain = kbwd.flash_bwd_torch(q, k, v, lse, do, delta, **kw)
            part["max_abs_err"] = max(_maxerr(g, gp) for g, gp in zip(got, plain))
            part["plain_ms"] = time_ms(
                torch, lambda: kbwd.flash_bwd_torch(q, k, v, lse, do, delta, **kw),
                2, warmup=1)
            part["bound_ms_3xtf32"] = 3 * flops / PEAK_FLOPS["float32"] * 1e3
            row.update(part)
            del plain
        else:
            row.update({f"bf16_{key}": val for key, val in part.items()})
        print(f"[times] flash_bwd at the training shape (B {b}, {hq}/{hkv} heads, "
              f"S {s}, D {d}, causal, {dn}): kernel {part['ms']:.4f} ms"
              + (f", plain {part['plain_ms']:.4f} ms" if "plain_ms" in part else "")
              + f", sdpa backward (dq, dk and dv together) {lib_ms:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}; {dn} tensor cores)"
              + (f", 3xTF32 {part['bound_ms_3xtf32']:.4f} ms" if "bound_ms_3xtf32" in part
                 else "")
              + f", without tensor cores {bd['bound_ms_no_tensor_cores']:.4f} ms; "
              f"{flops / part['ms'] / 1e9:.1f} TFLOP/s; max|dq(run 1) - dq(run 2)| "
              f"{rerun:.3e}", flush=True)
        del q, k, v, do, o, lse, delta, got, again
    torch.cuda.empty_cache()
    return row


def paged_times_phase(torch, kdecode, paged_launches, errs):
    """The paged decode kernel at the engine's decode shape (B 8, 32/8
    heads, D 64, page 16, T 37, kv_len 528-576) and at a 256-token chunk's
    shape (256 token rows reading one table up to positions 301-556), f32,
    beside its plain version, SDPA on the contiguous equivalent (ragged
    lengths as a boolean mask; the page gather excluded) and its bound: the
    K/V rows the rows read (each distinct row once), q and o, the tables."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(77)
    f32 = torch.float32
    hq, hkv, d, ps, t = 32, 8, 64, 16, 37
    shapes = {
        "decode": torch.randint(528, 577, (8,), generator=gen, device="cuda",
                                dtype=torch.int32),
        "chunk": torch.arange(301, 557, device="cuda", dtype=torch.int32),
    }
    out = {}
    for shape, kv_len in shapes.items():
        q, kp, vp, bt = _paged_case(torch, gen, kv_len, hq, hkv, d, ps, t, f32)
        if shape == "chunk":
            bt = bt[-1:].expand(kv_len.shape[0], t).contiguous()
        b = kv_len.shape[0]
        o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len)
        err = _maxerr(o, kdecode.flash_paged_decode_torch(q, kp, vp, bt,
                                                          kv_len=kv_len))
        pos = torch.arange(t * ps, device="cuda")
        read = pos[None, :] < kv_len[:, None]                       # [B, S]
        slots = (bt.long()[:, pos // ps] * ps + pos % ps)[read]
        rows = int(torch.unique(slots).numel())                     # distinct K/V rows
        nbytes = 4 * (2 * rows * hkv * d + 2 * b * hq * d) + 4 * (b * t + b)
        flops = 4 * hq * d * int(kv_len.sum())
        kc, vc = kdecode.gather_pages(kp, bt), kdecode.gather_pages(vp, bt)
        mask = read[:, None, None, :]
        iters = 50 if shape == "decode" else 20
        out[shape] = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: kdecode.flash_paged_decode(
                q, kp, vp, bt, kv_len), iters),
            "plain_ms": time_ms(torch, lambda: kdecode.flash_paged_decode_torch(
                q, kp, vp, bt, kv_len=kv_len), 5),
            **bounds(flops, nbytes),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True), iters),
        }
        print(f"[times] flash_paged_decode at the {shape} shape (B {b}, {hq}/{hkv} "
              f"heads, D {d}, page {ps}, T {t}, kv_len {int(kv_len.min())}-"
              f"{int(kv_len.max())}, {rows} distinct K/V rows, f32): kernel "
              f"{out[shape]['ms']:.5f} ms, plain {out[shape]['plain_ms']:.4f} ms, "
              f"sdpa on the contiguous equivalent (gather excluded) "
              f"{out[shape]['library_ms']:.5f} ms, bound "
              f"{out[shape]['bound_ms']:.5f} ms ({out[shape]['bound_by']}; "
              f"without tensor cores {out[shape]['bound_ms_no_tensor_cores']:.5f} ms)")
        del q, kp, vp, bt, kc, vc, o
    row = {"name": "flash_paged_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
           "replaces": "src/repro/kernels/decode.py:136",
           "launches": paged_launches["flash_paged_decode"], **out["decode"],
           "launches_by_path": {"paged_serve": paged_launches["by_mode"]},
           "library_note": "sdpa on the gathered contiguous cache, gather excluded"}
    row.update({f"chunk_shape_{k}": v for k, v in out["chunk"].items()})
    worst = max(v for k, v in errs.items() if k.startswith("flash_paged_decode/"))
    print(f"[times] worst paged kernel-vs-plain error over the kernel phase {worst:.3e}")
    torch.cuda.empty_cache()
    return row


def gated_times_phase(torch, kdecode, dist_launches, errs):
    """The gated paged kernel for one shard of two, at the distributed
    engine's decode shape (B 8, 32/8 heads, D 64, page 16, T 37, kv_len
    528-576) and chunk shape (256 token rows reading one table up to
    positions 301-556), f32, beside its plain version, its bound (the K/V
    rows this shard owns, each once; q, the partial outputs, the tables)
    and, as the library yardstick, aten's memory-efficient attention with
    its log-sum-exp (the same state, normalised) on the owned rows, gathered
    and head-expanded outside the timing."""
    from repro_torch.distributed.paged import _local_ids

    gen = torch.Generator(device="cuda").manual_seed(78)
    f32 = torch.float32
    hq, hkv, d, ps, t = 32, 8, 64, 16, 37
    shapes = {
        "decode": torch.randint(528, 577, (8,), generator=gen, device="cuda",
                                dtype=torch.int32),
        "chunk": torch.arange(301, 557, device="cuda", dtype=torch.int32),
    }
    out = {}
    for shape, kv_len in shapes.items():
        b = kv_len.shape[0]
        # the chunk's rows share one table, built for its longest row
        table_len = kv_len if shape == "decode" else kv_len[-1:]
        q, kp, vp, bt, n_local = _sharded_case(torch, gen, table_len, hq, hkv,
                                               d, ps, t, f32)
        if shape == "chunk":
            q = _rand(torch, gen, (b, hq, d), f32)
            bt = bt.expand(b, t).contiguous()
        bt_l, valid = (x.contiguous() for x in _local_ids(bt, n_local, 0))
        kl = kp[:, :n_local].contiguous()
        vl = vp[:, :n_local].contiguous()
        del kp, vp
        call = lambda: kdecode.flash_paged_decode_partials(      # noqa: E731
            q, kl, vl, bt_l, kv_len, block_valid=valid)
        part = call()
        ref = kdecode.flash_paged_decode_partials_torch(
            q, kl, vl, bt_l, kv_len=kv_len, block_valid=valid)
        err = _maxerr(_state_out(torch, *part)[0], _state_out(torch, *ref)[0])
        pos = torch.arange(t * ps, device="cuda")
        read = (pos[None, :] < kv_len[:, None]) & (valid[:, pos // ps] != 0)
        slots = (bt_l.long()[:, pos // ps] * ps + pos % ps)[read]
        rows = int(torch.unique(slots).numel())              # owned K/V rows
        nbytes = (4 * (2 * rows * hkv * d + b * hq * d)      # K/V rows, q
                  + 4 * (b * hq * d + 2 * b * hq)            # acc, m, l
                  + 4 * (2 * b * t + b))                     # tables, kv_len
        flops = 4 * hq * d * int(read.sum())
        iters = 50 if shape == "decode" else 20
        row = {
            "max_abs_err": err,
            "ms": time_ms(torch, call, iters),
            "plain_ms": time_ms(torch, lambda: kdecode.flash_paged_decode_partials_torch(
                q, kl, vl, bt_l, kv_len=kv_len, block_valid=valid), 5),
            **bounds(flops, nbytes),
            "library_ms": None,
        }
        try:   # the yardstick: (o, lse) over the owned rows, gather excluded
            kc = kdecode.gather_pages(kl, bt_l).repeat_interleave(hq // hkv, dim=1)
            vc = kdecode.gather_pages(vl, bt_l).repeat_interleave(hq // hkv, dim=1)
            bias = torch.zeros((b, hq, 1, t * ps), device="cuda", dtype=f32)
            bias.masked_fill_(~read[:, None, None, :], float("-inf"))
            q4 = q[:, :, None].contiguous()
            eff = torch.ops.aten._scaled_dot_product_efficient_attention
            eff(q4, kc, vc, bias, True)
            row["library_ms"] = time_ms(torch, lambda: eff(q4, kc, vc, bias, True),
                                        iters)
            del kc, vc, bias
        except (RuntimeError, NotImplementedError) as e:
            row["library_note"] = f"none: {type(e).__name__}: {str(e)[:200]}"
        out[shape] = row
        lib = (f"{row['library_ms']:.5f} ms" if row["library_ms"] is not None
               else row["library_note"])
        print(f"[times] flash_paged_decode_partials at the {shape} shape, one "
              f"shard of two (B {b}, {hq}/{hkv} heads, D {d}, page {ps}, T {t}, "
              f"kv_len {int(kv_len.min())}-{int(kv_len.max())}, {rows} owned "
              f"K/V rows, f32): kernel {row['ms']:.5f} ms, plain "
              f"{row['plain_ms']:.4f} ms, efficient attention with lse on the "
              f"owned rows (gather excluded) {lib}, bound {row['bound_ms']:.5f} "
              f"ms ({row['bound_by']}; without tensor cores "
              f"{row['bound_ms_no_tensor_cores']:.5f} ms)", flush=True)
        del q, kl, vl, bt, bt_l, valid
    result = {"name": "flash_paged_decode_partials", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
              "replaces": "src/repro/kernels/decode.py:144",
              "launches": dist_launches["total"], **out["decode"],
              "launches_by_path": {"dist_paged_serve_rank0": dist_launches["by_mode"]},
              "library_call": "aten._scaled_dot_product_efficient_attention "
                              "(compute_log_sumexp) on the owned rows"}
    result.update({f"chunk_shape_{k}": v for k, v in out["chunk"].items()})
    worst = max(v for k, v in errs.items()
                if k.startswith("flash_paged_decode_partials/"))
    print(f"[times] worst gated kernel-vs-plain error over the kernel phase "
          f"(gate and two-shard checks, f32 and bf16) {worst:.3e}")
    torch.cuda.empty_cache()
    return result


if __name__ == "__main__":
    main()
