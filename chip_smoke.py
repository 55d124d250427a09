#!/usr/bin/env python3
"""Build and drive the PyTorch / CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device  — the card's name, count, and ``nvidia-smi`` name / power limit;
2. build   — nvcc builds the three CUDA kernel libraries from
             ``kernels/csrc`` in parallel and prints ptxas's registers and
             spills per instantiation (no forward instantiation, and not
             the f32 and bf16 D=64 and D=256 backward kernels, granite's and
             the hybrid's training paths', may spill; the D=128 ones,
             deepseek-moe-16b's, spill and are printed) and the count of
             tensor-core instructions (HMMA / HGMMA in ``cuobjdump -sass``)
             of every forward instantiation and of those four backward
             ones, which must not be 0;
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
             merged against the ungated kernel on the whole pool; both
             also at a packed chunk row of 256 token rows over three tables
             and padding (query tiles with mixed tables, ``row_tokens``
             256) at D 64, D 32 and D 128 with a GQA group of 5, and each
             case's launch geometry printed (clusters at the decode shape,
             which must put a block on every SM); and every kernel at
             recurrentgemma-2b's geometry (10/1 heads, D 256): the forward
             at B 2, S 3072, causal, window 2048 and with ragged segments,
             the contiguous decode over a ring of 2048 slots (kv_len with
             0), the paged and the gated decode at page 16, window 2048
             (out-of-window pages reclaimed to the 1e6 trash page) and at
             256 chunk token rows; and the backward at recurrentgemma-2b's
             training geometry (B 1, 10/1 heads, D 256, S 3072, causal,
             window 2048) in f32 and bf16, with bf16-ACC, dropout 0.1 and
             segments; and every kernel at the MoE family's shapes (D 128):
             deepseek-moe-16b's 16/16 heads (a GQA group of 1) in the
             forward at prefill (B 4, S 512) and training (B 2, S 2048,
             dropout 0.1), the backward at training (f32, bf16, bf16-ACC),
             the contiguous decode over 544 slots, the paged and gated decode
             at page 16 (decode rows, 256 chunk rows, a mixed chunk row), and
             dbrx-132b's 48/8 heads (a group of 6) in the forward (B 2, S
             256) and the decode over 272 slots;
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
4d. hybrid — recurrentgemma-2b (26 layers: 18 RG-LRU, 8 local
             attention; d_model 2560, 10/1 heads, head dim 256, window 2048,
             vocab 256000) at full width and depth, f32, random weights from
             seed 0: (a) the contiguous path, batch 4, prompt 3072 (past the
             window: prefill masks, the ring rolls), 32 generated, kernel vs
             torch impl (greedy tokens identical, logits within 1e-3 of
             max|logit|, counters 8 ``flash_fwd`` and 8 x 31
             ``flash_decode``); (b) the paged engine (page 16, 8 slots) on
             12 seeded requests of 1024-3072 prompt and 16-48 new tokens in
             three modes: eager with window reclaim, lazy on half the pool
             with preemption forced by a seeded storm plan and
             ``poison_reclaimed``, chunked prefill of 512: tokens equal to
             the torch impl's up to a printed near-tie, counters 8 x calls;
             prefix sharing and speculation refused; peak memory;
4e. moe    — deepseek-moe-16b (28 layers, d_model 2048, 16/16 heads, head
             dim 128, 64 experts top 6 and 2 shared, capacity factor 1.25,
             groups of 256, vocab 102400) at full width and depth, f32,
             random weights from seed 0, one set of params for both impls
             and both caches: (a) the contiguous path, batch 4, prompt 512,
             32 generated, kernel vs torch impl fed the kernel run's
             tokens, counters 28 ``flash_fwd`` and 28 x 31 ``flash_decode``;
             (b) the paged engine on 8 of (b)'s seeded requests in its four
             modes (the lazy one with a storm-forced preemption); (c)
             dbrx-132b (48/8 heads, D 128, 16 experts top 4) at full width
             and 2 layers, batch 2, prompt 256, 16 generated, counters 2 and
             2 x 15. Both impls' expert choices are recorded a layer
             (``models/moe_routes.RouteRecorder`` wraps ``models/moe.py``'s
             top-k; the model has no flag for it): at most ``MOE_FLIP_TOL`` of them may
             differ, the flips are printed with their rows, and the logits
             of the rows routed alike in every layer (capacity included)
             are held to ``LOGIT_REL_TOL``; an engine's tokens may differ
             from the first flipped call on. Prints ``moe_dropped`` at
             prefill, prefill ms, decode tokens/s, a step's time beside the
             bound of reading the weights once, peak memory;
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
5b. hybrid — recurrentgemma-2b's training at full width and depth (f32,
             remat, dropout 0.1, batch 1 × 3072 from ``make_batch``, past
             the 2048 window; AdamW without its f32 master copy, which
             with f32 params is the same update and leaves the state in
             80 GB): (a) as 5a, with three attention leaves and one RG-LRU
             leaf, the counters reading 16 / 8 (8 attention layers, D 256);
             (b) as 5b: step time, tokens/s and peak memory, then a
             profiled step;
5c. moe    — deepseek-moe-16b's training at full width and 4 layers (f32,
             remat, dropout 0.1, batch 2 × 2048 from ``make_batch``, AdamW
             without master): (a) as 5a, the torch pass routed as the
             kernel pass was (its own flips counted, at most
             ``MOE_FLIP_TOL``), leaves wq, the router, wi and lm_head,
             counters 8 / 4; (b) 4 steps with ``moe_aux`` and
             ``moe_dropped`` each, step time, tokens/s, peak memory, then a
             profiled step;
6. times   — each kernel at its path's shapes beside its plain version, one
             PyTorch library call computing the same function
             (``scaled_dot_product_attention`` forward, or its whole
             backward for the fused backward kernel, in f32 and in bf16 at
             the training shape; on the contiguous equivalent for the
             paged decode, gather excluded; aten's memory-efficient attention
             with its log-sum-exp on the owned rows for the gated kernel: a
             yardstick the port never calls) and its bound at the tensor-core
             peak of its dtype (beside the bound without tensor cores),
             printed as one JSON line; the forward's row also carries,
             from ``perf/fwd_times.py``, its device time alone
             (``torch.profiler``), events time, SDPA's time in the same
             dtype and the bounds (TF32 and 3xTF32 for f32) at the
             prefill and training shapes in f32 and bf16 and at the
             training shape with dropout 0.1 (``times_by_case``); the
             decode kernels' rows also carry
             ``device_ms`` (the kernel alone, cold L2) and ``host_us`` (a
             wrapper call) from ``perf/decode_times.py``, at the decode
             shape and (``<shape>_shape_``) at the chunk, at decode with 32
             and 64 slots and at verify (8 slots of 5 token rows); three
             more rows hold rows 1, 4 and 5 at recurrentgemma-2b's prefill,
             decode and paged decode (and 512-token chunk) shapes, and one
             rows 2-3 at its training shape (B 1, S 3072, f32 and bf16),
             with SDPA given the window as a mask; five more hold rows 1-5
             at deepseek-moe-16b's shapes (16/16 heads, D 128) in f32 and
             bf16 (``bf16_``): the prefill (B 4, S 512) and training (B 2,
             S 2048, dropout 0.1) forward, the backward at training, the
             decode (B 4, 544 slots) and the paged decode (8 slots), the
             forward and decode also at dbrx-132b's (``dbrx_shape_``).

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
# phase 5b, recurrentgemma-2b: batch 1 x 3072 (past the 2048 window); the
# leaves of its first attention layer (layer 2) and of its first RG-LRU
HYBRID_BATCH, HYBRID_SEQ = 1, 3072
HYBRID_LEAVES = ("blocks.2.mixer.wq", "blocks.2.mixer.wk", "blocks.2.mixer.wv",
                 "blocks.0.mixer.w_rec")
# phase 5c, deepseek-moe-16b at full width and 4 layers: batch 2 x 2048
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 2, 2048
MOE_LEAVES = ("blocks.0.mixer.wq", "blocks.0.mlp.router", "blocks.0.mlp.wi",
              "lm_head")
# the training phases: arch → (tag, batch, seq, leaves checked, AdamW's f32
# master copy, layers (None: the config's))
TRAIN_SETUPS = {
    "granite_3_2b": ("[train]", TRAIN_BATCH, TRAIN_SEQ, TRAIN_LEAVES, True,
                     None),
    # 3.55 B f32 params, grads, m and v are 56.8 GB; a master copy of f32
    # params (the same update) would add 14.2 GB
    "recurrentgemma_2b": ("[hybrid train]", HYBRID_BATCH, HYBRID_SEQ,
                          HYBRID_LEAVES, False, None),
    "deepseek_moe_16b": ("[moe train]", MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                         MOE_LEAVES, False, MOE_TRAIN_LAYERS),
}


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

    # ---------------- phase 4d: the hybrid recurrentgemma-2b ----------------
    torch.cuda.reset_peak_memory_stats()
    hybrid_launches = serve_phase(torch, kfwd, kdecode, "recurrentgemma_2b",
                                  batch=4, prompt_len=3072, gen_len=32,
                                  tag="hybrid")
    hybrid_paged = hybrid_paged_phase(torch, kfwd, kdecode)
    print(f"[hybrid] peak max_memory_allocated over phase 4d "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # ---------------- phase 4e: the MoE family ----------------
    moe_serve = moe_serve_phase(torch, kfwd, kdecode)

    # ---------------- phase 5: the training path ----------------
    train_launches = train_phase(torch, kfwd, kbwd)
    hybrid_train = train_phase(torch, kfwd, kbwd, "recurrentgemma_2b")
    moe_train = train_phase(torch, kfwd, kbwd, "deepseek_moe_16b")      # 5c

    # ---------------- phase 6: times ----------------
    rows = times_phase(torch, kfwd, kdecode, launches, errs)
    rows.append(bwd_times_phase(torch, kfwd, kbwd, train_launches, rows[0]))
    fwd_times_phase(rows[0])
    rows.append(paged_times_phase(torch, kdecode, paged_launches, errs))
    rows.append(gated_times_phase(torch, kdecode, dist_launches, errs))
    device_times_phase(rows)
    rows[0]["launches_by_path"]["paged_serve"] = paged_launches["flash_fwd"]
    rows += hybrid_times_phase(torch, kfwd, kdecode, hybrid_launches,
                               hybrid_paged, hybrid_train, errs)
    rows.append(hybrid_bwd_times_phase(torch, kfwd, kbwd, hybrid_train))
    rows += moe_times_phase(torch, kfwd, kbwd, kdecode, moe_serve, moe_train)
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


# the backward instantiations of the training paths: granite (D 64) and
# recurrentgemma-2b (D 256)
BWD_TRAIN = ("flash_bwd_kernel<f32, D64>", "flash_bwd_kernel<bf16, D64>",
             "flash_bwd_kernel<f32, D256>", "flash_bwd_kernel<bf16, D256>")


def build_report(_build) -> None:
    """ptxas's registers and spills per kernel instantiation, and the
    tensor-core instructions of the forward and backward kernels; fails if
    a forward instantiation or an f32 or bf16 D=64 or D=256 backward kernel
    (the training paths') spills or has none."""
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
                         f"{', paged' if 'PagedCache' in line else ''}"
                         f"{', query tiles' if 'ELb1EEEvNS_12Decode' in line else ''}>"
                         if m else line.split("'")[1][:60])
                continue
            if "spill" in line:
                spills = line.strip()
                n = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                              spills)
                if ((entry in BWD_TRAIN or str(entry).startswith("fwd_kernel"))
                        and (n is None or n.groups() != ("0", "0"))):
                    fail(f"{kname} {entry} spills: {spills}")
                continue
            if "registers" in line:
                regs = line.split(":", 1)[-1].strip()
                print(f"[build] {kname} {entry}: {regs}; {spills}")
    mma = tensor_core_instructions(_build, "flash_bwd")
    fwd = tensor_core_instructions(_build, "flash_fwd")
    want = [*BWD_TRAIN, *(f"fwd_kernel<{t}, D{d}{acc}>" for t in ("f32", "bf16")
                        for d in (16, 32, 64, 128, 256) for acc in ("", ", acc bf16"))]
    for entry in want:
        n = mma.get(entry, fwd.get(entry, 0))
        print(f"[build] {entry}: {n} tensor-core instructions (HMMA / HGMMA in "
              f"cuobjdump -sass)")
        if not n:
            fail(f"{entry} has no tensor-core instruction")
    sys.stdout.flush()


def tensor_core_instructions(_build, kname: str) -> dict:
    """{"flash_bwd_kernel<f32, D64>": count, ...}: HMMA and HGMMA lines per
    kernel instantiation in ``cuobjdump -sass`` of library ``kname``."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = _build.build([kname])[kname]
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed ({out.returncode}): {out.stderr[:500]}")
    counts = {}
    for part in out.stdout.split("Function : ")[1:]:
        m = re.match(r"\S*?\d+([a-z_]+_kernel)I(f|13__nv_bfloat16)Li(\d+)ELb([01])E", part)
        if m:
            name = (f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}, "
                    f"D{m.group(3)}{', acc bf16' if m.group(4) == '1' else ''}>")
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
        # recurrentgemma-2b's attention (10/1 heads, D 256, window 2048): a
        # prefill past the window, whole tiles behind every row's window
        ("rg_s3072_window2048", 2, 10, 1, 3072, 3072, 256,
         dict(causal=True, window=2048)),
        ("rg_segments_ragged_1000", 2, 10, 1, 1000, 1000, 256,
         dict(causal=True, window=2048, segments=True)),
        # the MoE family at D 128: deepseek-moe-16b's 16/16 heads at prefill
        # and in training, dbrx-132b's 48/8 heads at prefill
        ("moe_prefill_g1_d128", 4, 16, 16, 512, 512, 128, dict(causal=True)),
        ("moe_train_g1_d128_dropout_0.1", 2, 16, 16, 2048, 2048, 128,
         dict(causal=True, dropout_rate=0.1, dropout_seed=-9)),
        ("dbrx_prefill_g6_d128", 2, 48, 8, 256, 256, 128, dict(causal=True)),
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

        # recurrentgemma-2b's decode: a ring of 2048 slots, 10/1 heads, D 256
        kv_len = torch.tensor([2048, 0, 700, 2047], dtype=torch.int32,
                              device="cuda")
        q = _rand(torch, gen, (4, 10, 256), dtype)
        k = _rand(torch, gen, (4, 1, 2048, 256), dtype)
        v = _rand(torch, gen, (4, 1, 2048, 256), dtype)
        for ns in (1, 3):
            o = kdecode.flash_decode(q, k, v, kv_len=kv_len, num_splits=ns)
            torch.cuda.synchronize()
            e = _maxerr(o, kdecode.flash_decode_torch(q, k, v, kv_len=kv_len,
                                                      num_splits=ns))
            ok = e <= TOL[dn] and float(o[1].abs().max()) == 0.0
            print(f"[kernels] flash_decode rg_ring2048_g10_d256 splits={ns} "
                  f"{dn}: max|o - plain| {e:.3e} (tol {TOL[dn]:.1e}), kv_len=0 "
                  f"row zero: {float(o[1].abs().max()) == 0.0} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"flash_decode rg_ring2048_g10_d256 splits={ns} {dn} "
                     f"disagrees with its plain version")
            errs[f"flash_decode/rg_ring2048_g10_d256/ns{ns}/{dn}"] = e
        del q, k, v, o

        # the MoE family's decode at D 128: deepseek-moe-16b's 16/16 heads
        # over 544 slots, dbrx-132b's 48/8 over 272 (kv_len with 0)
        for name, hq, hkv, lens in (("moe_g1_d128_544", 16, 16, [528, 0, 544, 301]),
                                    ("dbrx_g6_d128_272", 48, 8, [264, 0])):
            b, cap = len(lens), max(lens)
            kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
            q = _rand(torch, gen, (b, hq, 128), dtype)
            k = _rand(torch, gen, (b, hkv, cap, 128), dtype)
            v = _rand(torch, gen, (b, hkv, cap, 128), dtype)
            for ns in (1, 3):
                o = kdecode.flash_decode(q, k, v, kv_len=kv_len, num_splits=ns)
                torch.cuda.synchronize()
                e = _maxerr(o, kdecode.flash_decode_torch(q, k, v, kv_len=kv_len,
                                                          num_splits=ns))
                ok = e <= TOL[dn] and float(o[1].abs().max()) == 0.0
                print(f"[kernels] flash_decode {name} splits={ns} {dn}: max|o - "
                      f"plain| {e:.3e} (tol {TOL[dn]:.1e}), kv_len=0 row zero: "
                      f"{float(o[1].abs().max()) == 0.0} {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    fail(f"flash_decode {name} splits={ns} {dn} disagrees with "
                         f"its plain version")
                errs[f"flash_decode/{name}/ns{ns}/{dn}"] = e
            del q, k, v, o

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


# a packed chunk row of granite's chunk width: spans (history, new tokens)
# of three sequences, each its own table, then padding rows (the trash
# table, kv_len 0), as ``serving/engine.py`` packs a chunk
CHUNK_MIXED = ([(300, 120), (0, 64), (180, 60)], 12)


def _token_rows_case(torch, gen, hq, hkv, d, ps, t, dtype, spans, pads):
    """q, a pool and the token rows' tables and kv_len for ``spans`` and
    ``pads`` (``CHUNK_MIXED``); the trash page 0 holds 1e6."""
    n_pages = 1 + len(spans) * t
    kp = _rand(torch, gen, (hkv, n_pages, ps, d), dtype)
    vp = _rand(torch, gen, (hkv, n_pages, ps, d), dtype)
    kp[:, 0], vp[:, 0] = 1e6, 1e6
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    tables, lens = [], []
    for i, (h, n) in enumerate(spans):
        table = perm[i * t:(i + 1) * t].to(torch.int32)
        table[-(-(h + n) // ps):] = 0                  # past the allocation
        tables += [table] * n
        lens += list(range(h + 1, h + n + 1))
    tables += [torch.zeros_like(tables[0])] * pads
    lens += [0] * pads
    q = _rand(torch, gen, (len(lens), hq, d), dtype)
    return (q, kp, vp, torch.stack(tables).contiguous(),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


def _geometry_line(torch, kdecode, name, rows, hq, hkv, skv, ns, row_tokens, d):
    """Print a launch's geometry (f32, paged); at the engine's decode shape
    (8 rows of 8 kv heads) fail unless it puts a block on every SM in
    clusters."""
    geo = kdecode.launch_geometry(rows, hq, hkv, skv, ns, row_tokens=row_tokens,
                                  head_dim=d)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clusters = geo["blocks"] // geo["cluster"]
    print(f"[kernels] {name} splits={ns}: {rows} rows (row_tokens {row_tokens}) -> "
          f"{geo['rows_per_block']} a block, {clusters} clusters of {geo['cluster']} ({geo['blocks']} "
          f"blocks on {sms} SMs; the card holds {geo['resident_clusters']} such "
          f"clusters at once)", flush=True)
    if rows * hkv == 64 and ns == 1 and (
            geo["cluster"] < 2 or geo["blocks"] < sms
            or geo["resident_clusters"] < clusters):
        fail(f"{name}: the decode shape leaves SMs without a block ({geo})")
    return geo


def paged_kernel_phase(torch, kdecode):
    """The paged decode kernel against its plain version, f32 and bf16, and
    bit for bit against the contiguous kernel on the gathered pages; each
    case's launch geometry (clusters at the decode shape, query tiles for
    token rows)."""
    gen = torch.Generator(device="cuda").manual_seed(2024)
    cases = [
        # name, kv_len, hq, hkv, d, page size, table width, window
        ("ps16_g4", [576, 0, 528, 1, 300, 129, 555, 17], 32, 8, 64, 16, 37, None),
        ("ps4_g5_d128", [592, 40, 0, 333], 40, 8, 128, 4, 148, None),
        ("ps32_g4_window", [600, 0, 256, 31, 500, 64, 449, 2], 32, 8, 64, 32, 19, 100),
        ("chunk_256_rows", [0] * 16 + list(range(301, 541)), 32, 8, 64, 16, 37, None),
        ("chunk_mixed_tables", None, 32, 8, 64, 16, 37, None),
        ("chunk_mixed_d32", None, 32, 8, 32, 16, 37, None),
        ("chunk_mixed_g5_d128", None, 40, 8, 128, 16, 37, None),
        # recurrentgemma-2b: 10/1 heads, D 256, page 16, window 2048; decode
        # rows whose out-of-window pages are reclaimed (trash, 1e6), and a
        # chunk of 256 token rows of one table (query tiles of 6 rows)
        ("rg_ps16_g10_d256_window", [3120, 0, 2049, 1040, 17, 2600, 3000, 2048],
         10, 1, 256, 16, 196, 2048),
        ("chunk_256_rows_rg_window", [0] * 16 + list(range(2801, 3041)),
         10, 1, 256, 16, 196, 2048),
        # deepseek-moe-16b: 16/16 heads, D 128, the engine's page 16 and 37
        # pages a sequence; decode rows, a 256-row chunk, a mixed chunk row
        ("moe_ps16_g1_d128", [576, 0, 128, 333, 512, 17, 449, 200], 16, 16, 128,
         16, 37, None),
        ("chunk_256_rows_g1_d128", [0] * 16 + list(range(301, 541)), 16, 16,
         128, 16, 37, None),
        ("chunk_mixed_g1_d128", None, 16, 16, 128, 16, 37, None),
    ]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for name, lens, hq, hkv, d, ps, t, window in cases:
            if lens is None:                 # spans of three tables, padding
                q, kp, vp, bt, kv_len = _token_rows_case(
                    torch, gen, hq, hkv, d, ps, t, dtype, *CHUNK_MIXED)
                lens = kv_len.tolist()
            else:
                kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
                # a chunk's rows share the last row's table: nothing reclaimed
                q, kp, vp, bt = _paged_case(
                    torch, gen, kv_len, hq, hkv, d, ps, t, dtype,
                    None if name.startswith("chunk") else window)
            if name.startswith("chunk_256_rows"):     # every token row reads one table
                bt = bt[-1:].expand(len(lens), t).contiguous()
            # a chunk's rows are the token rows of one batch row
            rt = len(lens) if name.startswith("chunk") else 1
            kc, vc = kdecode.gather_pages(kp, bt), kdecode.gather_pages(vp, bt)
            zero = kv_len == 0
            for ns in (1, 3):
                if dtype == torch.float32:
                    _geometry_line(torch, kdecode, f"flash_paged_decode {name}",
                                   len(lens), hq, hkv, t * ps, ns, rt, d)
                o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, window=window,
                                               num_splits=ns, row_tokens=rt)
                torch.cuda.synchronize()
                o_ref = kdecode.flash_paged_decode_torch(
                    q, kp, vp, bt, kv_len=kv_len, window=window, num_splits=ns)
                o_contig = kdecode.flash_decode(q, kc, vc, kv_len=kv_len,
                                                window=window, num_splits=ns,
                                                row_tokens=rt)
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
        ("chunk_mixed_tables", None, 32, 8, 64, 16, 37, None),
        ("chunk_mixed_d32", None, 32, 8, 32, 16, 37, None),
        ("chunk_mixed_g5_d128", None, 40, 8, 128, 16, 37, None),
        # recurrentgemma-2b: 10/1 heads, D 256, page 16, window 2048; decode
        # rows whose out-of-window pages are reclaimed (trash, 1e6), and a
        # chunk of 256 token rows of one table (query tiles of 6 rows)
        ("rg_ps16_g10_d256_window", [3120, 0, 2049, 1040, 17, 2600, 3000, 2048],
         10, 1, 256, 16, 196, 2048),
        ("chunk_256_rows_rg_window", [0] * 16 + list(range(2801, 3041)),
         10, 1, 256, 16, 196, 2048),
        # deepseek-moe-16b: 16/16 heads, D 128, the engine's page 16 and 37
        # pages a sequence; decode rows, a 256-row chunk, a mixed chunk row
        ("moe_ps16_g1_d128", [576, 0, 128, 333, 512, 17, 449, 200], 16, 16, 128,
         16, 37, None),
        ("chunk_256_rows_g1_d128", [0] * 16 + list(range(301, 541)), 16, 16,
         128, 16, 37, None),
        ("chunk_mixed_g1_d128", None, 16, 16, 128, 16, 37, None),
    ]
    errs, worst = {}, {"gate": 0.0, "lse": 0.0, "shards": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for name, lens, hq, hkv, d, ps, t, window in cases:
            if lens is None:                 # spans of three tables, padding
                q, kp, vp, bt, kv_len = _token_rows_case(
                    torch, gen, hq, hkv, d, ps, t, dtype, *CHUNK_MIXED)
                lens, n_local = kv_len.tolist(), kp.shape[1] // 2
            else:
                kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
                q, kp, vp, bt, n_local = _sharded_case(
                    torch, gen, kv_len, hq, hkv, d, ps, t, dtype,
                    None if name.startswith("chunk") else window)
            if name.startswith("chunk_256_rows"):     # every token row reads one table
                bt = bt[-1:].expand(len(lens), t).contiguous()
            b = len(lens)
            rt = b if name.startswith("chunk") else 1     # one batch row's tokens
            for ns in (1, 3):
                if dtype == torch.float32:
                    _geometry_line(torch, kdecode,
                                   f"flash_paged_decode_partials {name}", b, hq,
                                   hkv, t * ps, ns, rt, d)
                # (a) the gate alone, on the whole pool
                valid = (torch.rand((b, t), generator=gen, device="cuda") < 0.5
                         ).to(torch.int32)
                if name.startswith("chunk_256_rows"):  # one table: one ownership
                    valid = valid[-1:].expand(b, t).contiguous()
                elif name.startswith("chunk_mixed"):   # ownership by page id
                    valid = (bt % 2).to(torch.int32).contiguous()
                kpa, vpa = kp.clone(), vp.clone()
                foreign = bt[valid == 0].long()
                kpa[:, foreign], vpa[:, foreign] = 1e6, 1e6
                part = kdecode.flash_paged_decode_partials(
                    q, kpa, vpa, bt, kv_len, block_valid=valid, window=window,
                    num_splits=ns, row_tokens=rt)
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
                                                   window=window, num_splits=ns,
                                                   row_tokens=rt)
                states = []
                for shard in range(2):
                    lo = shard * n_local
                    bt_l, valid_l = _local_ids(bt, n_local, shard)
                    acc, m, l = kdecode.flash_paged_decode_partials(
                        q, kp[:, lo:lo + n_local].contiguous(),
                        vp[:, lo:lo + n_local].contiguous(), bt_l.contiguous(),
                        kv_len, block_valid=valid_l.contiguous(),
                        window=window, num_splits=ns, row_tokens=rt)
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
          f"and a group of 1, 4 or 10 in another order); bf16 inputs or bf16-ACC "
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
        # recurrentgemma-2b's training geometry: 32-row kv blocks, four
        # warps on each 16 rows, 10 q heads a block
        ("rg_s3072", 1, 10, 1, 3072, 3072, 256, dict(causal=True, window=2048)),
        ("rg_dropout_0.1", 1, 10, 1, 3072, 3072, 256,
         dict(causal=True, window=2048, dropout_rate=0.1, dropout_seed=-3)),
        ("rg_segments", 1, 10, 1, 3072, 3072, 256,
         dict(causal=True, window=2048, segments=True)),
        ("rg_bf16_acc", 1, 10, 1, 3072, 3072, 256,
         dict(causal=True, window=2048, acc_dtype=bf16)),
        # deepseek-moe-16b's training geometry: 16/16 heads, D 128
        ("moe_train_g1_d128_dropout_0.1", 2, 16, 16, 2048, 2048, 128,
         dict(causal=True, dropout_rate=0.1, dropout_seed=-11)),
        ("moe_g1_d128_bf16_acc", 2, 16, 16, 2048, 2048, 128,
         dict(causal=True, acc_dtype=bf16)),
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


def serve_phase(torch, kfwd, kdecode, arch="granite_3_2b", batch=8,
                prompt_len=512, gen_len=32, tag="serve"):
    """An arch at full width and depth through the port's contiguous serving
    path (granite-3-2b; phase 4d: recurrentgemma-2b, batch 4, prompt 3072
    past its 2048-token window, so prefill masks and the ring rolls)."""
    from repro_torch import configs
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import lm
    from repro_torch.runtime.steps import make_serve_steps

    cfg = dataclasses.replace(configs.get_config(arch),
                              dtype=torch.float32)   # as launch/serve.py forces
    n_attn = lm.block_kinds(cfg).count("attn")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers ({n_attn} attention), "
          f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"head_dim {cfg.head_dim}, window {cfg.attn_window}, vocab "
          f"{cfg.vocab_size}; {n_params / 1e9:.2f} B params f32 "
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
    want = {"flash_fwd": n_attn, "flash_decode": n_attn * (gen_len - 1)}
    print(f"[{tag}] impl=kernel: prefill {batch}x{prompt_len} "
          f"{run_k.prefill_s * 1e3:.1f} ms; decode {gen_len - 1} steps "
          f"{run_k.decode_s * 1e3:.1f} ms "
          f"({(gen_len - 1) * batch / run_k.decode_s:.1f} tok/s); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"[{tag}] launch counters {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"{arch}: the serving path did not go through the kernels: "
             f"{launches}")

    print(f"[{tag}] tolerance kernel vs torch impl: max |d logit| <= "
          f"{LOGIT_REL_TOL:.0e} x max|logit| ({cfg.num_layers} layers of f32 "
          f"with sums in another order move logits ~1e-6 relative; a wrong "
          f"kernel moves them by far more)")
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
    print(f"[{tag}] impl=torch (fed the kernel run's tokens): prefill "
          f"{run_t.prefill_s * 1e3:.1f} ms; decode {run_t.decode_s * 1e3:.1f} ms")
    print(f"[{tag}] kernel vs torch logits over prefill + {gen_len - 1} steps: "
          f"max |d| / max|logit| {worst:.3e} (tol {LOGIT_REL_TOL:.0e}); "
          f"greedy token match {match:.4f}", flush=True)
    if tag == "hybrid" and match != 1.0:
        fail(f"{arch}: kernel and torch greedy tokens differ ({match:.4f})")
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
    top-2 logit margin and max |logit| of the row that produced it and the
    index of the call that did; with ``routes`` (an MoE arch's routes are
    being recorded), for every call also its kind, its input tokens and the
    request id of each token row (-1 for padding and idle rows). The engine
    is not changed; the wrappers read its scheduler to name rows."""

    def __init__(self, torch, eng, vocab, routes=False):
        self.torch, self.eng, self.vocab, self.routes = torch, eng, vocab, routes
        self.calls = dict.fromkeys(("prefill", "decode", "chunk", "verify"), 0)
        self.margin, self.call_of, self.inputs, self.rids = {}, {}, [], []
        for attr, kind in (("prefill_fn", "prefill"), ("decode_fn", "decode"),
                           ("chunk_prefill_fn", "chunk"), ("verify_fn", "verify")):
            setattr(eng, attr, self._wrap(getattr(eng, attr), kind))

    def _wrap(self, fn, kind):
        def step(params, *args):
            keys = getattr(self, "_" + kind)(*args)   # before the engine appends
            if self.routes:
                self.inputs.append((kind, args[0].cpu()))
                self.rids.append(self._token_rids(kind, args))
            logits, caches = fn(params, *args)
            self.calls[kind] += 1
            self._record(logits, keys)
            return logits, caches
        return step

    def _token_rids(self, kind, args):
        """The request id of each token row of a call, flattened as the
        model flattens its tokens (row-major), -1 for padding."""
        active = self.eng.scheduler.active
        if kind in ("prefill", "chunk"):      # the tokens' decode slots
            slots = (args[4] if kind == "prefill" else args[5]).reshape(-1)
            return [active[s].request.rid if s >= 0 else -1
                    for s in slots.cpu().tolist()]
        rows, width = (args[0].shape[0], 1) if kind == "decode" else args[0].shape
        return [active[s].request.rid if s in active and not active[s].prefilling
                else -1 for s in range(rows) for _ in range(width)]

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
            self.call_of[key] = sum(self.calls.values()) - 1


def _paged_requests(np, vocab, mode, max_prompt, n=PAGED_REQUESTS):
    """``n`` seeded requests, prompts 128-512 tokens and 16-64 generated;
    prefix_chunk opens each with one 256-token system prompt (cut to the
    pool's reach, as launch/serve.py cuts it); speculate_4 tiles an 8-token
    motif, as launch/serve.py builds its --speculate prompts."""
    rs = np.random.RandomState(0)
    system = (rs.randint(0, vocab, size=256) if mode == "prefix_chunk"
              else np.zeros(0, np.int64))
    reqs = []
    for _ in range(n):
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

    cfg = dataclasses.replace(configs.get_config("granite_3_2b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device="cuda")
    modes = _paged_modes(np, cfg, PAGED_REQUESTS, PAGED_MODES, "paged")
    counts, tokens, _ = _engine_modes(torch, kfwd, kdecode, cfg, params, modes,
                                      "paged", PAGED_PROMPT)
    del params
    torch.cuda.empty_cache()
    return counts, tokens


def _paged_modes(np, cfg, n_requests, mode_kw, tag):
    """Phase 4b's pools and requests for ``_engine_modes``: page 16, 8
    slots, 37 pages a sequence, the whole pool (297 pages) or half of it in
    a lazy mode; ``n_requests`` of ``_paged_requests``; ``mode_kw`` the
    engine kwargs by mode."""
    from repro_torch.serving import PagedCacheConfig

    ps, slots = 16, 8
    budget = PAGED_PROMPT + PAGED_GEN
    pages_per_seq = -(-budget // ps) + 1                       # 37
    full_pool = 1 + slots * pages_per_seq                      # 297
    print(f"[{tag}] {cfg.name}, {cfg.num_layers} layers f32 (random, seed 0): "
          f"page {ps}, {slots} slots, {pages_per_seq} pages a sequence, pool "
          f"{full_pool} pages ({(full_pool - 1) // 2 + 1} in lazy mode); "
          f"{n_requests} requests, prompts {PAGED_PROMPT // 4}-{PAGED_PROMPT} "
          f"tokens, {PAGED_GEN // 4}-{PAGED_GEN} generated; near-tie tolerance: "
          f"top-2 margin <= {LOGIT_REL_TOL:.0e} x max|logit|", flush=True)
    modes = {}
    for mode, kw in mode_kw.items():
        lazy = kw.get("lazy", False)
        pcfg = PagedCacheConfig(
            page_size=ps, max_batch=slots, max_pages_per_seq=pages_per_seq,
            num_pages=(full_pool - 1) // 2 + 1 if lazy else full_pool)
        # lazy: a preempted row re-prefills prompt + generated, so a row
        # holds a full budget (launch/serve.py's rule)
        modes[mode] = (pcfg, budget if lazy else PAGED_PROMPT, kw,
                       _paged_requests(np, cfg.vocab_size, mode,
                                       pcfg.max_seq_len - PAGED_GEN - 1,
                                       n_requests))
    return modes


def _engine_route_flips(cfg, rec_k, rec_t, routes_k, routes_t, tag, mode):
    """The kernel and torch runs of one engine mode, compared call by call
    while their step calls took the same tokens: the routing choices of
    the torch run that the kernel run did not make (at most
    ``MOE_FLIP_TOL`` of the decisions), printed with the requests of the
    tokens routed otherwise. Returns the first step call with a flip, or
    None."""
    from repro_torch.models.moe_routes import route_diff

    n_layers = cfg.num_layers
    aligned = 0
    for (kind_k, tok_k), (kind_t, tok_t) in zip(rec_k.inputs, rec_t.inputs):
        if kind_k != kind_t or not tok_k.equal(tok_t):
            break
        aligned += 1
    flips = decisions = 0
    first, where = None, []
    for c in range(aligned):
        for layer in range(n_layers):
            a, b = routes_t.calls[c * n_layers + layer], routes_k.calls[c * n_layers + layer]
            f, changed = route_diff(cfg.moe, a, b)
            flips += f
            decisions += a.numel()
            if bool(changed.any()):
                first = c if first is None else first
                rids = sorted({rec_k.rids[c][j] for j in
                               changed.nonzero()[:, 0].tolist()})
                where.append(f"call {c} ({rec_k.inputs[c][0]}) layer {layer}: "
                             f"requests {rids}")
    print(f"[{tag}] {mode}: routing, torch vs kernel impl over {aligned} step "
          f"calls with equal tokens (of {len(rec_k.inputs)} / "
          f"{len(rec_t.inputs)}): {flips} of {decisions} choices flipped "
          f"({flips / max(decisions, 1):.2e}, tol {MOE_FLIP_TOL:.0e})"
          + "".join(f"; {w}" for w in where[:12]), flush=True)
    if flips > MOE_FLIP_TOL * decisions:
        fail(f"{tag} {mode}: {flips} of {decisions} routing choices flipped")
    return first


def _engine_modes(torch, kfwd, kdecode, cfg, params, modes, tag, torch_chunk):
    """Each mode of ``modes`` ({name: (pool config, prefill row length,
    engine kwargs, requests)}) through ``ServingEngine`` with impl kernel,
    then torch: every request completes, ``flash_fwd`` launches (attention
    layers) x prefill calls and the paged kernel (attention layers) x
    (decode + chunk + verify calls), the torch impl none, a lazy mode
    preempts, and the tokens are equal up to a printed near-tie. For an
    MoE arch the routes of both runs are recorded (``RouteRecorder``), the
    flips held to ``MOE_FLIP_TOL`` and printed, and tokens may also differ
    from the call of the first flip on. Returns the kernel runs' launch
    counts, their (outputs, top-2 margins) and their engine stats by
    mode."""
    import contextlib

    import numpy as np

    from repro_torch.models import lm
    from repro_torch.models.moe_routes import RouteRecorder
    from repro_torch.serving import ServingEngine

    n = lm.block_kinds(cfg).count("attn")
    counts = {"flash_fwd": 0, "flash_paged_decode": 0, "by_mode": {}}
    tokens, kernel_stats = {}, {}
    for mode, (pcfg, prefill_len, kw, reqs) in modes.items():
        runs = {}
        for impl in ("kernel", "torch"):
            eng = ServingEngine(cfg, pcfg, params, impl=impl, device="cuda",
                                prefill_len=prefill_len, torch_chunk=torch_chunk,
                                **kw)
            routes = RouteRecorder() if cfg.moe is not None else None
            rec = StepRecorder(torch, eng, cfg.vocab_size, routes is not None)
            torch.cuda.reset_peak_memory_stats()
            kfwd.launches = kdecode.launches = kdecode.launches_paged = 0
            with routes or contextlib.nullcontext():
                out, stats = eng.run([(t, g) for t, g in reqs])
            torch.cuda.synchronize()
            got = {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches,
                   "flash_paged_decode": kdecode.launches_paged}
            c = rec.calls
            print(f"[{tag}] {mode} impl={impl}: {stats['generated_tokens']:.0f} "
                  f"tokens in {stats['wall_s']:.3f} s = "
                  f"{stats['tokens_per_s']:.1f} tokens/s; "
                  f"{stats['decode_steps']:.0f} decode steps; calls prefill "
                  f"{c['prefill']} / decode {c['decode']} / chunk {c['chunk']} "
                  f"/ verify {c['verify']}; preemptions "
                  f"{stats['preemptions']:.0f}; page utilization "
                  f"{stats['mean_utilization']:.3f}, pool fraction "
                  f"{stats['mean_pool_fraction']:.3f}; pages reclaimed "
                  f"{stats['pages_reclaimed']:.0f}; state releases "
                  f"{stats['state_releases']:.0f}; prefill tokens "
                  f"{stats['prefill_tokens']:.0f} ({stats['prefill_tokens_skipped']:.0f} "
                  f"skipped), cow {stats['cow_copies']:.0f}, drafted "
                  f"{stats['drafted_tokens']:.0f} / accepted "
                  f"{stats['accepted_tokens']:.0f}; max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  f"launches {got}", flush=True)
            if stats["outcomes"]["completed"] != len(reqs):
                fail(f"{tag} {mode} {impl}: outcomes {stats['outcomes']}")
            if impl == "kernel":
                want = {"flash_fwd": n * c["prefill"], "flash_decode": 0,
                        "flash_paged_decode": n * (c["decode"] + c["chunk"]
                                                   + c["verify"])}
                if got != want or want["flash_paged_decode"] == 0:
                    fail(f"{tag} {mode}: the path did not go through the "
                         f"kernels: {got}, expected {want}")
                counts["flash_fwd"] += got["flash_fwd"]
                counts["flash_paged_decode"] += got["flash_paged_decode"]
                counts["by_mode"][mode] = got["flash_paged_decode"]
                kernel_stats[mode] = stats
            elif any(got.values()):
                fail(f"{tag} {mode}: impl='torch' launched a CUDA kernel: {got}")
            runs[impl] = (out, rec, routes)
            rec.eng = eng = None      # the pool goes with the engine
        if kw.get("lazy") and stats["preemptions"] == 0:
            fail(f"{tag} {mode}: the lazy mode preempted no row")
        out_k, rec_k, routes_k = runs["kernel"]
        out_t, rec_t, routes_t = runs["torch"]
        tokens[mode] = (out_k, rec_k.margin)
        first_flip = (None if routes_k is None else _engine_route_flips(
            cfg, rec_k, rec_t, routes_k, routes_t, tag, mode))
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
            if first_flip is not None and first_flip <= rec_k.call_of[(rid, i)]:
                ties[-1] += f", after the routing flip of call {first_flip}"
            elif margin > LOGIT_REL_TOL * peak:
                fail(f"{tag} {mode}: {ties[-1]}: not a near-tie")
        print(f"[{tag}] {mode}: kernel vs torch tokens identical for {same} of "
              f"{len(out_k)} requests"
              + ("".join(f"; near-tie {t}" for t in ties)), flush=True)
    return counts, tokens, kernel_stats


# phase 4d: recurrentgemma-2b, 12 seeded requests of 1024-3072 prompt and
# 16-48 new tokens on page 16 and 8 slots (the pool of a sequence: 196 pages)
HYBRID_REQUESTS, HYBRID_PROMPT, HYBRID_GEN = 12, 3072, 48
HYBRID_MODES = {
    # name: (engine kwargs beyond page 16 and 8 slots, prefill row length,
    # half the pool); window reclaim is on in every mode (the arch has a
    # window), poisoned under the lazy mode
    "eager": ({}, HYBRID_PROMPT, False),
    # preemption forced by a seeded storm plan (serving/faults.py: the
    # youngest rows preempted at three steps): these prompts are long beside
    # their generations, so growth on half the pool never runs dry
    "lazy": ({"lazy": True, "poison_reclaimed": True,
              "fault_plan": dict(seed=3, horizon=40, events_per_kind=3,
                                 kinds=("storm",))},
             HYBRID_PROMPT + HYBRID_GEN, True),
    "chunk_512": ({"prefill_chunk": 512}, 512, False),
}


def _hybrid_requests(np, vocab):
    """12 seeded requests: prompts 1024-3072 tokens, 16-48 generated."""
    rs = np.random.RandomState(1)
    return [(rs.randint(0, vocab, size=int(rs.randint(HYBRID_PROMPT // 3,
                                                       HYBRID_PROMPT + 1))),
             int(rs.randint(HYBRID_GEN // 3, HYBRID_GEN + 1)))
            for _ in range(HYBRID_REQUESTS)]


def hybrid_pool(lazy: bool):
    """Phase 4d's page pool: page 16, 8 slots, 196 pages a sequence; the
    whole pool holds every slot's budget, the lazy one half of it."""
    from repro_torch.serving import PagedCacheConfig

    ps, slots = 16, 8
    pages_per_seq = -(-(HYBRID_PROMPT + HYBRID_GEN) // ps) + 1       # 196
    full = 1 + slots * pages_per_seq                                 # 1569
    return PagedCacheConfig(page_size=ps, max_batch=slots,
                            max_pages_per_seq=pages_per_seq,
                            num_pages=(full - 1) // 2 + 1 if lazy else full)


def hybrid_paged_phase(torch, kfwd, kdecode):
    """recurrentgemma-2b at full width and depth through the paged engine in
    ``HYBRID_MODES`` (``_engine_modes``: kernel impl against torch impl,
    launch counters 8 attention layers x calls, tokens equal up to a
    near-tie); eager must reclaim out-of-window pages; prefix sharing and
    speculation are refused. Returns the kernel runs' launch counts."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import FaultPlan, ServingEngine

    cfg = dataclasses.replace(configs.get_config("recurrentgemma_2b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, seed=0, device="cuda")
    reqs = _hybrid_requests(np, cfg.vocab_size)
    for kw in ({"share_prefix": True}, {"speculate_k": 4}):
        try:
            ServingEngine(cfg, hybrid_pool(False), params, device="cuda", **kw)
        except ValueError as e:
            print(f"[hybrid] {kw} refused: {e}")
        else:
            fail(f"recurrentgemma-2b: the engine accepted {kw}")
    pcfg = hybrid_pool(False)
    print(f"[hybrid] paged: page {pcfg.page_size}, {pcfg.max_batch} slots, "
          f"{pcfg.max_pages_per_seq} pages a sequence, pool {pcfg.num_pages} "
          f"pages ({hybrid_pool(True).num_pages} in lazy mode); "
          f"{len(reqs)} requests, prompts {min(len(t) for t, _ in reqs)}-"
          f"{max(len(t) for t, _ in reqs)} tokens, "
          f"{min(g for _, g in reqs)}-{max(g for _, g in reqs)} generated",
          flush=True)
    modes = {}
    for mode, (kw, prefill_len, lazy) in HYBRID_MODES.items():
        kw = dict(kw)
        if "fault_plan" in kw:
            kw["fault_plan"] = FaultPlan(**kw["fault_plan"])
        modes[mode] = (hybrid_pool(lazy), prefill_len, kw, reqs)
    counts, _, stats = _engine_modes(torch, kfwd, kdecode, cfg, params, modes,
                                     "hybrid", 512)
    if stats["eager"]["pages_reclaimed"] == 0:
        fail("hybrid eager: no page left the 2048-token window")
    del params
    torch.cuda.empty_cache()
    return counts


# phase 4e: deepseek-moe-16b at full width and depth (contiguous batch 4 x
# (512 + 32); the paged engine on 8 of phase 4b's requests in its four
# modes, the lazy one with a storm-forced preemption) and dbrx-132b at full
# width and 2 layers (contiguous batch 2 x (256 + 16))
MOE_BATCH, MOE_PROMPT, MOE_GEN, MOE_REQUESTS = 4, 512, 32, 8
DBRX_LAYERS, DBRX_BATCH, DBRX_PROMPT, DBRX_GEN = 2, 2, 256, 16
MOE_PAGED_MODES = dict(PAGED_MODES, lazy={
    "lazy": True, "fault_plan": dict(seed=3, horizon=40, events_per_kind=3,
                                     kinds=("storm",))})
# kernel and torch impl differ by ~1e-6 in attention outputs, enough to
# swap a token's k-th and (k+1)-th expert where they nearly tie: at most
# this fraction of the routing choices may flip
MOE_FLIP_TOL = 1e-3


def moe_serve_phase(torch, kfwd, kdecode):
    """Phase 4e: deepseek-moe-16b at full width and depth (28 layers, f32,
    random weights from seed 0) on the contiguous path and through the
    paged engine on one set of params, then dbrx-132b at full width and 2
    layers on the contiguous path. Returns the kernel runs' launch counts
    by path."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.serving import FaultPlan

    cfg = dataclasses.replace(configs.get_config("deepseek_moe_16b"),
                              dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    params = _moe_params(torch, cfg, "moe")
    contiguous = _moe_contiguous(torch, kfwd, kdecode, cfg, params, MOE_BATCH,
                                 MOE_PROMPT, MOE_GEN, "moe")
    modes = _paged_modes(np, cfg, MOE_REQUESTS, MOE_PAGED_MODES, "moe paged")
    pcfg, prefill_len, kw, reqs = modes["lazy"]
    modes["lazy"] = (pcfg, prefill_len,
                     dict(kw, fault_plan=FaultPlan(**kw["fault_plan"])), reqs)
    paged, _, _ = _engine_modes(torch, kfwd, kdecode, cfg, params, modes,
                                "moe paged", MOE_PROMPT)
    del params
    torch.cuda.empty_cache()

    dcfg = dataclasses.replace(configs.get_config("dbrx_132b"),
                               num_layers=DBRX_LAYERS, dtype=torch.float32)
    params = _moe_params(torch, dcfg, "dbrx")
    dbrx = _moe_contiguous(torch, kfwd, kdecode, dcfg, params, DBRX_BATCH,
                           DBRX_PROMPT, DBRX_GEN, "dbrx")
    del params
    torch.cuda.empty_cache()
    return {"serve": contiguous, "paged": paged, "dbrx": dbrx}


def _moe_params(torch, cfg, tag):
    from repro_torch.models import lm

    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    m = cfg.moe
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, "
          f"vocab {cfg.vocab_size}; {m.num_experts} experts top {m.top_k} "
          f"(d_ff {m.d_ff_expert}, {m.num_shared_experts} shared), capacity "
          f"factor {m.capacity_factor}, groups of {m.group_size}; "
          f"{n_params / 1e9:.3f} B params f32 = {4 * n_params / 2**30:.2f} GiB "
          f"(random, seed 0) in {time.perf_counter() - t0:.1f} s", flush=True)
    return params


def _moe_contiguous(torch, kfwd, kdecode, cfg, params, batch, prompt_len,
                    gen_len, tag):
    """An MoE arch through the contiguous serving path, kernel impl, then
    torch impl fed the kernel run's tokens, both runs' routes recorded:
    launch counters (one forward launch a layer, one decode launch a layer
    a step), routing flips at most ``MOE_FLIP_TOL`` of the choices, printed
    with their rows; the logits of every (row, step) whose tokens were
    routed alike in every layer up to then (capacity groups included)
    within ``LOGIT_REL_TOL`` of max|logit|. Prints prefill ms, decode
    tokens/s and ms a step beside the bound of reading every weight once,
    ``moe_dropped`` at prefill and peak memory. Returns the launch counts."""
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models.moe_routes import (RouteRecorder, dropped_fraction,
                                               route_diff)
    from repro_torch.runtime.steps import make_serve_steps

    n_layers = cfg.num_layers
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g,
                           device="cuda")

    def steps(impl):
        return make_serve_steps(cfg, impl=impl, max_len=prompt_len + gen_len,
                                batch=batch, torch_chunk=prompt_len,
                                device="cuda")

    torch.cuda.reset_peak_memory_stats()
    kfwd.launches = kdecode.launches = 0
    with RouteRecorder() as routes_k:
        run_k = greedy_generate(steps("kernel"), params, prompt, gen_len,
                                cfg.vocab_size)
    launches = {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches}
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": n_layers, "flash_decode": n_layers * (gen_len - 1)}
    expert_bytes = sum(4 * (b.mlp.wi.numel() + b.mlp.wo.numel())
                       for b in params.blocks)
    weight_bytes = sum(4 * p.numel() for n, p in params.named_parameters()
                       if n != "embed")
    step_ms = run_k.decode_s * 1e3 / (gen_len - 1)
    print(f"[{tag}] impl=kernel: prefill {batch}x{prompt_len} "
          f"{run_k.prefill_s * 1e3:.1f} ms; decode {gen_len - 1} steps "
          f"{run_k.decode_s * 1e3:.1f} ms = {step_ms:.2f} ms a step "
          f"({(gen_len - 1) * batch / run_k.decode_s:.1f} tok/s); bound a step "
          f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms for the expert "
          f"weights ({expert_bytes / 1e9:.1f} GB: capacity 8 fills every "
          f"expert), {weight_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms for every "
          f"weight but the embedding; moe_dropped at prefill "
          f"{dropped_fraction(cfg.moe, routes_k.calls[:n_layers]):.6f}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"[{tag}] launch counters {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"{cfg.name}: the serving path did not go through the kernels: "
             f"{launches}")

    with RouteRecorder() as routes_t:
        run_t = greedy_generate(steps("torch"), params, prompt, gen_len,
                                cfg.vocab_size, feed=run_k.tokens)
    if {"flash_fwd": kfwd.launches, "flash_decode": kdecode.launches} != want:
        fail("impl='torch' launched a CUDA kernel")
    # a row's tokens routed otherwise at some step taint it from that step on
    # (its cache carries them)
    flips = decisions = 0
    tainted, where = [gen_len] * batch, []
    for c, (a, b) in enumerate(zip(routes_t.calls, routes_k.calls)):
        step, layer = divmod(c, n_layers)
        f, changed = route_diff(cfg.moe, a, b)
        flips += f
        decisions += a.numel()
        per_row = prompt_len if step == 0 else 1
        for row in sorted({j // per_row for j in changed.nonzero()[:, 0].tolist()}):
            tainted[row] = min(tainted[row], step)
            where.append(f"row {row} step {step} layer {layer}")
    print(f"[{tag}] routing, torch vs kernel impl: {flips} of {decisions} "
          f"choices flipped ({flips / decisions:.2e}, tol {MOE_FLIP_TOL:.0e}); "
          f"tokens routed otherwise at: {', '.join(where[:16]) or 'none'}",
          flush=True)
    if flips > MOE_FLIP_TOL * decisions:
        fail(f"{cfg.name}: {flips} of {decisions} routing choices flipped")
    worst, held = 0.0, 0
    for step, (lk, lt) in enumerate(zip(run_k.logits, run_t.logits)):
        if lk.shape != (batch, cfg.vocab_size) or \
                not bool(torch.isfinite(lk).all()):
            fail(f"{cfg.name} step {step}: logits of shape {tuple(lk.shape)} "
                 f"or not finite")
        rows = [r for r in range(batch) if tainted[r] > step]
        held += len(rows)
        if rows:
            rel = _maxerr(lk[rows], lt[rows]) / float(lt.abs().max())
            worst = max(worst, rel)
            if rel > LOGIT_REL_TOL:
                fail(f"{cfg.name} step {step}: kernel vs torch logits of rows "
                     f"{rows} differ by {rel:.3e} of max|logit|")
    match = float((run_k.tokens == run_t.tokens).float().mean())
    print(f"[{tag}] impl=torch (fed the kernel run's tokens): prefill "
          f"{run_t.prefill_s * 1e3:.1f} ms; decode {run_t.decode_s * 1e3:.1f} ms")
    print(f"[{tag}] kernel vs torch logits over prefill + {gen_len - 1} steps, "
          f"{held} of {batch * gen_len} (row, step) pairs routed alike: max |d| "
          f"/ max|logit| {worst:.3e} (tol {LOGIT_REL_TOL:.0e}); greedy token "
          f"match {match:.4f}", flush=True)
    # the kernel run's prefill above was the first on the card at these
    # shapes; once more, warm, then decode steps with and without the MoE
    # metrics, timed before the one under the profiler
    arts = steps("kernel")
    caches = arts.cache_init_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, caches = arts.prefill_fn(params, prompt, caches)
    torch.cuda.synchronize()
    print(f"[{tag}] impl=kernel prefill again, warm: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    _moe_metrics_share(torch, lambda: arts.decode_fn(
        params, run_k.tokens[:, 0], caches, prompt_len), tag)
    profile_step(torch, lambda: float(arts.decode_fn(
        params, run_k.tokens[:, 0], caches, prompt_len)[0].abs().max()),
        f"[{tag}] decode", "max|logit|")
    return launches


def _moe_metrics_share(torch, step, tag, calls=5, turns=3) -> None:
    """A serving step's time as it runs (``lm.forward`` with caches skips
    the MoE metrics, which the steps drop) and with ``moe.apply_moe`` made
    to compute them, in turns; prints the medians and the difference."""
    import statistics

    from repro_torch.models import moe

    apply_moe = moe.apply_moe
    times = {False: [], True: []}
    for on in (False, True) * turns:
        moe.apply_moe = (lambda *a, **kw: apply_moe(*a, **dict(kw, metrics=True))
                         ) if on else apply_moe
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                step()
            torch.cuda.synchronize()
        finally:
            moe.apply_moe = apply_moe
        times[on].append((time.perf_counter() - t0) * 1e3 / calls)
    off, on = statistics.median(times[False]), statistics.median(times[True])
    print(f"[{tag}] decode step without / with the MoE metrics ({turns} turns "
          f"of {calls} steps, medians): {off:.3f} / {on:.3f} ms, the metrics "
          f"{on - off:.3f} ms ({(on - off) / on * 100:.1f} %)", flush=True)


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


def train_phase(torch, kfwd, kbwd, arch="granite_3_2b"):
    """An arch at full width through the port's training path
    (``TRAIN_SETUPS``): granite-3-2b (phase 5: batch 4 x 2048, AdamW with
    its master copy, then the SMOKE ``Trainer``), recurrentgemma-2b (phase
    5b: batch 1 x 3072, AdamW without it) or deepseek-moe-16b at 4 layers
    (phase 5c: batch 2 x 2048, AdamW without it; the torch pass of (a)
    routed as the kernel pass was, the flips counted; ``moe_aux`` and
    ``moe_dropped`` a step). Returns the launch counts of the
    ``make_train_step`` run."""
    import tempfile

    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx
    from repro_torch.models.moe_routes import RouteRecorder
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.runtime.steps import make_train_step, place_batch, step_seed
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    tag, n_batch, n_seq, leaves, master, n_layers = TRAIN_SETUPS[arch]
    cfg = dataclasses.replace(configs.get_config(arch),
                              dtype=torch.float32, dropout_rate=0.1, remat=True)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=n_layers)
    arts = make_train_step(cfg, opt=AdamWConfig(lr=1e-4, keep_master=master),
                           impl="kernel", total_steps=TRAIN_STEPS, warmup_steps=1,
                           torch_chunk=256, device="cuda")
    t0 = time.perf_counter()
    params, opt = arts.init_fn(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{tag} {cfg.name}: {cfg.num_layers} layers "
          f"({lm.block_kinds(cfg).count('attn')} attention), d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head dim {cfg.head_dim}, "
          f"window {cfg.attn_window}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f} B params f32 + AdamW m, v"
          f"{', master' if master else ''} (random, seed 0) in "
          f"{time.perf_counter() - t0:.1f} s; remat {cfg.remat}, dropout "
          f"{cfg.dropout_rate}; batch {n_batch} x {n_seq} tokens from make_batch",
          flush=True)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=n_seq,
                    global_batch=n_batch, seed=0)
    batch = place_batch(make_batch(dc, 0), "cuda")

    # (a) one loss-and-grad pass per impl on the same params and batch; an
    # MoE arch's torch pass routes as the kernel pass did, so the two differ
    # by the attention kernels' sums only (a flipped choice would move its
    # token's expert gradients far more)
    routes = {}

    def loss_and_grads(impl):
        ctx = Ctx(impl=impl, deterministic=False, seed=step_seed(0),
                  torch_chunk=256)
        kfwd.launches = kbwd.launches_bwd = 0
        t0 = time.perf_counter()
        with RouteRecorder(routes.get("kernel")) as rec:
            loss = lm.loss_fn(cfg, params, batch, ctx)[0]
            loss.backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        routes[impl] = rec.calls
        if rec.decisions:
            print(f"{tag} (a) impl={impl} routed as the kernel pass: {rec.flips} "
                  f"of {rec.decisions} choices would have flipped "
                  f"({rec.flips / rec.decisions:.2e}, tol {MOE_FLIP_TOL:.0e})")
            if rec.flips > MOE_FLIP_TOL * rec.decisions:
                fail(f"{arch} training pass: {rec.flips} routing choices flipped")
        counts = (kfwd.launches, kbwd.launches_bwd)
        named = dict(params.named_parameters())
        out = (float(loss.detach()),
               float(global_norm(p.grad for p in params.parameters())),
               {n: named[n].grad.clone() for n in leaves}, counts, dt)
        params.zero_grad(set_to_none=True)
        return out

    n = lm.block_kinds(cfg).count("attn")
    lk, gk, leaves_k, ck, dtk = loss_and_grads("kernel")
    print(f"{tag} (a) impl=kernel: loss {lk:.6f}, grad norm {gk:.6f}, "
          f"{dtk:.2f} s; launches flash_fwd / flash_bwd {ck} (expected "
          f"{(2 * n, n)}: forward plus remat recompute)", flush=True)
    if ck != (2 * n, n):
        fail(f"the training pass did not go through the kernels: {ck}")
    lt, gt, leaves_t, ct, dtt = loss_and_grads("torch")
    print(f"{tag} (a) impl=torch (chunk 256): loss {lt:.6f}, grad norm "
          f"{gt:.6f}, {dtt:.2f} s; launches {ct}", flush=True)
    if ct != (0, 0):
        fail("impl='torch' launched a CUDA kernel")
    checks = [("loss", abs(lk - lt) / abs(lt), TRAIN_TOL["loss"]),
              ("grad norm", abs(gk - gt) / gt, TRAIN_TOL["grad_norm"])]
    for name in leaves:
        a, b = leaves_k[name], leaves_t[name]
        checks.append((f"grad {name}", _maxerr(a, b) / float(b.abs().max()),
                       TRAIN_TOL["leaf"]))
    for what, err, tol in checks:
        print(f"{tag} (a) kernel vs torch {what}: {err:.3e} (tol {tol:.0e}) "
              f"{'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            fail(f"{arch} training pass kernel vs torch: {what} differs by {err:.3e}")
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
        moe_metrics = (f"moe_aux {float(m['moe_aux']):.6f}, moe_dropped "
                       f"{float(m['moe_dropped']):.6f}, " if "moe_aux" in m else "")
        print(f"{tag} (b) step {step}: loss {loss:.6f}, grad norm "
              f"{float(m['grad_norm']):.4f}, {moe_metrics}lr reported "
              f"{m['lr']:.2e} (the update applies AdamWConfig.lr, as the JAX "
              f"step does), {times[-1]:.3f} s", flush=True)
        if not math.isfinite(loss):
            fail(f"training step {step}: loss {loss}")
    counts = {"flash_fwd": kfwd.launches, "flash_bwd": kbwd.launches_bwd}
    want = {"flash_fwd": 2 * n * TRAIN_STEPS, "flash_bwd": n * TRAIN_STEPS}
    peak = torch.cuda.max_memory_allocated()
    warm = times[1:]
    tok_s = n_batch * n_seq * len(warm) / sum(warm)
    print(f"{tag} (b) {TRAIN_STEPS} steps of make_train_step(impl='kernel'): "
          f"step times {[round(t, 4) for t in times]} s; steps 1-{TRAIN_STEPS - 1} "
          f"mean {sum(warm) / len(warm):.4f} s = {tok_s:.1f} tokens/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"{tag} (b) launch counters {counts} (expected {want})", flush=True)
    if counts != want:
        fail(f"the {arch} training steps did not go through the kernels: {counts}")
    profile_step(torch, lambda: float(arts.step_fn(params, opt, place_batch(
        make_batch(dc, TRAIN_STEPS), "cuda"), TRAIN_STEPS)[2]["loss"]), tag)
    del params, opt, arts, batch
    torch.cuda.empty_cache()
    if arch != "granite_3_2b":
        return counts

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
        r0 = straight.run(4)
        t1 = trainer(f"{tmp}/b")
        t1.hooks["pre_step"] = lambda s: t1.request_preemption() if s == 1 else None
        r1 = t1.run(4)
        t2 = trainer(f"{tmp}/b")
        r2 = t2.run(4)
    resumed = [m["loss"] for m in t1.metrics_log + t2.metrics_log]
    ref_losses = [m["loss"] for m in straight.metrics_log]
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, ref_losses))
    # the reference pins train(N) == train(k) + resume + train(k..N) to 1e-6
    # in every parameter (tests/test_fault_tolerance.py); printed, not gated
    param_diff = max(_maxerr(a.detach(), b.detach()) for a, b in zip(
        r0["params"].parameters(), r2["params"].parameters()))
    ok = (r1["preempted"] and r1["stop_step"] == 2 and r2["stop_step"] == 4
          and len(resumed) == 4 and worst <= TRAIN_TOL["loss"])
    print(f"[train] (c) Trainer at SMOKE size on the card: preempted at step "
          f"{r1['stop_step']}, resumed to {r2['stop_step']}; losses {resumed} vs "
          f"straight {ref_losses}: max rel diff {worst:.3e}; max |param(straight) "
          f"- param(resumed)| {param_diff:.3e} (the reference's bound 1e-6) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the trainer's preempt / resume run went wrong")
    return counts


def profile_step(torch, step, tag="[train]", what="loss") -> None:
    """One more step (training, or a decode step) under ``torch.profiler``:
    device time by kernel group (the port's attention kernels, cuBLAS
    GEMMs, the rest) and the device's busy share of the step's wall time.
    ``step()`` returns a number of its output (``what``: the loss); the
    step's own errors and a non-finite number fail the run. A profiler that
    fails or records no device time is reported as not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:   # the profiler is a probe here, not a check
        print(f"{tag} profile: not measured ({type(e).__name__}: {e})")
        prof = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not math.isfinite(loss):
        fail(f"the profiled step: {what} {loss}")
    print(f"{tag} profiled step: {what} {loss:.6f}")
    if prof is None:
        return
    try:
        prof.stop()
        averages = prof.key_averages()
    except Exception as e:
        print(f"{tag} profile: not measured ({type(e).__name__}: {e})")
        return
    groups, names = {"attention kernels": 0.0, "GEMMs": 0.0, "other": 0.0}, []
    for e in averages:
        if e.device_type != DeviceType.CUDA:   # kernels only: ops would count twice
            continue
        us = e.self_device_time_total
        name = e.key
        g = ("attention kernels" if any(k in name for k in
                                        ("fwd_kernel", "bwd_kernel",
                                         "decode_kernel"))
             else "GEMMs" if "gemm" in name.lower() else "other")
        groups[g] += us / 1e6
        names.append((us / 1e6, name))
    busy = sum(groups.values())
    if busy == 0.0:
        print(f"{tag} profile: not measured (no device time recorded)")
        return
    parts = ", ".join(f"{g} {t:.4f} s ({100 * t / wall:.1f} %)" for g, t in groups.items())
    print(f"{tag} profile of one step (torch.profiler, wall {wall:.4f} s under "
          f"the profiler): device time {parts}; device busy {busy:.4f} s = "
          f"{100 * busy / wall:.1f} % of the step, idle {100 * (1 - busy / wall):.1f} %")
    for t, name in sorted(names, reverse=True)[:8]:
        print(f"{tag} profile top kernel: {t:.4f} s {name[:110]}")
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


def hybrid_bwd_times_phase(torch, kfwd, kbwd, train_launches):
    """Rows 2-3 at recurrentgemma-2b's training shape (B 1, 10/1 heads, S
    3072, D 256, causal, window 2048) in f32, as its path runs, and in
    bf16: the kernel (CUDA events around ``launch_bwd``), its plain version
    (f32), the whole backward of ``scaled_dot_product_attention`` with the
    window as a boolean mask in the same dtype, and the bound over the
    (q, k) pairs inside the window. Returns the row."""
    import torch.nn.functional as F

    from repro_torch.perf import fwd_times

    gen = torch.Generator(device="cuda").manual_seed(19)
    b, hq, hkv, s, d, w = HYBRID_BATCH, 10, 1, HYBRID_SEQ, 256, 2048
    flops = 10 * d * b * hq * fwd_times.causal_pairs(s, w)
    mask = fwd_times.sdpa_mask(s, w)
    row = {"name": "flash_bwd (recurrentgemma-2b training)", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
           "replaces": "src/repro/kernels/flash_bwd.py:98, "
                       "src/repro/kernels/flash_bwd.py:164",
           "launches": train_launches["flash_bwd"],
           "shape": f"B {b}, {hq}/{hkv} heads, S {s}, D {d}, causal, window {w}",
           "library_note": "sdpa backward (dq, dk, dv) with the window as a "
                           "boolean mask, GQA by enable_gqa"}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, dtype)
        do = _rand(torch, gen, (b, hq, s, d), dtype)
        o, lse = kfwd.flash_fwd(q, k, v, causal=True, window=w)
        delta = kbwd.row_delta(o, do)
        kw = dict(causal=True, window=w, scale=d ** -0.5)
        el = q.element_size()
        nbytes = (3 * el * b * hq * s * d + 4 * el * b * hkv * s * d
                  + 4 * 2 * b * hq * s)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                             enable_gqa=True)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), 5)
        del qg, kg, vg, out
        call = lambda: kbwd.launch_bwd(q, k, v, lse, do, delta, **kw)  # noqa: E731
        got, again = call(), call()
        bd = bounds(flops, nbytes, dn)
        part = {"ms": time_ms(torch, call, 10), "library_ms": lib_ms, **bd,
                "dq_rerun_max_abs_diff": _maxerr(got[0], again[0])}
        if dtype == torch.float32:
            plain = kbwd.flash_bwd_torch(q, k, v, lse, do, delta, **kw)
            part["max_abs_err"] = max(_maxerr(g, gp) for g, gp in zip(got, plain))
            part["plain_ms"] = time_ms(
                torch, lambda: kbwd.flash_bwd_torch(q, k, v, lse, do, delta, **kw),
                1, warmup=1)
            part["bound_ms_3xtf32"] = 3 * flops / PEAK_FLOPS["float32"] * 1e3
            row.update(part)
            del plain
        else:
            row.update({f"bf16_{key}": val for key, val in part.items()})
        print(f"[times] flash_bwd at recurrentgemma-2b's training shape ({row['shape']}, "
              f"{dn}): kernel {part['ms']:.4f} ms"
              + (f", plain {part['plain_ms']:.4f} ms" if "plain_ms" in part else "")
              + f", sdpa backward with the window as a mask {lib_ms:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}; {flops:.4e} flops, "
              f"{dn} tensor cores)"
              + (f", 3xTF32 {part['bound_ms_3xtf32']:.4f} ms" if "bound_ms_3xtf32" in part
                 else "")
              + f"; {flops / part['ms'] / 1e9:.1f} TFLOP/s; launches {row['launches']}; "
              f"max|dq(run 1) - dq(run 2)| {part['dq_rerun_max_abs_diff']:.3e}",
              flush=True)
        del q, k, v, do, o, lse, delta, got, again
    torch.cuda.empty_cache()
    return row


def fwd_times_phase(row) -> None:
    """The forward kernel's row gains ``times_by_case`` from
    ``perf/fwd_times.py`` (the kernel alone under ``torch.profiler``, events
    around calls, SDPA in the same dtype and with the same dropout rate, the
    bounds) at the prefill and training shapes in f32 and bf16 and at the
    training shape with dropout 0.1, and the 3xTF32 bounds of its f32
    shapes."""
    from repro_torch.kernels import _build
    from repro_torch.perf import fwd_times

    fn = fwd_times.library_fn(_build.build(["flash_fwd"])["flash_fwd"])
    res = fwd_times.measure({"kernel": fn}, [c for c in fwd_times.CASES
                                             if not c.startswith("hybrid")])
    row["bound_ms_3xtf32"] = res["prefill_f32"]["bound_ms_3xtf32"]
    row["train_shape_bound_ms_3xtf32"] = res["train_f32"]["bound_ms_3xtf32"]
    row["times_by_case"] = {}
    for case, r in res.items():
        row["times_by_case"][case] = {**r.pop("kernel"), **r}
        t = row["times_by_case"][case]
        print(f"[times] flash_fwd {case}: device {t['device_ms']:.5f} ms "
              f"({t['device_ms_method']}), events {t['ms']:.5f} ms, sdpa "
              f"{t['library_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']})" + (f", 3xTF32 {t['bound_ms_3xtf32']:.5f} ms"
                                      if "bound_ms_3xtf32" in t else ""), flush=True)


def paged_times_phase(torch, kdecode, paged_launches, errs):
    """The paged decode kernel at the engine's decode shape (B 8, 32/8
    heads, D 64, page 16, T 37, kv_len 528-576), at a 256-token chunk's
    shape (256 token rows reading one table up to positions 301-556) and at
    a verify launch's (8 slots of 5 token rows, a table a slot), f32,
    beside its plain version, SDPA on the contiguous equivalent (ragged
    lengths as a boolean mask; the page gather excluded) and its bound: the
    K/V rows the rows read (each distinct row once), q and o, the tables."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(77)
    f32 = torch.float32
    hq, hkv, d, ps, t = 32, 8, 64, 16, 37
    slot_len = torch.randint(528, 577, (8,), generator=gen, device="cuda",
                             dtype=torch.int32)
    shapes = {
        "decode": slot_len,
        "chunk": torch.arange(301, 557, device="cuda", dtype=torch.int32),
        # a verify step: each slot's current token and 4 drafts
        "verify": (slot_len[:, None] + torch.arange(
            1, 6, device="cuda", dtype=torch.int32)).view(-1),
    }
    out = {}
    for shape, kv_len in shapes.items():
        q, kp, vp, bt = _paged_case(torch, gen, kv_len, hq, hkv, d, ps, t, f32)
        if shape == "chunk":
            bt = bt[-1:].expand(kv_len.shape[0], t).contiguous()
        elif shape == "verify":      # a slot's 5 rows share its last row's table
            bt = bt[4::5].repeat_interleave(5, dim=0).contiguous()
        b = kv_len.shape[0]
        # the token rows of one batch row: a chunk's all, a verify slot's 5
        rt = {"decode": 1, "chunk": b, "verify": 5}[shape]
        o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, row_tokens=rt)
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
        iters = 20 if shape == "chunk" else 50
        out[shape] = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: kdecode.flash_paged_decode(
                q, kp, vp, bt, kv_len, row_tokens=rt), iters),
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
    for shape in ("chunk", "verify"):
        row.update({f"{shape}_shape_{k}": v for k, v in out[shape].items()})
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
        rt = b if shape == "chunk" else 1                    # one batch row's tokens
        call = lambda: kdecode.flash_paged_decode_partials(      # noqa: E731
            q, kl, vl, bt_l, kv_len, block_valid=valid, row_tokens=rt)
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


def hybrid_times_phase(torch, kfwd, kdecode, launches, paged_launches,
                       train_launches, errs):
    """Rows 1, 4 and 5 at recurrentgemma-2b's shapes (f32, 10/1 heads, D
    256, window 2048): its prefill attention (B 4, S 3072, causal), its
    contiguous decode over a full 2048-slot ring (B 4) and its paged decode
    (8 slots, kv_len 1040-3120, page 16, T 196) and 512-token chunk, each
    beside its plain version, SDPA with the window as a boolean mask (GQA
    expanded by ``enable_gqa``; the paged rows on the gathered cache, the
    gather excluded), its bound and its device time alone
    (``perf/fwd_times.py``, ``perf/decode_times.py``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.perf import decode_times, fwd_times

    gen = torch.Generator(device="cuda").manual_seed(18)
    f32 = torch.float32
    hq, hkv, d, w = 10, 1, 256, 2048
    src = "src/repro_torch/kernels/csrc/"
    worst = max(v for k, v in errs.items() if "/rg" in k or "_rg_" in k)
    print(f"[times] recurrentgemma-2b: worst kernel-vs-plain error over its "
          f"phase-3 cases {worst:.3e}")

    # row 1: the prefill attention of one layer
    b, s = 4, 3072
    q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, f32)
    o, _ = kfwd.flash_fwd(q, k, v, causal=True, window=w)
    fwd_err = _maxerr(o, kfwd.flash_fwd_torch(q, k, v, causal=True, window=w)[0])
    mask = fwd_times.sdpa_mask(s, w)
    fn = fwd_times.library_fn(_build.build(["flash_fwd"])["flash_fwd"])
    dev = fwd_times.measure({"kernel": fn}, ("hybrid_prefill_f32",))
    fwd = {
        "name": "flash_fwd (recurrentgemma-2b prefill)", "route": "cuda",
        "source": src + "flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_fwd.py:46",
        "launches": launches["flash_fwd"] + paged_launches["flash_fwd"],
        "launches_by_path": {"hybrid_serve": launches["flash_fwd"],
                             "hybrid_paged_serve": paged_launches["flash_fwd"],
                             "hybrid_train": train_launches["flash_fwd"]},
        "max_abs_err": fwd_err,
        "ms": time_ms(torch, lambda: kfwd.flash_fwd(q, k, v, causal=True,
                                                    window=w), 10),
        "plain_ms": time_ms(torch, lambda: kfwd.flash_fwd_torch(
            q, k, v, causal=True, window=w), 2, warmup=1),
        **bounds(4 * b * hq * d * fwd_times.causal_pairs(s, w),
                 4 * (2 * b * hq * s * d + 2 * b * hkv * s * d + b * hq * s)),
        "bound_ms_3xtf32": dev["hybrid_prefill_f32"]["bound_ms_3xtf32"],
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), 10),
        "device_ms": dev["hybrid_prefill_f32"]["kernel"]["device_ms"],
        "device_ms_method": dev["hybrid_prefill_f32"]["kernel"]["device_ms_method"],
        "shape": "B 4, 10/1 heads, S 3072, D 256, causal, window 2048, f32",
    }
    del q, k, v, o

    # row 4: one decode step's attention over the full ring
    q = _rand(torch, gen, (b, hq, d), f32)
    kc, vc = (_rand(torch, gen, (b, hkv, w, d), f32) for _ in range(2))
    kv_len = torch.full((b,), w, dtype=torch.int32, device="cuda")
    o = kdecode.flash_decode(q, kc, vc, kv_len=kv_len)
    hyb = decode_times.measure_hybrid()
    dec = {
        "name": "flash_decode (recurrentgemma-2b decode)", "route": "cuda",
        "source": src + "flash_decode.cu",
        "replaces": "src/repro/kernels/decode.py:131",
        "launches": launches["flash_decode"],
        "max_abs_err": _maxerr(o, kdecode.flash_decode_torch(q, kc, vc,
                                                             kv_len=kv_len)),
        "ms": time_ms(torch, lambda: kdecode.flash_decode(q, kc, vc,
                                                          kv_len=kv_len), 50),
        "plain_ms": time_ms(torch, lambda: kdecode.flash_decode_torch(
            q, kc, vc, kv_len=kv_len), 10),
        **bounds(4 * b * hq * d * w,
                 4 * (2 * b * hq * d + 2 * b * hkv * w * d) + 4 * b),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, enable_gqa=True), 50),
        "shape": "B 4, 10/1 heads, a full ring of 2048 slots, D 256, f32",
    }
    del q, kc, vc, o

    # row 5: the engine's decode of 8 slots and a 512-token chunk
    shapes = decode_times.hybrid_shapes(gen)
    pag = {"name": "flash_paged_decode (recurrentgemma-2b)", "route": "cuda",
           "source": src + "flash_decode.cu",
           "replaces": "src/repro/kernels/decode.py:136",
           "launches": paged_launches["flash_paged_decode"],
           "launches_by_path": {"hybrid_paged_serve": paged_launches["by_mode"]},
           "shape": "8 slots, 10/1 heads, D 256, page 16, T 196, kv_len "
                    "1040-3120, window 2048, f32; chunk_shape_: 512 token "
                    "rows of one table, kv_len 2561-3072",
           "library_note": "sdpa on the gathered contiguous cache with the "
                           "window as a mask, gather excluded"}
    for shape, (kv_len, per_table, rt) in shapes.items():
        q, kp, vp, bt, _ = decode_times.paged_inputs(
            kv_len, rows_per_table=per_table, seed=5, geometry=decode_times.HYBRID)
        bt = bt[0]
        o = kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, window=w,
                                       row_tokens=rt)
        err = _maxerr(o, kdecode.flash_paged_decode_torch(
            q, kp, vp, bt, kv_len=kv_len, window=w))
        kc, vc = kdecode.gather_pages(kp, bt), kdecode.gather_pages(vp, bt)
        pos = torch.arange(kc.shape[2], device="cuda")
        allowed = ((pos[None, :] < kv_len[:, None])
                   & (pos[None, :] > kv_len[:, None] - 1 - w))[:, None, None, :]
        r = {"max_abs_err": err,
             "ms": time_ms(torch, lambda: kdecode.flash_paged_decode(
                 q, kp, vp, bt, kv_len, window=w, row_tokens=rt), 30),
             "plain_ms": time_ms(torch, lambda: kdecode.flash_paged_decode_torch(
                 q, kp, vp, bt, kv_len=kv_len, window=w), 3, warmup=1),
             **bounds(4 * hq * d * int(kv_len.clamp(max=w).sum()),
                      decode_times.paged_bytes(kv_len, per_table,
                                               decode_times.HYBRID, w)),
             "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                 q[:, :, None], kc, vc, attn_mask=allowed, enable_gqa=True), 30),
             "device_ms": hyb["flash_paged_decode"][shape]["device_ms"],
             "device_ms_method": hyb["flash_paged_decode"][shape]["device_ms_method"],
             "host_us": hyb["flash_paged_decode"][shape]["host_us"]}
        pag.update(r if shape == "decode" else
                   {f"{shape}_shape_{key}": val for key, val in r.items()})
        del q, kp, vp, bt, kc, vc, o
    for key in ("device_ms", "device_ms_method", "host_us"):
        dec[key] = hyb["flash_decode"]["decode"][key]
    for row in (fwd, dec, pag):
        print(f"[times] {row['name']}: kernel {row['ms']:.5f} ms (device "
              f"{row['device_ms']:.5f} ms, {row['device_ms_method']}), plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.5f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}); launches "
              f"{row['launches']}; max|kernel - plain| {row['max_abs_err']:.3e}",
              flush=True)
    print(f"[times] flash_paged_decode (recurrentgemma-2b) at the 512-token "
          f"chunk: kernel {pag['chunk_shape_ms']:.5f} ms (device "
          f"{pag['chunk_shape_device_ms']:.5f}), plain "
          f"{pag['chunk_shape_plain_ms']:.4f} ms, sdpa "
          f"{pag['chunk_shape_library_ms']:.5f} ms, bound "
          f"{pag['chunk_shape_bound_ms']:.5f} ms", flush=True)
    torch.cuda.empty_cache()
    return [fwd, dec, pag]


def moe_times_phase(torch, kfwd, kbwd, kdecode, serve, train):
    """Phase 6 at deepseek-moe-16b's attention geometry (16/16 heads, D 128,
    a GQA group of 1), f32 as its paths run and bf16, each kernel beside its
    plain version (f32 for the backward), one PyTorch library call and its
    bound at the dtype's tensor-core peak: row 1 at prefill (B 4, S 512,
    causal; ``dbrx_shape_``: dbrx-132b's B 2, 48/8 heads, S 256) and at
    training (B 2, S 2048, causal, dropout 0.1), rows 2-3 at training, row
    4 at decode (B 4, 528 of 544 slots; ``dbrx_shape_``: B 2, 264 of 272)
    and row 5 at the paged engine's decode (8 slots, page 16, T 37, kv_len
    128-576). Every kernel is held to its plain version on the inputs it
    is timed on (``TOL``, the backward ``BWD_TOL``), as in phase 3.
    Returns the five rows."""
    import torch.nn.functional as F

    from repro_torch.perf import decode_times

    gen = torch.Generator(device="cuda").manual_seed(20)
    hq, hkv, d = 16, 16, 128
    src = "src/repro_torch/kernels/csrc/"
    dtypes = ((torch.float32, ""), (torch.bfloat16, "bf16_"))

    def hold(what, dtype, err, tol):
        if not err <= tol:
            fail(f"{what} {str(dtype).split('.')[-1]} at the MoE shape: "
                 f"{err:.3e} from its plain version (tol {tol:.1e})")

    def fwd_case(b, hq, hkv, s, dtype, dropout=0.0, plain=True):
        q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, dtype)
        kw = dict(causal=True, dropout_rate=dropout, dropout_seed=3)
        el = q.element_size()
        r = {"ms": time_ms(torch, lambda: kfwd.flash_fwd(q, k, v, **kw), 10),
             **bounds(4 * b * hq * d * (s * (s + 1) // 2),
                      el * (2 * b * hq * s * d + 2 * b * hkv * s * d)
                      + 4 * b * hq * s, str(dtype).split(".")[-1]),
             "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, dropout_p=dropout, enable_gqa=True), 10)}
        if plain:
            r["max_abs_err"] = _maxerr(kfwd.flash_fwd(q, k, v, **kw)[0],
                                       kfwd.flash_fwd_torch(q, k, v, **kw)[0])
            hold(f"flash_fwd B {b}, {hq}/{hkv} heads, S {s}", dtype,
                 r["max_abs_err"], TOL[str(dtype).split(".")[-1]])
            r["plain_ms"] = time_ms(torch, lambda: kfwd.flash_fwd_torch(
                q, k, v, **kw), 2, warmup=1)
        return r

    def bwd_case(b, s, dtype, dropout):
        q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, dtype)
        do = _rand(torch, gen, (b, hq, s, d), dtype)
        kw = dict(causal=True, dropout_rate=dropout, dropout_seed=3)
        o, lse = kfwd.flash_fwd(q, k, v, **kw)
        delta = kbwd.row_delta(o, do)
        el = q.element_size()
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             dropout_p=dropout)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), 10)
        call = lambda: kbwd.launch_bwd(q, k, v, lse, do, delta,  # noqa: E731
                                       scale=d ** -0.5, **kw)
        got, again = call(), call()
        flops = 10 * d * b * hq * (s * (s + 1) // 2)
        r = {"ms": time_ms(torch, call, 10), "library_ms": lib_ms,
             **bounds(flops, el * (3 * b * hq * s * d + 4 * b * hkv * s * d)
                      + 4 * 2 * b * hq * s, str(dtype).split(".")[-1]),
             "dq_rerun_max_abs_diff": _maxerr(got[0], again[0])}
        plain = kbwd.flash_bwd_torch(q, k, v, lse, do, delta, scale=d ** -0.5,
                                     **kw)
        r["max_abs_err"] = max(_maxerr(g, gp) for g, gp in zip(got, plain))
        hold("flash_bwd, relative to max(1, max|plain|),", dtype,
             max(_maxerr(g, gp) / max(1.0, float(gp.float().abs().max()))
                 for g, gp in zip(got, plain)),
             BWD_TOL[str(dtype).split(".")[-1]])
        del plain
        if dtype == torch.float32:
            r["plain_ms"] = time_ms(torch, lambda: kbwd.flash_bwd_torch(
                q, k, v, lse, do, delta, scale=d ** -0.5, **kw), 2, warmup=1)
            r["bound_ms_3xtf32"] = 3 * flops / PEAK_FLOPS["float32"] * 1e3
        return r

    def decode_case(b, hq, hkv, cap, n, dtype):
        q = _rand(torch, gen, (b, hq, d), dtype)
        kc, vc = (_rand(torch, gen, (b, hkv, cap, d), dtype) for _ in range(2))
        kv_len = torch.full((b,), n, dtype=torch.int32, device="cuda")
        el = q.element_size()
        ks, vs = kc[:, :, :n], vc[:, :, :n]
        err = _maxerr(kdecode.flash_decode(q, kc, vc, kv_len=kv_len),
                      kdecode.flash_decode_torch(q, kc, vc, kv_len=kv_len))
        hold(f"flash_decode B {b}, {hq}/{hkv} heads, {n} of {cap} slots", dtype,
             err, TOL[str(dtype).split(".")[-1]])
        return {"max_abs_err": err,
                "ms": time_ms(torch, lambda: kdecode.flash_decode(
                    q, kc, vc, kv_len=kv_len), 50),
                "plain_ms": time_ms(torch, lambda: kdecode.flash_decode_torch(
                    q, kc, vc, kv_len=kv_len), 10),
                **bounds(4 * b * hq * d * n,
                         el * (2 * b * hq * d + 2 * b * hkv * n * d) + 4 * b,
                         str(dtype).split(".")[-1]),
                "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q[:, :, None], ks, vs, enable_gqa=True), 50)}

    def paged_case(dtype):
        geometry = (hq, hkv, d, 16, 37)
        kv_len = torch.randint(128, 577, (8,), generator=gen, device="cuda",
                               dtype=torch.int32)
        q, kp, vp, bt, _ = decode_times.paged_inputs(kv_len, seed=5,
                                                     geometry=geometry)
        q, kp, vp, bt = q.to(dtype), kp.to(dtype), vp.to(dtype), bt[0]
        kc, vc = kdecode.gather_pages(kp, bt), kdecode.gather_pages(vp, bt)
        allowed = (torch.arange(kc.shape[2], device="cuda")[None, :]
                   < kv_len[:, None])[:, None, None, :]
        el = q.element_size()
        nbytes = (el * (2 * hkv * d * int(kv_len.sum()) + 2 * 8 * hq * d)
                  + 4 * 8 * (37 + 1))
        err = _maxerr(kdecode.flash_paged_decode(q, kp, vp, bt, kv_len, row_tokens=1),
                      kdecode.flash_paged_decode_torch(q, kp, vp, bt, kv_len=kv_len))
        hold("flash_paged_decode", dtype, err, TOL[str(dtype).split(".")[-1]])
        return {"max_abs_err": err,
                "ms": time_ms(torch, lambda: kdecode.flash_paged_decode(
                    q, kp, vp, bt, kv_len, row_tokens=1), 50),
                "plain_ms": time_ms(torch, lambda: kdecode.flash_paged_decode_torch(
                    q, kp, vp, bt, kv_len=kv_len), 5, warmup=1),
                **bounds(4 * hq * d * int(kv_len.sum()), nbytes,
                         str(dtype).split(".")[-1]),
                "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kc, vc, attn_mask=allowed, enable_gqa=True), 50)}

    fwd_src = {"route": "cuda", "source": src + "flash_fwd.cu",
               "replaces": "src/repro/kernels/flash_fwd.py:46"}
    prefill = {"name": "flash_fwd (deepseek-moe-16b prefill)", **fwd_src,
               "launches": (serve["serve"]["flash_fwd"] + serve["paged"]["flash_fwd"]
                            + serve["dbrx"]["flash_fwd"]),
               "launches_by_path": {"moe_serve": serve["serve"]["flash_fwd"],
                                    "moe_paged_serve": serve["paged"]["flash_fwd"],
                                    "dbrx_serve": serve["dbrx"]["flash_fwd"]},
               "shape": "B 4, 16/16 heads, S 512, D 128, causal; dbrx_shape_: "
                        "B 2, 48/8 heads, S 256, D 128, causal (f32)"}
    training = {"name": "flash_fwd (deepseek-moe-16b training)", **fwd_src,
                "launches": train["flash_fwd"],
                "launches_by_path": {"moe_train": train["flash_fwd"]},
                "shape": "B 2, 16/16 heads, S 2048, D 128, causal, dropout 0.1"}
    bwd = {"name": "flash_bwd (deepseek-moe-16b training)", "route": "cuda",
           "source": src + "flash_bwd.cu",
           "replaces": "src/repro/kernels/flash_bwd.py:98, "
                       "src/repro/kernels/flash_bwd.py:164",
           "launches": train["flash_bwd"],
           "shape": "B 2, 16/16 heads, S 2048, D 128, causal, dropout 0.1",
           "library_note": "sdpa backward (dq, dk, dv) with dropout_p 0.1"}
    dec = {"name": "flash_decode (deepseek-moe-16b decode)", "route": "cuda",
           "source": src + "flash_decode.cu",
           "replaces": "src/repro/kernels/decode.py:131",
           "launches": serve["serve"]["flash_decode"] + serve["dbrx"]["flash_decode"],
           "launches_by_path": {"moe_serve": serve["serve"]["flash_decode"],
                                "dbrx_serve": serve["dbrx"]["flash_decode"]},
           "shape": "B 4, 16/16 heads, 528 of 544 slots, D 128; dbrx_shape_: "
                    "B 2, 48/8 heads, 264 of 272 slots (f32)"}
    pag = {"name": "flash_paged_decode (deepseek-moe-16b)", "route": "cuda",
           "source": src + "flash_decode.cu",
           "replaces": "src/repro/kernels/decode.py:136",
           "launches": serve["paged"]["flash_paged_decode"],
           "launches_by_path": {"moe_paged_serve": serve["paged"]["by_mode"]},
           "shape": "8 slots, 16/16 heads, D 128, page 16, T 37, kv_len 128-576",
           "library_note": "sdpa on the gathered contiguous cache with kv_len "
                           "as a mask, gather excluded"}
    for dtype, pre in dtypes:
        for row, r in ((prefill, fwd_case(4, hq, hkv, 512, dtype)),
                       (training, fwd_case(2, hq, hkv, 2048, dtype, 0.1)),
                       (bwd, bwd_case(2, 2048, dtype, 0.1)),
                       (dec, decode_case(4, hq, hkv, 544, 528, dtype)),
                       (pag, paged_case(dtype))):
            row.update({pre + key: val for key, val in r.items()})
    prefill.update({"dbrx_shape_" + key: val for key, val in
                    fwd_case(2, 48, 8, 256, torch.float32).items()})
    dec.update({"dbrx_shape_" + key: val for key, val in
                decode_case(2, 48, 8, 272, 264, torch.float32).items()})
    for row in (prefill, training, bwd, dec, pag):
        for pre, dn in (("", "f32"), ("bf16_", "bf16")):
            print(f"[times] {row['name']} {dn}: kernel {row[pre + 'ms']:.5f} ms"
                  + (f", plain {row[pre + 'plain_ms']:.4f} ms"
                     if pre + "plain_ms" in row else "")
                  + f", library {row[pre + 'library_ms']:.5f} ms, bound "
                  f"{row[pre + 'bound_ms']:.5f} ms ({row[pre + 'bound_by']})"
                  + (f", max|kernel - plain| {row[pre + 'max_abs_err']:.3e}"
                     if pre + "max_abs_err" in row else "")
                  + f"; launches {row['launches']}", flush=True)
    for row in (prefill, dec):
        print(f"[times] {row['name']} at dbrx-132b's shape: kernel "
              f"{row['dbrx_shape_ms']:.5f} ms, plain {row['dbrx_shape_plain_ms']:.4f} "
              f"ms, library {row['dbrx_shape_library_ms']:.5f} ms, bound "
              f"{row['dbrx_shape_bound_ms']:.5f} ms", flush=True)
    torch.cuda.empty_cache()
    return [prefill, training, bwd, dec, pag]


def device_times_phase(rows) -> None:
    """Rows 4-6 gain the kernel's device time alone and the wrapper's host
    time (``perf/decode_times.py``): ``device_ms`` from ``torch.profiler``
    (or a CUDA graph) over launches rotating over cache copies whose bytes
    exceed the L2 (cold, as each layer of the engine finds its pages), and
    ``host_us`` a wrapper call; ``<shape>_shape_`` the same at the other
    shapes (chunk, decode with 32 and 64 slots, verify), and row 5 the
    bound of the shapes phase 6 does not time itself."""
    from repro_torch.perf import decode_times

    by_name = {row["name"]: row for row in rows}
    for name, shapes in decode_times.measure().items():
        for shape, r in shapes.items():
            prefix = "" if shape == "decode" else f"{shape}_shape_"
            for key in ("device_ms", "device_ms_method", "device_ms_copies",
                        "host_us"):
                by_name[name][prefix + key] = r[key]
            if "bound_ms" in r and prefix + "bound_ms" not in by_name[name]:
                by_name[name][prefix + "bound_ms"] = r["bound_ms"]
            print(f"[times] {name} at the {shape} shape: device "
                  f"{r['device_ms']:.5f} ms ({r['device_ms_method']}, cold L2: "
                  f"{r['device_ms_copies']} cache copies), host "
                  f"{r['host_us']:.2f} us a wrapper call"
                  + (f", bound {r['bound_ms']:.5f} ms" if "bound_ms" in r else ""),
                  flush=True)


if __name__ == "__main__":
    main()
