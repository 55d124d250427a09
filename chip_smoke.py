#!/usr/bin/env python3
"""Build and drive the PyTorch / CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device  — the card's name, count, and ``nvidia-smi`` name / power limit;
2. build   — nvcc builds the three CUDA kernel libraries from
             ``kernels/csrc`` in parallel and prints ptxas's registers and
             spills per instantiation (the f32 D=64 backward kernels, the
             training path's, must not spill);
3. kernels — each CUDA kernel against its plain-torch version on the same
             inputs, f32 and bf16: the forward and decode at granite-3-2b's
             prefill / decode shapes, the two backward kernels at its
             training shape (B 4, 32/8 heads, S 2048, D 64, causal), plus
             window, segments, dropout, ragged, q-suffix, head-dim-128 /
             GQA-5 and bf16-ACC cases, and against the naive oracle (autograd
             of it for the backward) on a small input;
4. serve   — the port's serving path (``launch/serve.py``:
             ``make_serve_steps`` + ``greedy_generate``) on granite-3-2b at
             full width and depth (40 layers, f32, random weights from a
             seed), batch 8, prompt 512, 32 generated tokens, once with
             ``impl="kernel"`` and once with ``impl="torch"`` fed the kernel
             run's tokens; the launch counters must read 40 ``flash_fwd`` and
             40 × 31 ``flash_decode`` launches;
5. train   — the port's training path on granite-3-2b at full width and
             depth (f32, remat, dropout 0.1, batch 4 × 2048 from
             ``make_batch``): (a) one loss-and-grad pass with
             ``impl="kernel"`` against one with ``impl="torch"`` on the same
             params and batch, the counters reading 80 / 40 / 40 launches of
             ``flash_fwd`` / ``dkv`` / ``dq`` (forward plus recompute) and 0
             for the torch impl; (b) 4 steps of ``make_train_step`` with the
             counters reset before and read after, then one step under
             ``torch.profiler`` (device time by kernel group, busy share);
             (c) the ``Trainer`` at SMOKE size: 2 steps, a preemption, a
             resume for 2 more;
6. times   — each kernel at its path's shapes beside its plain version, one
             PyTorch library call computing the same function
             (``scaled_dot_product_attention`` forward, or its backward for
             the two backward kernels: a yardstick the port never calls) and
             its bound, printed as one JSON line.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout, it exits non-zero before printing any result.
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
# 67 TFLOP/s float32 without tensor cores; 989 TFLOP/s bf16 on tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

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
# backward kernels vs plain version, relative to max(1, max|plain|): f32 the
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


def main() -> None:
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
    errs.update(bwd_kernel_phase(torch, kfwd, kbwd))

    # ---------------- phase 4: the serving path ----------------
    launches = serve_phase(torch, kfwd, kdecode)

    # ---------------- phase 5: the training path ----------------
    train_launches = train_phase(torch, kfwd, kbwd)

    # ---------------- phase 6: times ----------------
    rows = times_phase(torch, kfwd, kdecode, launches, errs)
    rows += bwd_times_phase(torch, kfwd, kbwd, train_launches, rows[0])
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


def build_report(_build) -> None:
    """ptxas's registers and spills per kernel instantiation; fails if an
    f32 D=64 backward kernel (the training path's) spills."""
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
                         f"D{m.group(3)}{', acc bf16' if m.group(4) == '1' else ''}>"
                         if m else line.split("'")[1][:60])
                continue
            if "spill" in line:
                spills = line.strip()
                n = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                              spills)
                if (entry in ("dkv_kernel<f32, D64>", "dq_kernel<f32, D64>")
                        and (n is None or n.groups() != ("0", "0"))):
                    fail(f"{kname} {entry} spills: {spills}")
                continue
            if "registers" in line:
                regs = line.split(":", 1)[-1].strip()
                print(f"[build] {kname} {entry}: {regs}; {spills}")
    sys.stdout.flush()


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


def bwd_kernel_phase(torch, kfwd, kbwd):
    """The two backward kernels against their plain version, f32 and bf16,
    at the training shape and the edge cases; then against autograd of the
    naive oracle. Returns {case: max |kernel - plain| / max(1, max|plain|)}."""
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
            if "segment_ids" in kw:
                pad = skv // 16
                if max(float(grads[0][:, :, -pad:].abs().max()),
                       float(grads[1][:, :, -pad:].abs().max()),
                       float(grads[2][:, :, -pad:].abs().max())) != 0.0:
                    fail("flash_bwd: padding tokens (segment id -1) get a gradient")
            errs[f"flash_bwd/{name}/{dn}"] = worst
            del q, k, v, do, o, lse, grads, plain

    # both backward kernels against autograd of the naive oracle, small f32
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
        fail("the backward kernels disagree with autograd of the naive oracle")
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
        kfwd.launches = kbwd.launches_dkv = kbwd.launches_dq = 0
        t0 = time.perf_counter()
        loss = lm.loss_fn(cfg, params, batch, ctx)[0]
        loss.backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = (kfwd.launches, kbwd.launches_dkv, kbwd.launches_dq)
        named = dict(params.named_parameters())
        out = (float(loss.detach()),
               float(global_norm(p.grad for p in params.parameters())),
               {n: named[n].grad.clone() for n in TRAIN_LEAVES}, counts, dt)
        params.zero_grad(set_to_none=True)
        return out

    n = cfg.num_layers
    lk, gk, leaves_k, ck, dtk = loss_and_grads("kernel")
    print(f"[train] (a) impl=kernel: loss {lk:.6f}, grad norm {gk:.6f}, "
          f"{dtk:.2f} s; launches flash_fwd / dkv / dq {ck} (expected "
          f"{(2 * n, n, n)}: forward plus remat recompute)", flush=True)
    if ck != (2 * n, n, n):
        fail(f"the training pass did not go through the kernels: {ck}")
    lt, gt, leaves_t, ct, dtt = loss_and_grads("torch")
    print(f"[train] (a) impl=torch (chunk 256): loss {lt:.6f}, grad norm "
          f"{gt:.6f}, {dtt:.2f} s; launches {ct}", flush=True)
    if ct != (0, 0, 0):
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
    kfwd.launches = kbwd.launches_dkv = kbwd.launches_dq = 0
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
    counts = {"flash_fwd": kfwd.launches, "flash_bwd_dkv": kbwd.launches_dkv,
              "flash_bwd_dq": kbwd.launches_dq}
    want = {"flash_fwd": 2 * n * TRAIN_STEPS, "flash_bwd_dkv": n * TRAIN_STEPS,
            "flash_bwd_dq": n * TRAIN_STEPS}
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
                                        ("fwd_kernel", "dkv_kernel", "dq_kernel"))
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
    peak = PEAK_FLOPS["float32"]
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
        "bound_ms": max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / peak > nbytes / HBM_BYTES_PER_S else "bytes",
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
        "bound_ms": max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": "operations" if flops / peak > nbytes / HBM_BYTES_PER_S else "bytes",
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None], ks, vs, enable_gqa=True), 50),
    }
    for row in (fwd, dec):
        print(f"[times] {row['name']}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; f32 peak "
              f"{peak / 1e12:.0f} TFLOP/s without tensor cores, "
              f"{HBM_BYTES_PER_S / 1e12} TB/s; the bf16 peak, "
              f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s, applies to bf16 "
              f"runs, and the serving path runs f32)")
    worst = max(errs.values())
    print(f"[times] worst kernel-vs-plain error over the kernel phase {worst:.3e}")
    return [fwd, dec]


def bwd_times_phase(torch, kfwd, kbwd, train_launches, fwd_row):
    """The backward kernels, each launched alone, at the training path's
    attention shape (B 4, 32/8 heads, S 2048, D 64, causal, f32) beside their
    plain versions, the backward of ``scaled_dot_product_attention`` and
    their bounds; adds the forward kernel's time at that shape and its
    training launches to ``fwd_row``."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(7)
    f32 = torch.float32
    peak = PEAK_FLOPS["float32"]
    b, hq, hkv, s, d = TRAIN_BATCH, 32, 8, TRAIN_SEQ, 64
    q, k, v = _fwd_inputs(torch, gen, b, hq, hkv, s, s, d, f32)
    do = _rand(torch, gen, (b, hq, s, d), f32)
    o, lse = kfwd.flash_fwd(q, k, v, causal=True)
    delta = kbwd.row_delta(o, do)
    kw = dict(causal=True, window=None, scale=d ** -0.5, dropout_rate=0.0,
              dropout_seed=0, segment_ids=None, acc_dtype=f32)
    pairs = s * (s + 1) // 2                  # causal (q, k) pairs per head
    rows_bytes = 4 * 2 * b * hq * s           # lse and delta
    q_bytes, kv_bytes = 4 * b * hq * s * d, 4 * b * hkv * s * d

    # the forward at the training shape (the serving row keeps its shape)
    o_ref, _ = kfwd.flash_fwd_torch(q, k, v, causal=True)
    flops = 4 * b * hq * d * pairs
    nbytes = 2 * q_bytes + 2 * kv_bytes + rows_bytes // 2
    fwd_row.update({
        "launches_by_path": {"serve": fwd_row["launches"],
                             "train": train_launches["flash_fwd"]},
        "train_shape_max_abs_err": _maxerr(o, o_ref),
        "train_shape_ms": time_ms(torch, lambda: kfwd.flash_fwd(q, k, v, causal=True), 10),
        "train_shape_plain_ms": time_ms(
            torch, lambda: kfwd.flash_fwd_torch(q, k, v, causal=True), 2, warmup=1),
        "train_shape_bound_ms": max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
        "train_shape_library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 10),
    })
    del o_ref

    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), 10)
    del qg, kg, vg, out

    rows = []
    for name, launch, plain_fn, line, fpp, nbytes in (
            ("flash_bwd_dkv", kbwd.launch_dkv, kbwd.flash_bwd_dkv_torch, 98, 8 * d,
             2 * q_bytes + 4 * kv_bytes + rows_bytes),
            ("flash_bwd_dq", kbwd.launch_dq, kbwd.flash_bwd_dq_torch, 164, 6 * d,
             3 * q_bytes + 2 * kv_bytes + rows_bytes)):
        got = launch(q, k, v, lse, do, delta, **kw)
        plain = plain_fn(q, k, v, lse, do, delta, **kw)
        if name == "flash_bwd_dq":
            got, plain = (got,), (plain,)
        err = max(_maxerr(g, gp) for g, gp in zip(got, plain))
        flops = fpp * b * hq * pairs
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_bwd.cu",
            "replaces": f"src/repro/kernels/flash_bwd.py:{line}",
            "launches": train_launches[name], "max_abs_err": err,
            "ms": time_ms(torch, lambda: launch(q, k, v, lse, do, delta, **kw), 10),
            "plain_ms": time_ms(torch, lambda: plain_fn(q, k, v, lse, do, delta, **kw),
                                2, warmup=1),
            "bound_ms": max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
            "bound_by": "operations" if flops / peak > nbytes / HBM_BYTES_PER_S else "bytes",
            "library_ms": lib_ms,
        })
        del got, plain
    print(f"[times] flash_fwd at the training shape (B {b}, {hq}/{hkv} heads, "
          f"S {s}, D {d}, causal, f32): kernel {fwd_row['train_shape_ms']:.4f} ms, "
          f"plain {fwd_row['train_shape_plain_ms']:.4f} ms, sdpa "
          f"{fwd_row['train_shape_library_ms']:.4f} ms, bound "
          f"{fwd_row['train_shape_bound_ms']:.4f} ms")
    for row in rows:
        print(f"[times] {row['name']} at the training shape: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
              f"backward (dq, dk and dv together) {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; f32 peak "
              f"{peak / 1e12:.0f} TFLOP/s without tensor cores)")
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
