#!/usr/bin/env python3
"""Build and drive the PyTorch / CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device  — the card's name, count, and ``nvidia-smi`` name / power limit;
2. build   — nvcc builds both CUDA kernels from ``kernels/csrc`` in parallel
             and prints ptxas's registers / shared memory per instantiation;
3. kernels — each CUDA kernel against its plain-torch version on the same
             inputs, f32 and bf16, at granite-3-2b's prefill / decode shapes
             plus window, segments, dropout, ragged and head-dim-128 / GQA-5
             cases, and against the naive oracle on a small input;
4. serve   — the port's serving path (``launch/serve.py``:
             ``make_serve_steps`` + ``greedy_generate``) on granite-3-2b at
             full width and depth (40 layers, f32, random weights from a
             seed), batch 8, prompt 512, 32 generated tokens, once with
             ``impl="kernel"`` and once with ``impl="torch"`` fed the kernel
             run's tokens; the launch counters must read 40 ``flash_fwd`` and
             40 × 31 ``flash_decode`` launches;
5. times   — each kernel at the serving path's shapes beside its plain
             version, one PyTorch library call computing the same function
             (``scaled_dot_product_attention``, a yardstick the port never
             calls) and its bound, printed as one JSON line.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or outside a checkout, it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
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
    from repro_torch.kernels import flash_fwd as kfwd

    # ---------------- phase 2: build ----------------
    t0 = time.perf_counter()
    _build.build(_build.KERNELS)
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
          f"{time.perf_counter() - t0:.1f} s")
    for kname in _build.KERNELS:
        for line in _build.ptxas_report.get(kname, "(already built)").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {kname}: {line.split(':', 1)[-1].strip()}")
    sys.stdout.flush()

    # ---------------- phase 3: kernels vs plain versions ----------------
    errs = kernel_phase(torch, kfwd, kdecode)

    # ---------------- phase 4: the serving path ----------------
    launches = serve_phase(torch, kfwd, kdecode)

    # ---------------- phase 5: times ----------------
    rows = times_phase(torch, kfwd, kdecode, launches, errs)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


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


if __name__ == "__main__":
    main()
