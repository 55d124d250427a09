"""The decode template's times on the card, its device work apart from its
wrappers' host time.

For the three decode kernels (`flash_decode`, `flash_paged_decode`,
`flash_paged_decode_partials` on one shard of two) at the paged engine's
decode shape (B 8, 32/8 heads, D 64, page 16, T 37, kv_len 528-576; the
contiguous cache of 544 slots, 528 filled), and for the two paged ones
also at a 256-token chunk's shape (256 token rows over one table, kv_len
301-556, ``row_tokens`` 256), at decode with 32 and with 64 slots (each
row its own table) and at a verify launch's shape (8 slots of 5 token rows,
a table a slot, ``row_tokens`` 5), f32, it measures:

* ``ms`` — CUDA events around back-to-back wrapper calls on one input
  (warm L2): the wrapper's host time sets it when that is the longer;
* ``device_ms`` — the kernel alone: ``torch.profiler``'s device time of
  the ``decode_kernel`` launches (a CUDA graph of the same launches timed
  with events where the profiler records none), the calls rotating over
  copies of the cache (disjoint pages of one pool) whose bytes together
  exceed the 50 MB L2, so no launch finds its pages there, as no layer of
  the engine does; q, kv_len and the tables are read just before each
  launch (by a reduction the timing leaves out), as the engine's step has
  just written them;
* ``host_us`` — a host clock over many wrapper calls, no synchronise;
* ``bound_ms`` (the paged kernel) — the least time of the launch: its
  bytes or its flops at the card's peak rates, whichever is the longer.

``measure_hybrid`` times rows 4 and 5 at recurrentgemma-2b's geometry
(10/1 heads, D 256, window 2048, f32): the contiguous decode over a ring
of 2048 slots (B 4), the paged decode of 8 slots (kv_len 1040-3120, page
16, T 196) and a 512-token chunk over one table (kv_len 2561-3072).
``--hybrid`` prints those instead of the granite-3-2b cases.

Run from the root of a checkout on a machine with the card and nvcc::

    PYTHONPATH=src python3 -m repro_torch.perf.decode_times

To time another commit's kernels with the same cases, run this file by its
path with ``PYTHONPATH=<that tree>/src``; wrappers that predate the
``row_tokens`` hint are called without it.

It prints the card's ``nvidia-smi`` name and power limit, one line a case
and the cases as one JSON line. ``chip_smoke.py`` (phase 6) adds the same
fields to its kernel rows.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import time
from typing import Optional

import torch

from repro_torch.distributed.paged import _local_ids
from repro_torch.kernels import decode as kdecode
from repro_torch.perf import HBM_BYTES_PER_S, PEAK_FLOPS

HQ, HKV, D, PS, T = 32, 8, 64, 16, 37
L2_BYTES = 50e6
KERNEL = "decode_kernel"
#: the wrappers take the launch hint (not so before it existed)
HINT = "row_tokens" in inspect.signature(kdecode.flash_paged_decode).parameters


def _shapes(gen) -> dict:
    """The paged shapes: {name: (kv_len of each row, rows a table,
    row_tokens)}; row_tokens 1 is a decode launch, each row its own
    sequence."""
    def decode(b):
        return torch.randint(528, 577, (b,), generator=gen, device="cuda",
                             dtype=torch.int32)
    shapes = {"decode": (decode(8), 1, 1),
              "chunk": (torch.arange(301, 557, device="cuda", dtype=torch.int32),
                        256, 256),
              "decode_32": (decode(32), 1, 1),
              "decode_64": (decode(64), 1, 1)}
    verify = decode(8)[:, None] + torch.arange(5, device="cuda", dtype=torch.int32)
    shapes["verify"] = (verify.view(-1), 5, 5)
    return shapes


def _copies(read_bytes: float) -> int:
    """Copies whose read bytes together exceed the L2 by half again."""
    return max(2, int(1.5 * L2_BYTES / read_bytes) + 1)


def paged_inputs(kv_len, *, rows_per_table: int = 1, copies: int = 1,
                 seed: int = 0, gated: bool = False,
                 geometry=(HQ, HKV, D, PS, T)):
    """q [B, Hq, D] and a pool holding ``copies`` disjoint sets of tables,
    one for every ``rows_per_table`` consecutive rows. A table owns the
    pages its rows' longest kv_len reaches; other entries name the trash
    page 0, which holds 1e6.
    ``gated``: the pool is one shard of two, a random half of the entries
    foreign (remapped to the local trash page by ``_local_ids``); returns
    the tables and their ``valid`` masks, else the tables and ``None``.
    ``geometry``: (Hq, Hkv, D, page size, T)."""
    HQ, HKV, D, PS, T = geometry
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = kv_len.shape[0]
    n_tab = b // rows_per_table
    n_pages = 1 + copies * n_tab * T
    q = torch.randn((b, HQ, D), generator=gen, device="cuda")
    kp = torch.randn((HKV, n_pages, PS, D), generator=gen, device="cuda")
    vp = torch.randn((HKV, n_pages, PS, D), generator=gen, device="cuda")
    kp[:, 0], vp[:, 0] = 1e6, 1e6
    longest = kv_len.view(n_tab, rows_per_table).max(dim=1).values
    block = torch.arange(T, device="cuda")[None, :]
    owned = block < (longest[:, None] + PS - 1) // PS
    tables, valids = [], []
    for c in range(copies):
        perm = torch.randperm(n_tab * T, generator=gen, device="cuda")
        bt = (1 + c * n_tab * T + perm).view(n_tab, T)
        bt = torch.where(owned, bt, 0).to(torch.int32)
        valid = None
        if gated:   # global ids over two shards of n_pages: this is shard 0
            mine = torch.rand((n_tab, T), generator=gen, device="cuda") < 0.5
            bt_global = torch.where(mine | (bt == 0), bt, bt + n_pages)
            bt, valid = _local_ids(bt_global, n_pages, 0)
            valid = valid.repeat_interleave(rows_per_table, dim=0).contiguous()
        tables.append(bt.repeat_interleave(rows_per_table, dim=0).contiguous())
        valids.append(valid)
    return q, kp, vp, tables, valids


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of ``fn`` from CUDA events around ``iters`` back-to-back
    calls, after ``warmup`` calls."""
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


def host_us(fn, iters: int = 100, repeats: int = 7, warmup: int = 20) -> float:
    """Host microseconds a call: the median over ``repeats`` runs of a host
    clock around ``iters`` calls, no synchronise inside (the device runs
    behind; the host is shared and noisy)."""
    for _ in range(warmup):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t0) / iters * 1e6)
    torch.cuda.synchronize()
    return sorted(runs)[repeats // 2]


def device_ms(calls, reps: int = 200, kernel: Optional[str] = KERNEL):
    """``(ms, method)``: the mean device time of one launch of the kernel
    whose name holds ``kernel`` over ``reps`` calls rotating over ``calls``
    (one a cache copy; each may launch other kernels too), from
    ``torch.profiler``; from CUDA events around a CUDA graph of the same
    calls where the profiler records no launch (the other kernels then
    count). ``kernel`` None: every kernel a call launches, summed a call
    (a split launch's merge included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for c in calls:
        c()
    torch.cuda.synchronize()
    total, count = 0.0, 0
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                calls[i % len(calls)]()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and (kernel is None
                                                     or kernel in e.key):
                total += e.self_device_time_total
                count += e.count
    except RuntimeError as e:   # no CUPTI: the graph below
        print(f"[decode_times] profiler: {type(e).__name__}: {e}")
    if count:
        return total / (count if kernel else reps) / 1e3, "torch.profiler"
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        for i in range(reps):
            calls[i % len(calls)]()
    torch.cuda.current_stream().wait_stream(stream)
    return time_ms(graph.replay, 3, warmup=1) / reps, "cuda graph"


def warmed(call, *operands):
    """``call`` after a read of each small operand (q, kv_len, tables),
    which leaves them in L2 as the engine's step leaves them."""
    def run():
        for t in operands:
            if t is not None:
                t.max()
        return call()
    return run


def _case(calls, iters, operands):
    """The three times of one case: ``calls[0]`` on its own (warm), all of
    them rotating for the device time (the cache cold, ``operands[i]`` of
    call i read just before it)."""
    dev, how = device_ms([warmed(c, *ops) for c, ops in zip(calls, operands)])
    return {"ms": time_ms(calls[0], iters), "device_ms": dev,
            "device_ms_method": how, "device_ms_copies": len(calls),
            "host_us": host_us(calls[0])}


def paged_bytes(kv_len, rows_per_table: int, geometry=(HQ, HKV, D, PS, T),
                window=None) -> int:
    """The bytes a paged launch (f32) must move: each table's K/V rows that
    its rows read, inside kv_len and the window, once; q and o; the tables
    and kv_len."""
    HQ, HKV, D, PS, T = geometry
    b = kv_len.shape[0]
    kvl = kv_len.long().view(b // rows_per_table, rows_per_table)
    hi = kvl.max(dim=1).values
    lo = (kvl - window).clamp(min=0).min(dim=1).values if window else 0 * hi
    return 4 * (2 * HKV * D * int((hi - lo).sum()) + 2 * b * HQ * D + b * T + b)


def paged_bound_ms(kv_len, rows_per_table: int, geometry=(HQ, HKV, D, PS, T),
                   window=None) -> float:
    """The least time of a paged launch (f32): the larger of its bytes
    (:func:`paged_bytes`) at 3.35 TB/s and its flops (4 D a query head and
    key read) at the TF32 tensor-core peak, 495 TFLOP/s."""
    reads = kv_len.long() if window is None else kv_len.long().clamp(max=window)
    flops = 4 * geometry[0] * geometry[2] * int(reads.sum())
    return max(paged_bytes(kv_len, rows_per_table, geometry, window)
               / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]) * 1e3


#: recurrentgemma-2b's attention: (Hq, Hkv, D, page size, T), its window
HYBRID = (10, 1, 256, 16, 196)
HYBRID_WINDOW = 2048


def hybrid_shapes(gen) -> dict:
    """The hybrid's paged shapes, as ``_shapes``: the engine's decode of 8
    slots (prompts 1024-3072 and up to 48 new tokens) and a 512-token chunk
    row of one prompt at positions 2560-3071."""
    return {"decode": (torch.randint(1040, 3121, (8,), generator=gen,
                                     device="cuda", dtype=torch.int32), 1, 1),
            "chunk": (torch.arange(2561, 3073, device="cuda", dtype=torch.int32),
                      512, 512)}


def measure_hybrid() -> dict:
    """{row: {shape: {ms, device_ms, device_ms_method, device_ms_copies,
    host_us, bound_ms}}} for rows 4 and 5 at recurrentgemma-2b's geometry:
    the contiguous decode over a full 2048-slot ring (B 4) and the paged
    decode and chunk of :func:`hybrid_shapes` with the window."""
    hq, hkv, d, ps, t = HYBRID
    w = HYBRID_WINDOW
    gen = torch.Generator(device="cuda").manual_seed(98)
    out = {"flash_decode": {}, "flash_paged_decode": {}}
    b = 4
    read = 2 * 4 * b * hkv * w * d
    q = torch.randn((b, hq, d), generator=gen, device="cuda")
    caches = [(torch.randn((b, hkv, w, d), generator=gen, device="cuda"),
               torch.randn((b, hkv, w, d), generator=gen, device="cuda"))
              for _ in range(_copies(read))]
    kv_len = torch.full((b,), w, dtype=torch.int32, device="cuda")
    calls = [lambda k=k, v=v: kdecode.flash_decode(q, k, v, kv_len=kv_len)
             for k, v in caches]
    out["flash_decode"]["decode"] = {
        **_case(calls, 50, [(q, kv_len)] * len(calls)),
        "bound_ms": max((read + 4 * 2 * b * hq * d) / HBM_BYTES_PER_S,
                        4 * b * hq * d * w / PEAK_FLOPS["float32"]) * 1e3}
    del caches, calls
    for shape, (kv_len, per_table, row_tokens) in hybrid_shapes(gen).items():
        n_tab = kv_len.shape[0] // per_table
        q, kp, vp, tables, _ = paged_inputs(
            kv_len, rows_per_table=per_table,
            copies=_copies(2 * 4 * hkv * d * w * n_tab), seed=9, geometry=HYBRID)
        calls = [lambda bt=bt: kdecode.flash_paged_decode(
            q, kp, vp, bt, kv_len, window=w, row_tokens=row_tokens)
            for bt in tables]
        out["flash_paged_decode"][shape] = {
            **_case(calls, 50 if shape == "decode" else 20,
                    [(q, kv_len, bt) for bt in tables]),
            "bound_ms": paged_bound_ms(kv_len, per_table, HYBRID, w)}
        del q, kp, vp, tables, calls
    torch.cuda.empty_cache()
    return out


def measure() -> dict:
    """{row: {shape: {ms, device_ms, device_ms_method, device_ms_copies,
    host_us}}} for the three decode kernels (row 4 at the decode shape
    only: the contiguous cache has no chunk or verify)."""
    gen = torch.Generator(device="cuda").manual_seed(99)
    out = {"flash_decode": {}, "flash_paged_decode": {},
           "flash_paged_decode_partials": {}}
    # row 4: the contiguous decode step
    b, cap, n = 8, 544, 528
    copies = _copies(2 * 4 * b * HKV * n * D)
    q = torch.randn((b, HQ, D), generator=gen, device="cuda")
    caches = [(torch.randn((b, HKV, cap, D), generator=gen, device="cuda"),
               torch.randn((b, HKV, cap, D), generator=gen, device="cuda"))
              for _ in range(copies)]
    kv_len = torch.full((b,), n, dtype=torch.int32, device="cuda")
    calls = [lambda k=k, v=v: kdecode.flash_decode(q, k, v, kv_len=kv_len)
             for k, v in caches]
    out["flash_decode"]["decode"] = _case(calls, 50, [(q, kv_len)] * len(calls))
    del caches, calls
    for shape, (kv_len, per_table, row_tokens) in _shapes(gen).items():
        n_tab = kv_len.shape[0] // per_table
        read = 2 * 4 * HKV * D * PS * T * n_tab
        hint = {"row_tokens": row_tokens} if HINT else {}
        for gated in (False, True):
            copies = _copies(read / (2 if gated else 1))
            q, kp, vp, tables, valids = paged_inputs(
                kv_len, rows_per_table=per_table, copies=copies, seed=7 + gated,
                gated=gated)
            if gated:
                calls = [lambda bt=bt, va=va: kdecode.flash_paged_decode_partials(
                    q, kp, vp, bt, kv_len, block_valid=va, **hint)
                    for bt, va in zip(tables, valids)]
            else:
                calls = [lambda bt=bt: kdecode.flash_paged_decode(
                    q, kp, vp, bt, kv_len, **hint) for bt in tables]
            name = "flash_paged_decode_partials" if gated else "flash_paged_decode"
            out[name][shape] = _case(calls, 50 if shape == "decode" else 20,
                                     [(q, kv_len, bt, va)
                                      for bt, va in zip(tables, valids)])
            if not gated:
                out[name][shape]["bound_ms"] = paged_bound_ms(kv_len, per_table)
            del q, kp, vp, tables, valids, calls
    torch.cuda.empty_cache()
    return out


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hybrid", action="store_true",
                    help="recurrentgemma-2b's shapes (measure_hybrid)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_times needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    res = measure_hybrid() if args.hybrid else measure()
    for name, shapes in res.items():
        for shape, r in shapes.items():
            print(f"[decode_times] {name} {shape}: device {r['device_ms']:.5f} ms "
                  f"({r['device_ms_method']}, cold L2, {r['device_ms_copies']} "
                  f"copies), events around calls {r['ms']:.5f} ms (warm), host "
                  f"{r['host_us']:.2f} us a call", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
