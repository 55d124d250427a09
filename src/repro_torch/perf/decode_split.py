"""The decode kernels' device time at each split count, on the card: the
sweep that refines ``perf/autotune.py``'s plans and the data its H100
constants are fitted to.

For each decode geometry the serving paths launch (:data:`GEOMETRIES`,
every row at the cache's full reach, as the engine plans): granite-3-2b's
contiguous decode (B 8, 544 slots) and paged decode (8 slots, page 16, 37
pages a row); recurrentgemma-2b's contiguous decode over its 2048-slot ring
(B 4), paged decode (8 slots, page 16, 196 pages a row, window 2048) and the
gated decode of one shard of two (``flash_paged_decode_partials``, a
random half of the pages owned); deepseek-moe-16b's paged decode (16/16
heads, D 128) and dbrx-132b's contiguous decode (48/8 heads, 272 slots).

:func:`sweep` returns the ``sweep=`` callable of ``autotune.plan_decode``
for one geometry: ``(num_splits, block_kv) -> seconds``, the device time of
one wrapper call at that split count (the decode kernel and, for more than
one split, the merge's kernels), by ``decode_times.device_ms``: the calls
rotate over copies of the cache whose bytes exceed the 50 MB L2.

Run from the root of a checkout on a machine with the card and nvcc::

    PYTHONPATH=src python3 -m repro_torch.perf.decode_split [--fit]

It prints the card's ``nvidia-smi`` name and power limit, the clusters of
1, 2, 4 and 8 blocks the one-row decode kernel holds at once at every head
dim it takes, f32 and bf16 (:func:`occupancy`) and the ``resident`` table
they make (:func:`resident_table`), then for each geometry in f32 the
plan, the measured time of every candidate split and the best one.
``--fit`` fits ``stream_bw``, ``tile_s``, ``c0`` and ``c1`` of
``autotune.H100`` to those f32 times (least squares on relative error) and
prints the f32 plans under the fit (in sample). Last the same geometries
in bf16, whose times the fit never sees, under the fitted record (or the
module's); the whole as one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import decode as kdecode
from repro_torch.perf import autotune
from repro_torch.perf import decode_times as dt

DS = autotune.DecodeShape


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A serving path's decode launch: its planner shape, its heads, and the
    kernel it goes through ("contig", "paged" or "gated": one shard of
    two, over the whole table of ``pages · page_size`` rows)."""
    shape: autotune.DecodeShape
    hq: int
    kernel: str
    pages: int = 0            # table width of a paged row
    window: int = 0


GEOMETRIES: Dict[str, Geometry] = {
    "granite_contig": Geometry(DS(8, 8, 4, 544, 64, 0, 4), 32, "contig"),
    "granite_paged": Geometry(DS(8, 8, 4, 592, 64, 16, 4), 32, "paged", 37),
    "rg_contig": Geometry(DS(4, 1, 10, 2048, 256, 0, 4), 10, "contig"),
    "rg_paged": Geometry(DS(8, 1, 10, 3136, 256, 16, 4, 2048), 10, "paged",
                         196, 2048),
    "rg_gated": Geometry(DS(8, 1, 10, 3136, 256, 16, 4, 2048, 2), 10, "gated",
                         196, 2048),
    "moe_paged": Geometry(DS(8, 16, 1, 592, 128, 16, 4), 16, "paged", 37),
    "dbrx_contig": Geometry(DS(2, 8, 6, 272, 128, 0, 4), 48, "contig"),
}


def _inputs(g: Geometry, copies: int, seed: int = 0,
            dtype=torch.float32) -> Tuple[Callable, Callable, int]:
    """``(kernel, plain, copies)`` of geometry ``g`` in ``dtype``:
    ``kernel(num_splits, i)`` calls the wrapper on cache copy ``i``,
    ``plain(num_splits, i)`` its plain version on the same inputs; both
    return the output (the gated decode: its f32 ``(acc, m, l)``)."""
    s = g.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if g.kernel == "contig":
        q = torch.randn((s.batch, g.hq, s.head_dim), generator=gen,
                        device="cuda").to(dtype)
        kv_len = torch.full((s.batch,), s.kv_len, dtype=torch.int32,
                            device="cuda")
        caches = [tuple(torch.randn((s.batch, s.hkv, s.kv_len, s.head_dim),
                                    generator=gen, device="cuda").to(dtype)
                        for _ in range(2)) for _ in range(copies)]

        def kernel(ns, i):
            return kdecode.flash_decode(q, *caches[i], kv_len=kv_len,
                                        num_splits=ns)

        def plain(ns, i):
            return kdecode.flash_decode_torch(q, *caches[i], kv_len=kv_len,
                                              num_splits=ns)
        return kernel, plain, copies
    reach = g.pages * s.page_size
    kv_len = torch.full((s.batch,), reach, dtype=torch.int32, device="cuda")
    gated = g.kernel == "gated"
    q, kp, vp, tables, valids = dt.paged_inputs(
        kv_len, copies=copies, seed=seed, gated=gated,
        geometry=(g.hq, s.hkv, s.head_dim, s.page_size, g.pages))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    window = g.window or None
    if gated:
        def kernel(ns, i):
            return kdecode.flash_paged_decode_partials(
                q, kp, vp, tables[i], kv_len, block_valid=valids[i],
                window=window, num_splits=ns)

        def plain(ns, i):
            return kdecode.flash_paged_decode_partials_torch(
                q, kp, vp, tables[i], kv_len=kv_len, block_valid=valids[i],
                window=window, num_splits=ns)
        return kernel, plain, copies

    def kernel(ns, i):
        return kdecode.flash_paged_decode(q, kp, vp, tables[i], kv_len,
                                          window=window, num_splits=ns)

    def plain(ns, i):
        return kdecode.flash_paged_decode_torch(
            q, kp, vp, tables[i], kv_len=kv_len, window=window, num_splits=ns)
    return kernel, plain, copies


def _read_bytes(g: Geometry, dtype_bytes: int) -> float:
    """K and V bytes one call of ``g`` reads (a gated shard: half)."""
    s = g.shape
    reach = g.pages * s.page_size if g.pages else s.kv_len
    rows = min(reach, g.window or reach)
    return 2 * dtype_bytes * s.batch * s.hkv * rows * s.head_dim / s.shards


def sweep(name: str, dtype=torch.float32) -> Callable[[int, int], float]:
    """``autotune.plan_decode``'s ``sweep=`` for geometry ``name``: the
    device seconds of one wrapper call at ``num_splits`` (cold L2)."""
    g = GEOMETRIES[name]
    copies = dt._copies(_read_bytes(g, torch.tensor([], dtype=dtype)
                                    .element_size()))

    def timed(num_splits: int, block_kv: int) -> float:
        kernel, _, n = _inputs(g, copies, dtype=dtype)
        ms, _ = dt.device_ms([lambda i=i: kernel(num_splits, i)
                              for i in range(n)], kernel=None)
        del kernel
        torch.cuda.empty_cache()
        return ms * 1e-3

    return timed


def check(name: str, splits) -> Dict[int, Tuple[float, float]]:
    """``{num_splits: (max |o - plain|, max |lse - plain|)}`` of geometry
    ``name`` in f32 on one cache copy, at each of ``splits``: the output and
    the log-sum-exp of the gated decode's state (``acc / l``, ``m + log l``);
    the others' output, their lse 0."""
    kernel, plain, _ = _inputs(GEOMETRIES[name], 1, seed=1)
    out = {}
    for ns in splits:
        got, want = kernel(ns, 0), plain(ns, 0)
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            (o, lse), (o_ref, lse_ref) = ((acc / l[..., None], m + l.log())
                                          for acc, m, l in (got, want))
            out[ns] = (float((o - o_ref).abs().max()),
                       float((lse - lse_ref).abs().max()))
        else:
            out[ns] = (float((got.float() - want.float()).abs().max()), 0.0)
    del kernel, plain
    torch.cuda.empty_cache()
    return out


#: (rows of one kv head, cache rows) of a decode launch whose cluster is
#: 1, 2, 4 or 8 blocks on 132 SMs (``autotune.cluster_size``)
CLUSTER_LAUNCHES = {1: (264, 64), 2: (66, 128), 4: (33, 256), 8: (16, 512)}


def occupancy() -> Dict[str, Tuple[int, ...]]:
    """``{"D<d>/<bytes>/<cache>/G<g>": (clusters of 1, 2, 4, 8 blocks the
    card holds)}`` of the one-row decode kernel at every head dim it takes,
    f32 and bf16, contiguous and paged caches, one query head a kv head and
    the most the kernel takes: ``launch_geometry``'s resident clusters at
    :data:`CLUSTER_LAUNCHES`."""
    out = {}
    for d in kdecode.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            nbytes = torch.tensor([], dtype=dtype).element_size()
            for paged in (False, True):
                for group in sorted({1, kdecode.max_group(d)}):
                    counts = []
                    for c, (rows, skv) in CLUSTER_LAUNCHES.items():
                        geo = kdecode.launch_geometry(
                            rows, group, 1, skv, 1, head_dim=d, dtype=dtype,
                            paged=paged)
                        if geo["cluster"] != c:
                            raise RuntimeError(f"D{d}: expected a cluster of "
                                               f"{c}, got {geo}")
                        counts.append(geo["resident_clusters"])
                    cache = "paged" if paged else "contig"
                    out[f"D{d}/{nbytes}/{cache}/G{group}"] = tuple(counts)
    return out


def resident_table(occ: Dict[str, Tuple[int, ...]]):
    """``autotune.Hardware.resident`` from :func:`occupancy`: one row a
    (head dim, dtype), the fewest clusters over its caches and groups."""
    rows: Dict[Tuple[int, int], Tuple[int, ...]] = {}
    for key, counts in occ.items():
        d, nbytes = (int(x) for x in key[1:].split("/")[:2])
        have = rows.get((d, nbytes))
        rows[(d, nbytes)] = counts if have is None else tuple(
            min(a, b) for a, b in zip(have, counts))
    return tuple((d, b, c) for (d, b), c in sorted(rows.items()))


def measure(dtype=torch.float32, hw: autotune.Hardware = None
            ) -> Dict[str, dict]:
    """{geometry: {"plan": (num_splits, block_kv), "predicted_us",
    "measured_us": {num_splits: µs}, "best", "plan_share"}} for every
    candidate split of each geometry in ``dtype`` under ``hw`` (default
    ``autotune.H100``; ``plan_share``: the best measured time over the
    plan's measured time)."""
    hw = autotune.H100 if hw is None else hw
    nbytes = torch.tensor([], dtype=dtype).element_size()
    out = {}
    for name, g in GEOMETRIES.items():
        shape = dataclasses.replace(g.shape, dtype_bytes=nbytes)
        out[name] = plan_quality(shape, sweep(name, dtype), hw)
    return out


def plan_quality(shape: autotune.DecodeShape, timed: Callable,
                 hw: autotune.Hardware, measured: Dict[int, float] = None
                 ) -> dict:
    """The plan of ``shape`` under ``hw`` against the device time of every
    candidate split (``timed(num_splits, block_kv)`` seconds, or the µs
    already ``measured``)."""
    plan = autotune.plan_decode(shape, hw=hw)
    meas = measured or {ns: timed(ns, bk) * 1e6
                        for ns, bk in autotune.candidate_plans(shape, hw)}
    best = min(meas, key=meas.get)
    return {"plan": (plan.num_splits, plan.block_kv),
            "predicted_us": {ns: autotune.predict_time(shape, ns, 64, hw) * 1e6
                             for ns in meas},
            "measured_us": meas, "best": best,
            "plan_share": meas[best] / meas[plan.num_splits]}


def fit(res: Dict[str, dict], hw: autotune.Hardware = None
        ) -> autotune.Hardware:
    """``hw`` (default ``autotune.H100``) with ``stream_bw``, ``tile_s``,
    ``c0`` and ``c1`` fitted to the f32 times of :func:`measure`: the
    model is linear in (c0, tile_s, 1 / stream_bw, c1) once the merge's
    bytes term is moved to the left; least squares on the relative error,
    a term that would come out negative fixed at 0."""
    hw = autotune.H100 if hw is None else hw
    rows, rhs = [], []
    for name, r in res.items():
        shape = GEOMETRIES[name].shape
        for ns, t_us in r["measured_us"].items():
            waves, tiles, cell, merge = autotune.cost_terms(shape, int(ns), 64,
                                                            hw)
            t = t_us * 1e-6
            rows.append(np.array([waves, waves * tiles, waves * cell,
                                  float(merge > 0)]) / t)
            rhs.append((t - 2 * merge / hw.hbm_bw) / t)
    a, y = np.array(rows), np.array(rhs)
    coef = np.zeros(a.shape[1])
    free = list(range(a.shape[1]))
    while free:                 # a cost is never negative: fix those at 0
        sol = np.linalg.lstsq(a[:, free], y, rcond=None)[0]
        if (sol >= 0).all():
            coef[free] = sol
            break
        free.pop(int(np.argmin(sol)))
    c0, tile_s, inv_bw, c1 = coef
    return dataclasses.replace(hw, c0=float(c0), tile_s=float(tile_s),
                               stream_bw=float(1 / inv_bw), c1=float(c1))


def _report(tag: str, res: Dict[str, dict]) -> None:
    for name, r in res.items():
        meas = ", ".join(f"{ns}: {t:.2f}" for ns, t in r["measured_us"].items())
        pred = ", ".join(f"{ns}: {t:.2f}" for ns, t in r["predicted_us"].items())
        print(f"[decode_split] {tag} {name}: plan {r['plan'][0]} split(s); "
              f"measured us {{{meas}}}; predicted us {{{pred}}}; best "
              f"{r['best']}; plan at {r['plan_share']:.3f} of the best's "
              f"speed", flush=True)


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fit", action="store_true",
                    help="fit the H100 record's stream_bw, tile_s, c0, c1 to "
                         "the f32 times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_split needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    occ = occupancy()
    table = resident_table(occ)
    print(f"[decode_split] resident clusters of the one-row decode kernel: "
          f"{occ}", flush=True)
    print(f"[decode_split] resident table: {table} (the record's: "
          f"{autotune.H100.resident})", flush=True)
    hw = dataclasses.replace(autotune.H100, resident=table)
    res = {"float32": measure(torch.float32, hw)}
    _report("f32", res["float32"])
    if args.fit:
        hw = fit(res["float32"], hw)
        print(f"[decode_split] fit: stream_bw {hw.stream_bw:.6e} B/s, tile_s "
              f"{hw.tile_s:.6e} s, c0 {hw.c0:.6e} s, c1 {hw.c1:.6e} s")
        res["float32_fitted"] = {
            name: plan_quality(GEOMETRIES[name].shape, None, hw,
                               r["measured_us"])
            for name, r in res["float32"].items()}
        _report("f32 under the fit (in sample)", res["float32_fitted"])
    res["bfloat16"] = measure(torch.bfloat16, hw)
    _report("bf16" + (" under the fit (out of sample)" if args.fit else ""),
            res["bfloat16"])
    print(json.dumps({"occupancy": occ, "resident": table,
                      "record": dataclasses.asdict(hw), "geometries": res}))


if __name__ == "__main__":
    main()
