"""Launch-parameter planning for the split-KV flash decode (counterpart of
``repro.perf.autotune``, whose constants are a TPU's).

A decode launch is bound by the bytes of K and V it reads, so the one
launch decision that matters is how to spread that traffic over the
device: too few parallel units and most of the device waits behind the few
that stream; too many splits and the fixed cost of a unit plus the f32
merge of the splits' partial states dominate. :func:`predict_time` models
that trade-off for a :class:`Hardware` record:

    t_attn  = waves · (tiles of the busiest unit · tile_s
                       + its bytes / stream_bw + c₀)
    t_merge = 2 · ns·B·Hq·(D+2)·4 bytes / hbm_bw + c₁   (ns > 1 only)

Two records exist. :data:`TPU_V5E` holds the JAX package's constants and
reproduces its planner exactly: a unit is a grid cell (batch row, kv head,
split) streaming its ``block_kv`` blocks at the chip's HBM rate, 8 of them
in flight, no cost a tile. :data:`H100` (the default) describes what the
port's kernel launches (``kernels/decode.py`` ``launch_geometry``,
``csrc/flash_decode.cu`` ``geometry``): the split unit is the kernel's
64-row tile, so ``block_kv`` is not a choice; a split is a cluster of up to
8 blocks per (row, kv head, split), the cluster grown while the launch puts
fewer blocks than SMs on the card, its blocks dealt the split's tiles; a
unit is one such cluster, as long as its busiest block, which pays a
latency a tile and streams at a rate far below the card's (a one-row block
is bound by the latency of its loads); the card holds a number of them at
once that falls faster than the cluster grows (a cluster's blocks share
one GPC: ``resident``, read on the card). Tiles outside a sliding
``window`` are skipped by the kernel, so the busiest block is the one whose
split holds the most tiles inside it. One shard of a page-sharded pool
(``shards > 1``, ``flash_paged_decode_partials``) launches over the whole
table and visits every tile that holds a page it owns (nearly all of them
when a tile spans several pages), but reads only its own pages' rows: the
tiles of the whole table, ``1 / shards`` of their bytes. A (head dim,
dtype) whose resident clusters the record has not read plans one split.

:func:`plan_decode` picks ``(num_splits, block_kv)`` for a decode geometry
(:class:`DecodeShape`) from the model, optionally refined by a timing
sweep of the real kernel (``sweep=``; ``perf/decode_split.py`` builds one
on the card), and memoises through a persistent JSON cache
(:class:`AutotuneCache`: ``$REPRO_TORCH_AUTOTUNE_CACHE`` >
``~/.cache/repro_torch/autotune.json`` > a repo-local
``.autotune_cache_torch.json``), whose entries name the device they were
planned for and the record's fingerprint. It never reads the JAX
package's cache. The planner is pure: a plan never needs a card. ``ServingEngine(autotune=True)`` and
``launch/serve.py --autotune`` call :func:`plan_decode_persistent` once per
engine build.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.perf.memory_model import BF16  # the default cache dtype
from repro_torch.perf.roofline import HBM_BW

SPLIT_CANDIDATES = (1, 2, 4, 8, 16, 32)

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"


@dataclasses.dataclass(frozen=True)
class Hardware:
    """What the cost model knows of a device.

    capacity: parallel units in flight (TPU grid cells) or SMs (H100);
    hbm_bw: the device's memory rate (the merge term); stream_bw: the rate
    one unit streams its bytes; tile_s: a unit's cost a tile beyond its
    bytes; c0: a wave's fixed cost; c1: the merge pass's fixed cost;
    split_unit: cache rows of the kernel's split tile (0: ``block_kv`` is
    the unit and a choice); block_candidates: ``block_kv`` values of a
    contiguous cache when it is a choice; max_cluster: blocks a split may
    spread over (1: none); resident: ``((head_dim, dtype_bytes, (clusters
    of 1, 2, 4, 8 blocks the device holds at once)), ...)``; a record
    without one holds ``capacity // cluster``."""
    name: str
    capacity: int
    hbm_bw: float
    stream_bw: float
    c0: float
    c1: float
    split_unit: int
    block_candidates: Tuple[int, ...]
    tile_s: float = 0.0
    max_cluster: int = 1
    resident: Tuple[Tuple[int, int, Tuple[int, ...]], ...] = ()

    def resident_clusters(self, head_dim: int, dtype_bytes: int,
                          cluster: int) -> int:
        """Units of ``cluster`` blocks the device holds at once at this
        head dim and dtype."""
        for d, b, counts in self.resident:
            if (d, b) == (head_dim, dtype_bytes):
                return counts[cluster.bit_length() - 1]
        return max(1, self.capacity // cluster)

    def reads(self, head_dim: int, dtype_bytes: int) -> bool:
        """Whether the record knows the resident clusters at this head dim
        and dtype (a record without a ``resident`` table knows them all)."""
        return not self.resident or any((d, b) == (head_dim, dtype_bytes)
                                        for d, b, _ in self.resident)

    def fingerprint(self) -> str:
        """The record's name and a digest of every field: a plan cached
        under another fingerprint (a refit) is a miss."""
        digest = hashlib.sha1(repr(dataclasses.astuple(self)).encode())
        return f"{self.name}:{digest.hexdigest()[:12]}"


#: the JAX planner's constants (TPU v5e): 8 grid cells in flight (TPU cores
#: × the Mosaic pipeline depth), each streaming at the chip's 819 GB/s
TPU_V5E = Hardware(name="tpu_v5e", capacity=8, hbm_bw=819e9, stream_bw=819e9,
                   c0=1e-6, c1=2e-6, split_unit=0,
                   block_candidates=(128, 256, 512, 1024))

#: the port's kernel on one H100 SXM (132 SMs), from one run of
#: ``python3 -m repro_torch.perf.decode_split --fit`` on an NVIDIA H100 80GB
#: HBM3 at a 700.00 W power limit. resident: the one-row decode kernel's
#: resident clusters (``launch_geometry``) at every head dim and dtype the
#: kernel takes (the same on the contiguous and paged caches and at one or
#: the most query heads a kv head). stream_bw, tile_s, c0 and c1: least
#: squares on the relative error of the device time of the 33 candidate
#: splits of the serving paths' seven decode geometries in f32 (cold L2;
#: c0 came out negative and is fixed at 0: the tile term holds a launch's
#: latency). bf16 times were not fitted: that run measured them out of
#: sample (PERF.md, the planner's table).
H100 = Hardware(name="h100_sxm", capacity=132, hbm_bw=HBM_BW,
                stream_bw=1.319746e10, tile_s=3.709045e-06, c0=0.0,
                c1=2.529077e-05, split_unit=64,
                block_candidates=(64,), max_cluster=8,
                resident=((16, 2, (1056, 528, 248, 124)),
                          (16, 4, (1056, 528, 248, 124)),
                          (32, 2, (1056, 528, 248, 124)),
                          (32, 4, (660, 330, 154, 77)),
                          (64, 2, (660, 330, 154, 77)),
                          (64, 4, (396, 198, 92, 45)),
                          (128, 2, (396, 198, 92, 45)),
                          (128, 4, (132, 66, 30, 15)),
                          (256, 2, (264, 132, 62, 30)),
                          (256, 4, (132, 66, 30, 15))))


@dataclasses.dataclass(frozen=True)
class DecodeShape:
    """The launch-relevant decode geometry, the autotune cache key.

    ``page_size == 0`` means a contiguous cache; ``page_size > 0`` a page
    pool (on a TPU the page pins ``block_kv``). ``kv_len`` is the cache
    reach the plan is for (a shard's launch: the whole table's); ``window``
    a sliding window (0: none), whose outside the kernel skips; ``shards``
    the shards of a page-sharded pool, one of which launches (port-only
    fields: the key is JAX's without them)."""
    batch: int
    hkv: int                 # KV heads (grid parallelism, with batch)
    group: int               # Hq // Hkv (merge-pass rows = batch·hkv·group)
    kv_len: int              # cache length the plan is tuned for
    head_dim: int
    page_size: int = 0
    dtype_bytes: int = BF16
    window: int = 0
    shards: int = 1

    def key(self) -> str:
        """Stable string form used as the JSON cache key."""
        return (f"b{self.batch}.h{self.hkv}.g{self.group}.s{self.kv_len}"
                f".d{self.head_dim}.p{self.page_size}.by{self.dtype_bytes}"
                + (f".w{self.window}" if self.window else "")
                + (f".n{self.shards}" if self.shards > 1 else ""))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """A chosen (num_splits, block_kv) with its predicted/measured time."""
    num_splits: int
    block_kv: int
    time_s: float            # cost-model prediction, or sweep measurement
    source: str = "model"    # "model" | "sweep" | "cache"


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _busiest_split(shape: DecodeShape, unit: int, ns: int, nj: int,
                   nk: int) -> int:
    """Tiles read by the split that reads the most: all ``nj`` of a split
    without a window; with one, those inside the last ``window`` positions
    of the reach."""
    if not shape.window or shape.window >= shape.kv_len:
        return nj
    first = (shape.kv_len - shape.window) // unit
    return max(min((s + 1) * nj, nk) - max(s * nj, first) for s in range(ns))


def cluster_size(units: int, nj: int, hw: Hardware) -> int:
    """Blocks a split spreads over: doubled, up to ``hw.max_cluster`` and the
    split's tiles, while the launch holds fewer blocks than ``hw.capacity``
    (``csrc/flash_decode.cu`` ``geometry``)."""
    c = 1
    while c < hw.max_cluster and 2 * c <= nj and units * c < hw.capacity:
        c *= 2
    return c


def _layout(shape: DecodeShape, num_splits: int, block_kv: int,
            hw: Hardware) -> Tuple[int, int, int, int, int]:
    """``(unit rows, tiles, splits, tiles a split, units)`` of one launch."""
    unit = hw.split_unit or block_kv
    nk = max(1, _ceil_div(shape.kv_len, unit))
    num_splits = max(1, min(num_splits, nk))
    nj = _ceil_div(nk, num_splits)
    return unit, nk, num_splits, nj, shape.batch * shape.hkv * num_splits


def split_cluster(shape: DecodeShape, num_splits: int, hw: Hardware = None,
                  block_kv: Optional[int] = None) -> int:
    """Blocks a split of this launch spreads over (the kernel's
    ``launch_geometry(...)["cluster"]`` on the card); ``block_kv`` counts
    only where the record has no split unit (default its smallest
    candidate)."""
    hw = H100 if hw is None else hw
    _, _, _, nj, units = _layout(shape, num_splits,
                                 block_kv or min(hw.block_candidates), hw)
    return cluster_size(units, nj, hw)


def cost_terms(shape: DecodeShape, num_splits: int, block_kv: int,
               hw: Hardware = None) -> Tuple[int, int, int, int]:
    """``(waves, tiles and bytes of the busiest unit, merge bytes)`` of one
    launch (merge bytes 0 for one split): the terms :func:`predict_time`
    weighs.

    A split of ``nj`` tiles of ``hw.split_unit`` rows (or ``block_kv`` rows
    where that is the unit) is one unit, or a cluster of blocks that deal
    its tiles; units beyond what the device holds at once serialise into
    waves. A shard reads ``1 / shards`` of its tiles' bytes."""
    hw = H100 if hw is None else hw
    unit, nk, num_splits, nj, units = _layout(shape, num_splits, block_kv, hw)
    c = cluster_size(units, nj, hw)
    tiles = _ceil_div(_busiest_split(shape, unit, num_splits, nj, nk), c)
    kv_bytes_per_cell = (2 * tiles * unit * shape.head_dim * shape.dtype_bytes
                         // shape.shards)
    waves = _ceil_div(units, hw.resident_clusters(shape.head_dim,
                                                  shape.dtype_bytes, c))
    hq = shape.hkv * shape.group
    merge_bytes = (0 if num_splits == 1 else
                   num_splits * shape.batch * hq * (shape.head_dim + 2) * 4)
    return waves, tiles, kv_bytes_per_cell, merge_bytes


def predict_time(shape: DecodeShape, num_splits: int, block_kv: int,
                 hw: Hardware = None) -> float:
    """Cost-model seconds for one decode launch (module docstring): a wave
    takes its busiest unit's tiles at ``hw.tile_s`` and bytes at
    ``hw.stream_bw``, plus ``hw.c0``; splitting adds the f32 merge of the
    partial states."""
    hw = H100 if hw is None else hw
    waves, tiles, kv_bytes_per_cell, merge_bytes = cost_terms(
        shape, num_splits, block_kv, hw)
    t_attn = waves * (tiles * hw.tile_s + kv_bytes_per_cell / hw.stream_bw
                      + hw.c0)
    if not merge_bytes:
        return t_attn
    # the merge reads every partial and writes one final state (≈2× traffic)
    t_merge = 2 * merge_bytes / hw.hbm_bw + hw.c1
    return t_attn + t_merge


def candidate_plans(shape: DecodeShape, hw: Hardware = None
                    ) -> Sequence[Tuple[int, int]]:
    """(num_splits, block_kv) pairs worth considering for a shape.

    Where the kernel's tile is the split unit (H100), ``block_kv`` is that
    tile on both caches. Else paged caches fix ``block_kv = page_size`` and
    contiguous caches sweep the block candidates no larger than the cache.
    Split counts are capped so every split owns at least one block; a (head
    dim, dtype) the record has not read keeps one split."""
    hw = H100 if hw is None else hw
    if not hw.reads(shape.head_dim, shape.dtype_bytes):
        return [(1, hw.split_unit or min(hw.block_candidates))]
    if hw.split_unit:
        blocks = (hw.split_unit,)
    elif shape.page_size > 0:
        blocks = (shape.page_size,)
    else:
        blocks = tuple(b for b in hw.block_candidates if b <= shape.kv_len)
        if not blocks:
            blocks = (max(8, _ceil_div(shape.kv_len, 8) * 8),)
    pairs = []
    for bk in blocks:
        nk = max(1, _ceil_div(shape.kv_len, bk))
        for ns in SPLIT_CANDIDATES:
            if ns <= nk:
                pairs.append((ns, bk))
    return pairs


def plan_decode(shape: DecodeShape, *,
                sweep: Optional[Callable[[int, int], float]] = None,
                cache: Optional["AutotuneCache"] = None,
                hw: Hardware = None) -> LaunchPlan:
    """Choose launch parameters for one decode geometry.

    Pure by default: the cost model alone ranks :func:`candidate_plans`,
    so a valid plan never needs a device. ``sweep`` is an optional measured
    refinement: a callable ``(num_splits, block_kv) -> seconds`` (e.g.
    ``perf/decode_split.py``'s device timer over the real kernel) applied
    to the model's top four. ``cache`` memoises per
    :meth:`DecodeShape.key` and device; hits skip both model and sweep."""
    hw = H100 if hw is None else hw
    if cache is not None:
        hit = cache.get(shape, hw)
        if hit is not None:
            return hit
    ranked = sorted(candidate_plans(shape, hw),
                    key=lambda p: predict_time(shape, *p, hw))
    ns, bk = ranked[0]
    plan = LaunchPlan(num_splits=ns, block_kv=bk,
                      time_s=predict_time(shape, ns, bk, hw))
    if sweep is not None:
        best = None
        for ns, bk in ranked[:4]:          # measure only the model's top-4
            t = sweep(ns, bk)
            if best is None or t < best.time_s:
                best = LaunchPlan(num_splits=ns, block_kv=bk, time_s=t,
                                  source="sweep")
        plan = best
    if cache is not None:
        cache.put(shape, plan, hw)
    return plan


def plan_decode_persistent(shape: DecodeShape, *, device: Optional[str] = None,
                           **kw) -> LaunchPlan:
    """:func:`plan_decode` through the default persistent cache, its entries
    made for ``device`` (a card's name; default :func:`device_name`).

    Opens the default cache, plans (hits short-circuit), persists —
    swallowing OSError so read-only cache locations degrade to planning
    without memoisation. The one entry point the serving engine and the
    launcher share."""
    cache = AutotuneCache(device=device)
    plan = plan_decode(shape, cache=cache, **kw)
    try:
        cache.save()
    except OSError:
        pass                       # read-only filesystems: plan still valid
    return plan


def device_name(device=None) -> str:
    """The name a plan is recorded under: the card's
    (``torch.cuda.get_device_name``) for a CUDA device, else ``"cpu"``.
    ``device`` None: card 0 where one is present."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class AutotuneCache:
    """Persistent JSON store of launch plans, keyed by decode geometry.

    Resolution order for the backing file: explicit ``path`` argument >
    ``$REPRO_TORCH_AUTOTUNE_CACHE`` > ``~/.cache/repro_torch/autotune.json``
    > a repo-local ``.autotune_cache_torch.json`` (when there is no home).
    Each entry names the device it was planned for and the fingerprint of
    the hardware record it was planned with (:meth:`Hardware.fingerprint`);
    an entry of another device, another record or a refit one is a miss.
    Writes are atomic (tempfile + rename) so concurrent engines can share a
    cache."""

    def __init__(self, path: Optional[os.PathLike] = None,
                 device: Optional[str] = None):
        self.path = Path(path) if path is not None else self.default_path()
        self.device = device if device is not None else device_name()
        self._plans: Dict[str, Tuple[str, str, LaunchPlan]] = {}
        self.load()

    @staticmethod
    def default_path() -> Path:
        """The environment-overridable cache location (class docstring)."""
        env = os.environ.get(CACHE_ENV)
        if env:
            return Path(env)
        try:
            home = Path.home()
        except RuntimeError:
            home = None
        if home is not None:
            return home / ".cache" / "repro_torch" / "autotune.json"
        return Path(".autotune_cache_torch.json")

    def load(self) -> None:
        """Re-read the backing file (missing/corrupt files load as empty)."""
        self._plans = {}
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return
        if not isinstance(raw, dict):
            return
        for key, rec in raw.items():
            try:
                self._plans[key] = (str(rec["device"]), str(rec["hardware"]),
                                    LaunchPlan(num_splits=int(rec["num_splits"]),
                                               block_kv=int(rec["block_kv"]),
                                               time_s=float(rec["time_s"]),
                                               source="cache"))
            except (KeyError, TypeError, ValueError):
                continue                   # skip malformed entries, keep rest

    def get(self, shape: DecodeShape, hw: Hardware = None
            ) -> Optional[LaunchPlan]:
        """The cached plan for this geometry, made on this cache's device
        with ``hw``, or None."""
        hw = H100 if hw is None else hw
        rec = self._plans.get(shape.key())
        if rec is None or rec[:2] != (self.device, hw.fingerprint()):
            return None
        return rec[2]

    def put(self, shape: DecodeShape, plan: LaunchPlan,
            hw: Hardware = None) -> None:
        """Record a plan in memory (call :meth:`save` to persist)."""
        hw = H100 if hw is None else hw
        self._plans[shape.key()] = (self.device, hw.fingerprint(), plan)

    def save(self) -> None:
        """Atomically persist every recorded plan to the backing file."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {k: {"num_splits": p.num_splits, "block_kv": p.block_kv,
                       "time_s": p.time_s, "source": p.source,
                       "device": dev, "hardware": hw}
                   for k, (dev, hw, p) in self._plans.items()}
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
