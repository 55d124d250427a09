"""Hillclimb driver over dry-run cells (counterpart of
``repro.launch.hillclimb``): each experiment runs one cell of
``launch/dryrun.py`` with one override applied, writes a tagged artifact
next to the baseline's, and prints before → after of every roofline term,
``mfu`` and the bytes a rank holds. The numbers are the dry run's model
of one H100, not measurements.

An experiment is JAX's ``(arch, shape, tag, ArchConfig overrides)``. JAX's
fifth field, step options (``decode_write``, ``microbatch``), is empty in
every experiment and has no counterpart in the port's dry run, so it is
left out. The baseline is the untagged artifact of the cell on the
``16x16`` mesh: run ``launch.dryrun`` first.

Round 2 (``EXPERIMENTS``) changes nothing in the port: its
``decode_rules_v2`` entries override nothing (they re-ran a change JAX
made to its decode rules, which the port's rules carry already), and its
``ctx_parallel_v2`` entries set the ``ctx_parallel_attn`` those configs
already have. Its after equals its before; read it as a re-trace of the
baseline, not as a result. Round 3 (``--round3``) overrides the sharding
profile and does move the model.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--only TAG] [--round3]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.configs import get_config
from repro_torch.launch import dryrun

# (arch, shape, tag, ArchConfig overrides): JAX's round 2 (its comments
# there give each experiment's diagnosis, made on its TPU compiles)
EXPERIMENTS = [
    # decode: the q activation replicated where the cache is seq-sharded
    ("deepseek_67b", "decode_32k", "decode_rules_v2", {}),
    ("granite_3_2b", "decode_32k", "decode_rules_v2", {}),
    ("llava_next_34b", "decode_32k", "decode_rules_v2", {}),
    ("dbrx_132b", "decode_32k", "decode_rules_v2", {}),
    # context parallelism: attention's query rows over model
    ("deepseek_coder_33b", "prefill_32k", "ctx_parallel_v2",
     dict(ctx_parallel_attn=True)),
    ("llava_next_34b", "prefill_32k", "ctx_parallel_v2",
     dict(ctx_parallel_attn=True)),
    ("qwen3_14b", "prefill_32k", "ctx_parallel_v2",
     dict(ctx_parallel_attn=True)),
]

# JAX's round 3: the ZeRO-3 profile on the small dense and hybrid train
# cells (the profile needs fsdp=True beside sharding_profile="fsdp")
ROUND3 = [
    ("granite_3_2b", "train_4k", "fsdp_profile",
     dict(sharding_profile="fsdp", fsdp=True)),
    ("hubert_xlarge", "train_4k", "fsdp_profile",
     dict(sharding_profile="fsdp", fsdp=True)),
    ("recurrentgemma_2b", "train_4k", "fsdp_profile",
     dict(sharding_profile="fsdp", fsdp=True)),
]


def load(arch, shape, tag=""):
    """A cell's artifact on the ``16x16`` mesh (``tag`` its suffix), or
    None."""
    suffix = f"__{tag}" if tag else ""
    path = dryrun.ART_DIR / f"{arch}__{shape}__16x16{suffix}.json"
    if not path.exists():
        return None
    return json.loads(path.read_text())


def report(before, after, tag):
    """Print before → after of each roofline term, mfu and bytes a rank."""
    if not before or not after or "roofline" not in after \
            or "roofline" not in before:
        print(f"  [{tag}] missing artifacts for comparison")
        return
    b, a = before["roofline"], after["roofline"]
    print(f"  {'term':12s} {'before':>10s} {'after':>10s} {'delta':>8s}")
    for term in ("compute_s", "memory_s", "collective_s", "step_time_s"):
        bb, aa = b[term], a[term]
        d = (bb / aa) if aa > 0 else float("inf")
        print(f"  {term:12s} {bb * 1e3:9.1f}m {aa * 1e3:9.1f}m {d:7.2f}x")
    print(f"  {'mfu':12s} {b['mfu'] * 100:9.1f}% {a['mfu'] * 100:9.1f}%")
    bm = before["memory"]["held_bytes"]["total"]
    am = after["memory"]["held_bytes"]["total"]
    print(f"  {'held/rank':12s} {bm / 1e9:8.2f}G {am / 1e9:9.2f}G")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None)
    ap.add_argument("--round3", action="store_true")
    args = ap.parse_args(argv)
    experiments = ROUND3 if args.round3 else EXPERIMENTS
    out = {}
    for arch, shape, tag, cfg_over in experiments:
        if args.only and args.only != tag:
            continue
        print(f"\n=== {arch} × {shape} :: {tag} ===", flush=True)
        cfg = get_config(arch)
        if cfg_over:
            cfg = dataclasses.replace(cfg, **cfg_over)
        meta = dryrun.run_cell(arch, shape, multi_pod=False, tag=f"__{tag}",
                               cfg_override=cfg)
        report(load(arch, shape), meta, tag)
        out[(arch, shape, tag)] = meta
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
