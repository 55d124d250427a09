"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, per-layer metrics and limits are
found by name (``bench/README.md``). The run warms up (set-up, timed as
``setup_s`` from the start of this process), measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints the numbers compared beside their limits as the last lines of
standard error and one JSON result as the last line of standard output:
the end-to-end metrics, or with ``--trace 1`` the per-layer ones read from
a profiled part of the window. ``--tf32 1`` runs the control: matrix
products on TF32, a precision below the configuration's, which the check
must refuse.

It exits non-zero with no result where there is no CUDA card, too few of
them, no program under test beside it (``src/repro_torch``), or, once the
window has closed, JAX or the JAX package loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str, code: int = 2):
    print(f"bench/run.py: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tf32", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches of this process stay at fixed paths inside the checkout, and
    # no library brings JAX in
    os.environ["USE_FLAX"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no program under test: {ROOT / 'src' / 'repro_torch'} is missing")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from bench import cell as bench_cell
    from bench import spec

    bench_spec = spec.benchmark()
    cell = spec.cell(bench_spec, args.workload)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: the benchmark measures the port on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{cell['name']} needs {cell['chips']} cards, this machine has "
             f"{torch.cuda.device_count()}")

    out = bench_cell.execute(cell, seed=args.seed, seconds=args.seconds,
                             trace_on=bool(args.trace), t_start=T_START,
                             tf32=bool(args.tf32))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": out.peak_bytes}
    line = bench_cell.report(bench_spec, cell, out, bool(args.trace), device)
    held = forbidden_loaded()
    if held:
        fail(f"the process holds {', '.join(held)} after the window")
    for name, c in out.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr,
              flush=True)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
