"""The per-layer metrics that read the program's own spans
(``bench/program_spans.py``), on the CPU: a traced run of the small
serving cell reads the four host ones, and a traced run of each small
training cell none of the three device ones (there is no CUDA event on the
CPU); the decode step's launch and wait tile the benchmark's own span
around it."""

import time

import pytest

from bench import spec
from bench import cell as bench_cell
from bench_small import cell as cell_entry, config, mix

S = spec.benchmark()
SERVE = ("granite-3-2b.serve-docqa", "granite-3-2b", "serve-docqa")
TRAIN = [("granite-3-2b.train-4k", "granite-3-2b", "train-4k"),
         ("hubert-xlarge.train-1k", "hubert-xlarge", "train-1k")]
SERVE_READERS = ("decode_launch_ms.serve", "decode_wait_ms.serve",
                 "schedule_host_ms.serve", "prefill_fill_pct.serve")
DEVICE_READERS = ("fwd_ms.train", "bwd_ms.train", "optim_ms.train")


def _traced(name, conf, traffic, seconds, **mix_keys):
    out = bench_cell.execute(cell_entry(name), seed=2 ** 31 + 7, seconds=seconds,
                             trace_on=True, t_start=time.perf_counter(),
                             device="cpu", config=config(conf),
                             mix=dict(mix(traffic), **mix_keys))
    return out, {m["name"]: spec.reader(m["name"]).read(out.run)
                 for m in spec.metrics_for(S, name, True)}


def test_serving_reads_the_program_spans():
    out, got = _traced(*SERVE, seconds=1.5, trace_seconds=0.3)
    assert out.correct, out.checks
    for name in SERVE_READERS:
        assert got[name] is not None and got[name] > 0, name
    assert got["prefill_fill_pct.serve"] <= 100.0
    # launch runs from the step's call to its return, wait from there to
    # its logits on the host: together the benchmark's decode_step span
    tiled = got["decode_launch_ms.serve"] + got["decode_wait_ms.serve"]
    assert tiled == pytest.approx(got["decode_step_ms.serve"], rel=0.05)


@pytest.mark.parametrize("case", TRAIN, ids=lambda c: c[0])
def test_training_has_no_device_time_on_the_cpu(case):
    out, got = _traced(*case, seconds=0.5)
    assert out.correct, out.checks
    for name in DEVICE_READERS:
        assert name in got and got[name] is None, name
    assert got["batch_host_ms.train"] is not None
