"""A run with the timed path broken underneath comes out not correct: the
harness skips its look for a card and drives the rest of a run on the CPU,
at a small size, with each fault the cells can have planted in the
program. The sound run beside them comes out correct."""

import time

import numpy as np
import pytest

from bench import cell
from bench_small import cell as cell_entry, config, mix

TRAIN = [("granite-3-2b.train-4k", "granite-3-2b", "train-4k"),
         ("hubert-xlarge.train-1k", "hubert-xlarge", "train-1k")]
SERVE = ("granite-3-2b.serve-docqa", "granite-3-2b", "serve-docqa")


def _run(name, conf, traffic_name, seconds=0.5, seed=2 ** 31 + 11, **mix_keys):
    return cell.execute(cell_entry(name), seed=seed, seconds=seconds,
                        trace_on=False, t_start=time.perf_counter(), device="cpu",
                        config=config(conf), mix=dict(mix(traffic_name), **mix_keys))


@pytest.mark.parametrize("case", TRAIN + [SERVE], ids=lambda c: c[0])
def test_sound_run_is_correct(case):
    out = _run(*case)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0


def test_every_prefill_route_is_recorded():
    """Prompts that share a prefix, with prefix caching and chunked prefill
    on: tokens come from the chunk rows and from prefix hits' suffixes as
    well as from packed rows of whole prompts, and each gets its first-token
    time and its logits checked."""
    small = mix(SERVE[2])
    out = _run(*SERVE, seconds=1.0, prefix={"tokens": 16, "count": 2},
               prompt=dict(small["prompt"], max=32),
               output=dict(small["output"], max=8),
               engine=dict(small["engine"], share_prefix=True, prefill_chunk=16))
    assert out.correct, out.checks
    run = out.run
    assert out.attempted > 0 and out.failed == 0
    assert all(t < float("inf") for t in run.ttft_s)
    spans = [sp for _, row, _ in run.rows for sp in row]
    assert any(a > 0 for a, _ in spans)              # a chunk or a suffix


def _state_unchanged(monkeypatch):
    from repro_torch.runtime import steps

    def update(grads, state, params, opt, lr=None, plan=None):
        return params, state, {"grad_norm": 0.0}
    monkeypatch.setattr(steps, "adamw_update", update)


def _half_batch(monkeypatch):
    from repro_torch.models import lm
    loss_fn = lm.loss_fn

    def half(cfg, params, batch, ctx):
        rows = batch["labels"].shape[0] // 2
        return loss_fn(cfg, params, {k: v[:rows] for k, v in batch.items()}, ctx)
    monkeypatch.setattr(lm, "loss_fn", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state-unchanged", "half-batch"])
@pytest.mark.parametrize("case", TRAIN, ids=lambda c: c[0])
def test_training_faults_are_caught(case, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(*case)
    assert not out.correct, out.checks


def test_an_altered_token_is_caught(monkeypatch):
    from repro_torch.serving import engine
    host = engine.ServingEngine._host
    calls = []

    def altered(logits):
        out = np.array(host(logits))
        calls.append(1)
        if len(calls) % 7 == 0:        # now and then a row's best token is
            out[0] = -out[0]           # replaced by its worst
        return out
    monkeypatch.setattr(engine.ServingEngine, "_host", staticmethod(altered))
    out = _run(*SERVE)
    assert not out.correct, out.checks
