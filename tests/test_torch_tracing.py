"""The port's recorder (``repro_torch.runtime.tracing``) on the CPU: spans
nest and name their parent, the ring drops its oldest, recording turns off
by ``enable(False)`` or ``REPRO_TORCH_TRACE=0``, ``record_function``
ranges are entered only while the profiler runs, and the counters are read
from the modules that keep them. Then the spans the port records: the
train step's forward, backward and optimizer, and the serving engine's
iterations (scheduling passes, prefill rows and decode steps with their
children), with first-token times and the same tokens whether recording
is on or off."""

import collections
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.runtime import tracing  # noqa: E402
from repro_torch.runtime.steps import make_train_step, place_batch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    was = tracing._on
    tracing.enable(True)
    yield
    tracing.enable(was)
    tracing.reset()


def _names(spans):
    return [s.name for s in spans]


def test_spans_nest_and_name_their_parent():
    with tracing.span("outer", rid=7) as outer:
        with tracing.span("inner.a"):
            pass
        with tracing.span("inner.b", device=True):
            pass
    got = tracing.spans()
    assert _names(got) == ["inner.a", "inner.b", "outer"]
    a, b, o = got
    assert o is outer and o.parent is None and o.attrs == {"rid": 7}
    assert a.parent is o and b.parent is o
    assert o.t0 <= a.t0 <= a.t1 <= b.t0 <= b.t1 <= o.t1
    assert b.device_ms is None          # no CUDA event on the CPU
    assert _names(tracing.spans("inner.b")) == ["inner.b"]
    assert tracing.spans("outer", t0=a.t0) == []        # started before t0
    assert _names(tracing.spans(t1=b.t1)) == ["inner.a", "inner.b"]


def test_the_ring_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(tracing, "_ring", collections.deque(maxlen=3))
    for i in range(5):
        with tracing.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in tracing.spans()] == [2, 3, 4]
    c = tracing.counters()
    assert c["tracing.spans"] == 5 and c["tracing.dropped"] == 2


def _off_by_call():
    tracing.enable(False)
    with tracing.span("a"):
        with tracing.span("b", device=True):
            pass
    return len(tracing.spans()), tracing._on


_OFF_BY_ENV = """
from repro_torch.runtime import tracing
with tracing.span("a"):
    with tracing.span("b", device=True):
        pass
print(len(tracing.spans()), tracing._on)
"""


def _off_by_env():
    env = dict(os.environ, REPRO_TORCH_TRACE="0",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _OFF_BY_ENV], env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    n, on = out.stdout.split()
    return int(n), on == "True"


@pytest.mark.parametrize("turn_off", [_off_by_call, _off_by_env],
                         ids=["enable-false", "env-zero"])
def test_recording_off_records_nothing(turn_off):
    assert turn_off() == (0, False)


def test_no_range_without_the_profiler(monkeypatch):
    entered = []
    monkeypatch.setattr(tracing._profiler, "record_function",
                        lambda name: entered.append(name))
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    assert entered == [] and _names(tracing.spans()) == ["b", "a"]


def test_ranges_under_the_profiler_nest_as_the_spans():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(4).sum()
    events = {e.name: e for e in prof.events()
              if e.name.startswith(tracing.RANGE_PREFIX)}
    assert set(events) == {"repro_torch.outer", "repro_torch.inner"}
    assert events["repro_torch.inner"].cpu_parent is events["repro_torch.outer"]
    assert _names(tracing.spans()) == ["inner", "outer"]


def test_counters_read_the_modules_that_keep_them(monkeypatch):
    from repro_torch.distributed import collectives
    from repro_torch.kernels import decode, flash_bwd, flash_fwd
    monkeypatch.setattr(flash_fwd, "launches", 3)
    monkeypatch.setattr(flash_bwd, "launches_bwd", 2)
    monkeypatch.setattr(decode, "launches_paged", 5)
    monkeypatch.setitem(collectives.stats, "calls", 4)
    c = tracing.counters()
    assert (c["flash_fwd.launches"], c["flash_bwd.launches_bwd"],
            c["decode.launches_paged"], c["collectives.calls"]) == (3, 2, 5, 4)
    tracing.reset()
    assert flash_fwd.launches == flash_bwd.launches_bwd == 0
    assert decode.launches_paged == collectives.stats["calls"] == 0


def _granite():
    return dataclasses.replace(tconfigs.smoke_config("granite_3_2b"),
                               dtype=torch.float32)


@pytest.mark.parametrize("microbatch", [None, 1], ids=["whole", "micro-1"])
def test_train_step_spans(microbatch):
    cfg = _granite()
    arts = make_train_step(cfg, impl="torch", device="cpu",
                           microbatch=microbatch)
    params, opt_state = arts.init_fn(0)
    rs = np.random.RandomState(0)
    batch = {k: rs.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    tracing.reset()
    arts.step_fn(params, opt_state, place_batch(batch, "cpu"), 3)
    got = tracing.spans()
    place, step = got[0], got[-1]
    assert place.name == "data.place" and place.parent is None
    assert step.name == "train.step" and step.attrs == {"step": 3}
    kids = [s for s in got if s.parent is step]
    phases = ["train.forward", "train.backward"] * (2 if microbatch else 1)
    assert _names(kids) == phases + ["train.optimizer"]
    assert all(k.device_ms is None for k in kids)
    assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
    if microbatch:
        assert [k.attrs for k in kids[:4]] == [{"micro": 0}, {"micro": 0},
                                               {"micro": 1}, {"micro": 1}]


_MODES = {
    # name: (pool (page_size, num_pages, max_batch, max_pages_per_seq),
    #        prefill_len, engine kwargs)
    "eager": ((8, 11, 2, 3), 24, {}),
    "prefix_chunk": ((4, 25, 2, 8), 16, {"share_prefix": True,
                                         "prefill_chunk": 6}),
    "speculate_3": ((8, 11, 2, 3), 24, {"speculate_k": 3}),
}
_LENS = ((12, 6), (7, 8), (9, 4), (10, 5))


def _serve(mode, params, cfg):
    (ps, n_pages, mb, mp), prefill_len, kw = _MODES[mode]
    eng = tserving.ServingEngine(
        cfg, tserving.PagedCacheConfig(page_size=ps, num_pages=n_pages,
                                       max_batch=mb, max_pages_per_seq=mp),
        params, impl="torch", device="cpu", prefill_len=prefill_len,
        torch_chunk=16, **kw)
    rs = np.random.RandomState(1)
    # a common prefix where the engine shares it
    system = rs.randint(0, cfg.vocab_size, size=8 if kw.get("share_prefix")
                        else 0)
    reqs = [(np.concatenate([system, rs.randint(0, cfg.vocab_size, size=n)])
             .astype(np.int32), g) for n, g in _LENS]
    out, _ = eng.run(reqs)
    return eng, reqs, out


@pytest.mark.parametrize("mode", list(_MODES))
def test_engine_spans(mode):
    cfg = _granite()
    params = tlm.init_params(cfg, seed=0, device="cpu")
    tracing.enable(False)
    _, _, quiet = _serve(mode, params, cfg)
    assert tracing.spans() == []
    tracing.enable(True)
    eng, reqs, out = _serve(mode, params, cfg)
    assert out.keys() == quiet.keys() and len(out) == len(reqs)
    for rid in out:
        np.testing.assert_array_equal(out[rid], quiet[rid])
    got = tracing.spans()
    its = [s for s in got if s.name == "serve.iteration"]
    assert its and all(s.parent is None for s in its)
    for name in ("serve.schedule", "serve.prefill", "serve.decode"):
        mine = [s for s in got if s.name == name]
        assert mine and all(s.parent in its for s in mine), name
    children = {"serve.prefill": ["pack", "launch", "wait"],
                "serve.decode": ["prepare", "launch", "wait", "sample"]}
    for name, kids in children.items():
        for s in (s for s in got if s.name == name):
            assert _names(k for k in got if k.parent is s) \
                == [f"{name}.{k}" for k in kids]
    rows = [s for s in got if s.name == "serve.prefill"]
    lens = {rid: len(t) for rid, (t, _) in enumerate(reqs)}
    for s in rows:
        assert 0 < s.attrs["tokens"] <= s.attrs["width"]
        assert set(s.attrs["rids"]) <= lens.keys()
    # every prompt token went through a row once (no prefix sharing) or
    # at most once (shared pages skip their tokens)
    total = sum(s.attrs["tokens"] for s in rows)
    if mode == "prefix_chunk":
        assert 0 < total < sum(lens.values())
    else:
        assert total == sum(lens.values())
    decodes = [s for s in got if s.name == "serve.decode"]
    assert all(1 <= s.attrs["rows"] <= 2 for s in decodes)
    # every first token reached the host inside a prefill row that held
    # its request
    assert eng.first_token_at.keys() == out.keys()
    for rid, t in eng.first_token_at.items():
        assert any(rid in s.attrs["rids"] and s.t0 <= t <= s.t1 for s in rows)
