"""BENCHMARK.json keeps to the contract's shape and character rules, and
every file it names is found by name."""

import json

import pytest

from bench import spec, traffic

BENCH = spec.BENCH
S = spec.benchmark()
CELLS = [w["name"] for w in S["workloads"]]
METRICS = S["end_to_end"] + S["per_layer"]


def test_top_level_keys():
    assert set(S) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert S["command"] == ["python3", "bench/run.py"]
    assert S["paths"] == ["bench"]
    assert 1 <= S["run_seconds"] <= 51
    assert len(json.dumps(S)) < 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in S["configs"]] + CELLS
                         + [m["name"] for m in METRICS]
                         + [w["traffic"] for w in S["workloads"]])
def test_names_keep_to_the_rules(name):
    assert spec.NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert spec.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    keys = set(metric) - {"workloads"}
    if metric in S["end_to_end"]:
        assert keys == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert keys == {"name", "unit", "better", "source", "layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        e2e = {m["name"]: m for m in S["end_to_end"]}
        moved = e2e[metric["moves"]]
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", CELLS)
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    assert callable(spec.reader(metric["name"]).read)


def test_names_are_unique():
    for group in ([c["name"] for c in S["configs"]], CELLS,
                  [m["name"] for m in METRICS]):
        assert len(group) == len(set(group))
    assert len({(w["config"], w["traffic"]) for w in S["workloads"]}) == len(CELLS)


@pytest.mark.parametrize("cell", S["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found_by_name(cell):
    assert cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200
    conf = spec.config(cell["config"])
    entry = next(c for c in S["configs"] if c["name"] == cell["config"])
    assert entry["file"] == f"bench/configs/{cell['config']}.json"
    assert conf["source"] == entry["source"] and conf["reduced"] == entry["reduced"]
    assert conf["name"] == cell["config"]
    mix = traffic.load(cell["traffic"])
    assert (BENCH / "drivers" / f"{mix['kind']}.py").is_file()
    limits = spec.limits(cell["name"])
    assert limits and all(v > 0 for v in limits.values())
    assert spec.reference(conf).leaves(conf)
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = spec.metrics_for(S, cell["name"], False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert spec.metrics_for(S, cell["name"], True)


def test_every_config_is_used():
    used = {w["config"] for w in S["workloads"]}
    assert used == {c["name"] for c in S["configs"]}
