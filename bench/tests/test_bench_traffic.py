"""Each mix is a pure function of the seed: the same seed gives the same
inputs, another seed other inputs; serving lengths are drawn stratified,
so a block of requests spans each distribution whatever the seed."""

import numpy as np
import pytest

from bench import spec, traffic
from bench_small import config

S = spec.benchmark()
TRAIN = [w for w in S["workloads"] if traffic.load(w["traffic"])["kind"] == "train"]
SERVE = [w for w in S["workloads"] if traffic.load(w["traffic"])["kind"] == "serve"]
SEEDS = (0, 7, 2 ** 31 + 5)


@pytest.mark.parametrize("cell", TRAIN, ids=lambda w: w["name"])
def test_train_batches_follow_the_seed(cell):
    mix = traffic.load(cell["traffic"])
    conf = config(cell["config"])
    mix = dict(mix, batch=2, seq_len=32)
    a = traffic.train_batch(mix, conf, SEEDS[2], 1)
    b = traffic.train_batch(mix, conf, SEEDS[2], 1)
    c = traffic.train_batch(mix, conf, SEEDS[1], 1)
    d = traffic.train_batch(mix, conf, SEEDS[2], 2)
    for k in a:
        assert np.array_equal(a[k], b[k])
        assert not np.array_equal(a[k], c[k]) and not np.array_equal(a[k], d[k])
    assert a["labels"].shape == (2, 32) and a["labels"].dtype == np.int32
    assert 0 <= a["labels"].min() and a["labels"].max() < conf["vocab_size"]


@pytest.mark.parametrize("cell", SERVE, ids=lambda w: w["name"])
def test_serve_stream_follows_the_seed(cell):
    mix = traffic.load(cell["traffic"])
    conf = spec.config(cell["config"])
    pages = mix["pages"]
    n = mix["clients"]
    streams = {}
    for seed in SEEDS:
        reqs = [traffic.serve_request(mix, conf, seed, i) for i in range(4 * n)]
        for tokens, o in reqs:
            p = len(tokens)
            assert mix["prompt"]["min"] <= p <= mix["prompt"]["max"]
            assert p <= mix["engine"]["prefill_len"]
            assert mix["output"]["min"] <= o <= mix["output"]["max"]
            assert p + o <= pages["page_size"] * pages["max_pages_per_seq"]
            assert tokens.dtype == np.int32 and tokens.max() < conf["vocab_size"]
        streams[seed] = reqs
    again = traffic.serve_request(mix, conf, SEEDS[2], 3)
    assert np.array_equal(again[0], streams[SEEDS[2]][3][0])
    sizes = {seed: [(len(t), o) for t, o in r] for seed, r in streams.items()}
    assert sizes[SEEDS[0]] != sizes[SEEDS[1]]
    # stratified: a block of as many requests as clients reaches the clip
    # of the prompt's lognormal, and its total work moves little from seed
    # to seed
    for seed, sz in sizes.items():
        for b in range(4):
            block = sz[b * n:(b + 1) * n]
            assert max(p for p, _ in block) == mix["prompt"]["max"]
    totals = [sum(p for p, _ in sz[:n]) for sz in sizes.values()]
    assert max(totals) - min(totals) < 0.05 * min(totals)
    # the warm-up stream's lengths are the same for every seed
    warm = [[len(traffic.serve_request(mix, conf, seed, i, warmup=True)[0])
             for i in range(n)] for seed in SEEDS]
    assert warm[0] == warm[1] == warm[2]


def test_shared_prefixes_follow_the_seed():
    cell = SERVE[0]
    conf = spec.config(cell["config"])
    mix = dict(traffic.load(cell["traffic"]), prefix={"tokens": 32, "count": 2})
    a = [traffic.serve_request(mix, conf, SEEDS[2], i)[0] for i in range(4)]
    assert np.array_equal(a[0][:32], a[2][:32]) and np.array_equal(a[1][:32], a[3][:32])
    assert not np.array_equal(a[0][:32], a[1][:32])
    b = traffic.serve_request(mix, conf, SEEDS[1], 0)[0]
    assert not np.array_equal(a[0][:32], b[:32])


def test_pool_does_not_fit_more_than_it_holds():
    """The pool holds what the clients reserve (eager admission reserves a
    request's prompt and output at once), with room for the tail, and a
    row at the block table's reach."""
    for cell in SERVE:
        mix = traffic.load(cell["traffic"])
        conf = spec.config(cell["config"])
        pages = mix["pages"]
        usable = pages["num_pages"] - 1
        assert pages["max_pages_per_seq"] <= usable
        need = [-(-(len(t) + o) // pages["page_size"])
                for t, o in (traffic.serve_request(mix, conf, 5, i)
                             for i in range(8 * mix["clients"]))]
        assert pages["max_batch"] == mix["clients"]
        assert mix["clients"] * np.mean(need) <= 0.8 * usable
