"""The general generator: every traffic mix is a JSON file of parameters
under ``bench/mixes/``, and this module makes a run's inputs from it and
from ``--seed``. It imports nothing of the program.

Training mixes (``"kind": "train"``) give the batch, the sequence length
and the token statistics; a batch is a pure function of (seed, index):
Zipf-distributed ids with local copies (a copy of ``data/synthetic.py``'s
``_zipf_tokens``) as tokens and labels, and, for a configuration with a
frontend, N(0, 1) frame embeddings of its ``frontend_dim``.

Serving mixes (``"kind": "serve"``) give a closed loop of clients and
lognormal prompt and output lengths, clipped. Each request's two lengths
are drawn from (seed, index), stratified: the stream runs in blocks of as
many requests as there are clients, and in each block every one of
``clients`` equal-probability strata of each lognormal gives one draw, in
an order the seed shuffles (prompt and output apart). A block, about what
the clients hold at one time, thus holds the distributions' whole range,
the clip included, and two seeds send other lengths with nearly the same
total work. The seed also draws every prompt's tokens. A mix with
``"prefix": {"tokens": L, "count": K}`` starts request i's prompt with the
(i mod K)-th of K shared prefixes of L tokens, drawn from the seed (a
system prompt a session shares); the lognormal then gives the rest.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

MIXES = Path(__file__).resolve().parent / "mixes"


def load(name: str) -> dict:
    """The mix ``name`` (``bench/mixes/<name>.json``)."""
    return json.loads((MIXES / f"{name}.json").read_text())


def _rs(seed: int, stream: int, index: int) -> np.random.RandomState:
    return np.random.RandomState(
        (int(seed) * 1_000_003 + stream * 7919 + index) % (2 ** 31 - 1))


def zipf_tokens(rs: np.random.RandomState, shape, vocab: int, a: float,
                copy_p: float) -> np.ndarray:
    """Zipf(a) ranks folded into the vocabulary; with probability copy_p a
    token repeats the one before it."""
    toks = (rs.zipf(a, size=shape).astype(np.int64) - 1) % vocab
    rep = rs.rand(*shape) < copy_p
    toks = np.where(rep, np.roll(toks, 1, axis=-1), toks)
    return toks.astype(np.int32)


def train_batch(mix: dict, config: dict, seed: int, index: int) -> Dict[str, np.ndarray]:
    """Host batch ``index`` of a training mix: {"tokens", "labels"} or,
    with a frontend, {"embeds", "labels"}."""
    rs = _rs(seed, 1, index)
    shape = (mix["batch"], mix["seq_len"])
    labels = zipf_tokens(rs, shape, config["vocab_size"], mix["zipf_a"],
                         mix["copy_p"])
    if not config.get("frontend"):
        return {"tokens": labels, "labels": labels}
    embeds = rs.randn(*shape, config["frontend_dim"]).astype(np.float32)
    return {"embeds": embeds, "labels": labels}


def _lognormal_at(spec: dict, u: float) -> int:
    u = min(max(u, 1e-12), 1.0 - 1e-12)
    x = spec["median"] * math.exp(spec["sigma"] * statistics.NormalDist().inv_cdf(u))
    return int(min(spec["max"], max(spec["min"], round(x))))


def _stratified(spec: dict, seed: int, stream: int, index: int, n: int) -> int:
    """Request ``index``'s draw from the clipped lognormal ``spec``: the
    stratum its block's shuffle gives it, of n, and a uniform point in it."""
    block, j = divmod(index, n)
    stratum = _rs(seed, stream, block).permutation(n)[j]
    return _lognormal_at(spec, (stratum + _rs(seed, stream + 1, index).rand()) / n)


def serve_request(mix: dict, config: dict, seed: int, index: int,
                  warmup: bool = False) -> Tuple[np.ndarray, int]:
    """Request ``index`` of the seed's stream: (prompt tokens int32, output
    length). ``warmup``: of the warm-up stream instead, whose lengths are
    the same for every seed (set-up does the same work)."""
    size_seed = 0 if warmup else seed
    n = mix["clients"]
    prompt_len = _stratified(mix["prompt"], size_seed, 6, index, n)
    out_len = _stratified(mix["output"], size_seed, 8, index, n)
    tokens = zipf_tokens(_rs(seed, 4 if warmup else 3, index), (prompt_len,),
                         config["vocab_size"], mix["zipf_a"], mix["copy_p"])
    shared = mix.get("prefix")
    if shared:
        head = zipf_tokens(_rs(seed, 10, index % shared["count"]), (shared["tokens"],),
                           config["vocab_size"], mix["zipf_a"], mix["copy_p"])
        tokens = np.concatenate([head, tokens])
    return tokens, out_len
