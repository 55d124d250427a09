"""Synthetic data pipeline (counterpart of ``repro.data.synthetic``; numpy
only, batch for batch identical to it).

Deterministic and restart-safe: a batch is a pure function of (seed, step),
so a resumed run consumes the identical stream. The tokens are a Zipf-like
mixture with copy structure, so the LM loss falls during a run. Batches are
host numpy arrays; the trainer moves them to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """What a batch holds; fields as in ``repro.data.DataConfig``.

    pack: each row packs several short documents back to back, and batches
    gain ``segment_ids`` (per-token document id, non-decreasing along the
    row) and ``positions`` (restarting at every document).
    """
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: Optional[str] = None   # None → token LM; vision/audio → embeds
    frontend_dim: int = 1024
    pack: bool = False
    min_seg_len: int = 16
    max_seg_len: int = 64


def _zipf_tokens(rs: np.random.RandomState, shape, vocab):
    """Zipf-distributed ids with local copy structure (learnable signal)."""
    ranks = rs.zipf(1.3, size=shape).astype(np.int64)
    toks = (ranks - 1) % vocab
    # copy structure: with p=0.3, token t+1 repeats token t (bigram signal)
    rep = rs.rand(*shape) < 0.3
    toks_shift = np.roll(toks, 1, axis=-1)
    toks = np.where(rep, toks_shift, toks)
    return toks.astype(np.int32)


def _pack_layout(rs: np.random.RandomState, batch: int, seq_len: int,
                 min_len: int, max_len: int):
    """Per-row packing: segment ids (0, 1, 2, … non-decreasing) and
    per-segment positions. Rows are filled exactly (the last document is
    cut), so there is no padding; padding elsewhere uses negative ids."""
    if not 1 <= min_len <= max_len:
        raise ValueError(f"packing needs 1 <= min_seg_len <= max_seg_len, "
                         f"got {min_len}..{max_len}")
    seg_ids = np.zeros((batch, seq_len), np.int32)
    positions = np.zeros((batch, seq_len), np.int32)
    for i in range(batch):
        t, sid = 0, 0
        while t < seq_len:
            n = min(int(rs.randint(min_len, max_len + 1)), seq_len - t)
            seg_ids[i, t:t + n] = sid
            positions[i, t:t + n] = np.arange(n)
            t += n
            sid += 1
    return seg_ids, positions


def make_batch(cfg: DataConfig, step: int):
    """Pure function of (cfg.seed, step) → host numpy batch."""
    rs = np.random.RandomState((cfg.seed * 1_000_003 + step) % (2**31 - 1))
    shape = (cfg.global_batch, cfg.seq_len)
    labels = _zipf_tokens(rs, shape, cfg.vocab_size)
    if cfg.frontend is None:
        batch = {"tokens": labels, "labels": labels}
        if cfg.pack:
            seg_ids, positions = _pack_layout(
                rs, cfg.global_batch, cfg.seq_len,
                cfg.min_seg_len, cfg.max_seg_len)
            batch["segment_ids"] = seg_ids
            batch["positions"] = positions
        return batch
    if cfg.pack:
        raise ValueError("sequence packing is token-LM only (no frontends)")
    embeds = rs.randn(cfg.global_batch, cfg.seq_len,
                      cfg.frontend_dim).astype(np.float32)
    return {"embeds": embeds, "labels": labels}


def batch_iterator(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    """``make_batch(cfg, step)`` for step = start_step, start_step + 1, …"""
    step = start_step
    while True:
        yield make_batch(cfg, step)
        step += 1
