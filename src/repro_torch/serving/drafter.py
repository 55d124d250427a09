"""Draft proposers + the greedy acceptance rule for speculative decoding.

Decode is latency-bound at batch 1: every step re-reads the whole weight/KV
working set from HBM to emit ONE token.  Speculative decoding drafts ``k``
cheap candidate tokens per sequence and verifies them all in a single
verify-k model call (``lm.paged_verify_step``), so one pass over the weights
can emit up to ``k + 1`` tokens.  Greedy verification makes the output
token-identical to plain single-step decode *by construction*: a draft is
accepted only where it equals the argmax the model itself would have
produced, and the first mismatch position falls back to that argmax.

This module is pure host-side numpy — no model, no device arrays:

* :class:`NgramDrafter` — prompt-lookup drafting (no second model): the last
  ``n``-gram of a row's token history (prompt + generated) is searched for a
  previous occurrence, and the tokens that followed it are proposed.  Agent
  traces, code and retrieval-augmented prompts repeat themselves, which is
  exactly when decode batches are small and the speedup matters.
* :func:`longest_accept` — the acceptance rule, factored out pure so the
  property tests can fuzz it against an oracle re-check.

The engine wires these into the serving loop via
``ServingEngine(speculate_k=...)``; see docs/serving.md.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class NgramDrafter:
    """Prompt-lookup drafter: propose the continuation of the most recent
    earlier occurrence of the history's trailing n-gram.

    For ``n`` from ``max_ngram`` down to ``min_ngram``, the last ``n`` tokens
    of the history are matched against every earlier position; the *most
    recent* earlier match wins (recency tracks the current generation loop
    better than the first occurrence), and the tokens that followed it are
    proposed, up to ``k``.  No match at any ``n`` proposes nothing — the
    verify step then degenerates to a plain decode step for that row.

    Proposals are a pure function of the history (deterministic) and are
    drawn *from* the history, so they are always in-vocab — both properties
    are fuzz-tested in tests/test_speculative.py.
    """

    def __init__(self, k: int, max_ngram: int = 3, min_ngram: int = 1):
        """k: max tokens proposed per call.  max_ngram/min_ngram: the match
        lengths tried, longest first (longer matches are more specific, so
        their continuations are likelier to be accepted)."""
        if k < 1:
            raise ValueError(f"drafter needs k >= 1, got {k}")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"{min_ngram}..{max_ngram}")
        self.k = k
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, history: np.ndarray, max_tokens: int = -1) -> np.ndarray:
        """Draft up to ``min(k, max_tokens)`` tokens continuing ``history``
        (the row's prompt + everything generated so far).  Returns an int32
        array, possibly empty (no n-gram recurrence found)."""
        history = np.asarray(history, np.int32)
        limit = self.k if max_tokens < 0 else min(self.k, max_tokens)
        n_hist = int(history.shape[0])
        if limit < 1 or n_hist < self.min_ngram + 1:
            return np.zeros(0, np.int32)
        for n in range(min(self.max_ngram, n_hist - 1), self.min_ngram - 1,
                       -1):
            pattern = history[n_hist - n:]
            # candidate start positions strictly before the trailing n-gram
            # itself; scan from the most recent backwards
            windows = np.lib.stride_tricks.sliding_window_view(
                history[:n_hist - 1], n)
            hits = np.nonzero((windows == pattern).all(axis=1))[0]
            if hits.size:
                start = int(hits[-1]) + n
                return history[start:start + limit].copy()
        return np.zeros(0, np.int32)


def longest_accept(draft: np.ndarray, greedy: np.ndarray
                   ) -> Tuple[int, List[int]]:
    """The speculative acceptance rule, pure and oracle-checkable.

    ``draft`` holds the ``k`` proposed tokens; ``greedy[j]`` is the argmax
    the verify pass produced at drafted position ``j`` — i.e. the token a
    plain greedy decode would emit after consuming ``draft[:j]`` (``greedy``
    has ``k + 1`` entries: one per drafted position plus the bonus token
    scored after the last draft).  Returns ``(accepted, emitted)`` where
    ``accepted`` is the length of the longest prefix with
    ``draft[j] == greedy[j]`` and ``emitted = greedy[:accepted + 1]`` — the
    accepted drafts (which *are* the greedy tokens, by the match) plus the
    model's own token at the first mismatch (or the bonus token when every
    draft survived).  ``k = 0`` degenerates to exactly one plain decode
    step: nothing accepted, ``emitted = [greedy[0]]``.
    """
    draft = np.asarray(draft, np.int32)
    greedy = np.asarray(greedy, np.int32)
    k = int(draft.shape[0])
    assert greedy.shape[0] == k + 1, \
        f"verify must score k+1 positions, got {greedy.shape[0]} for k={k}"
    accepted = 0
    while accepted < k and draft[accepted] == greedy[accepted]:
        accepted += 1
    return accepted, [int(t) for t in greedy[:accepted + 1]]
