"""Recording and replaying the MoE router's expert choices, to compare two
runs of one model whose attention differs by rounding (the kernel impl and
the torch impl): a 1e-6 change in a token's router input can swap its k-th
and (k+1)-th expert where they nearly tie, and such a flip moves that token's
output far more than the rounding did.

A choice counts as flipped when the expert it names is not among the other
run's choices for that token, whatever their order: top ``{2, 3, 4}`` against
``{1, 2, 3}`` is one flip.
"""

from __future__ import annotations

from repro_torch.models import moe


def _missing(idx, other):
    """[tokens]: the choices of ``idx [tokens, k]`` that ``other [tokens,
    k]`` did not make for the same token."""
    return (idx[:, :, None] != other[:, None, :]).all(-1).sum(-1)


class RouteRecorder:
    """While installed (``with``), wraps ``moe.top_k`` (called once an MoE
    layer a forward): keeps every call's expert indices [tokens, k] in
    ``calls``. With ``replay`` (another run's ``calls``), routes each call as
    that run routed its call of the same index, the gates this run's
    probabilities of those experts, and counts in ``flips`` / ``decisions``
    the choices this run would have made otherwise. ``part`` (i, n): this
    run is a training mesh's rank, which routes the i-th of n equal shares
    of a replayed call's tokens where its call has 1/n of them (its own
    groups; a call of all of them replays all). The model has no flag for
    this: the module's function is swapped and restored."""

    def __init__(self, replay=None, part=(0, 1)):
        self.replay, self.part, self.calls = replay, part, []
        self.flips = self.decisions = 0

    def __enter__(self):
        self.top_k, moe.top_k = moe.top_k, self._top_k
        return self

    def __exit__(self, *exc):
        moe.top_k = self.top_k

    def _top_k(self, probs, k):
        vals, idx = self.top_k(probs, k)
        self.calls.append(idx.clone())
        if self.replay is None:
            return vals, idx
        forced = self.replay[len(self.calls) - 1]
        if forced.shape[0] != idx.shape[0]:
            i, n = self.part
            rows = forced.shape[0] // n
            forced = forced[i * rows:(i + 1) * rows]
        self.flips += int(_missing(idx, forced).sum())
        self.decisions += idx.numel()
        return probs.gather(-1, forced), forced


def route_diff(moe_cfg, a, b):
    """Two runs' routes of one MoE layer, a and b [tokens, k] → (choices of
    a that b did not make, per-token mask of the tokens routed otherwise:
    another expert set, or another set kept under the capacity, which a
    changed choice earlier in the group moves)."""
    n, k = a.shape
    e = moe_cfg.num_experts
    g = moe.group_size(n, moe_cfg.group_size)
    cap = moe.capacity(g, e, k, moe_cfg.capacity_factor)
    missing = _missing(a, b)

    def kept(x):
        return x.where(moe.queue_positions(x, g, e) < cap, -1).sort(-1).values

    changed = (missing > 0) | (kept(a) != kept(b)).any(-1)
    return int(missing.sum()), changed


def dropped_fraction(moe_cfg, calls) -> float:
    """``moe_dropped`` of a forward from its layers' routes: the fraction of
    choices past their expert's capacity, averaged over the layers."""
    out = []
    for idx in calls:
        n, k = idx.shape
        g = moe.group_size(n, moe_cfg.group_size)
        cap = moe.capacity(g, moe_cfg.num_experts, k, moe_cfg.capacity_factor)
        pos = moe.queue_positions(idx, g, moe_cfg.num_experts)
        out.append(1.0 - float((pos < cap).float().mean()))
    return sum(out) / len(out)
