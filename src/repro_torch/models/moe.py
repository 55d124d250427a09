"""Mixture-of-experts FFN of the port (counterpart of ``repro.models.moe``):
GShard-style capacity dispatch, decision for decision as JAX's.

Tokens are flattened ``b·s`` in row-major order and cut into groups of the
largest divisor of their count that is at most ``group_size``. The router
runs in f32 (its weight is f32 in every model dtype); each token takes its
top ``k`` experts, ties toward the lower index as ``jax.lax.top_k`` breaks
them, and the gates are renormalised over the k. A choice's place in its
expert's queue counts the earlier choices of that expert in its group in
(token, choice) order; a choice at or past the capacity is dropped (its
gate zeroed, not renormalised again). Each expert computes its gated-SiLU
FFN over its ``capacity`` slots of every group, filled or not, as JAX's
dispatch einsums do; here the slots are filled by an index scatter and read
back by a gather, which moves the same rows. ``shared`` experts (deepseek-
moe) run as one dense gated MLP on every token.

JAX computes all of this outside any Pallas kernel, so it is plain torch.
``moe_reference`` is the dense per-expert oracle of the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers


class MoE(nn.Module):
    """Expert weights: ``router [d, E]`` (always f32), ``wi [E, d, 2f]``
    (gate | up on the last axis), ``wo [E, f, d]`` and, with shared experts,
    ``shared``: a gated :class:`~repro_torch.models.layers.MLP` of width
    ``num_shared_experts · f``."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
        self.router = layers._param((d, e), torch.float32, device)
        self.wi = layers._param((e, d, 2 * f), dtype, device)
        self.wo = layers._param((e, f, d), dtype, device)
        self.shared = (layers.MLP(d, m.num_shared_experts * f, dtype, device)
                       if m.num_shared_experts else None)


@torch.no_grad()
def init_moe(gen: torch.Generator, cfg, dtype, keep=None) -> MoE:
    """A :class:`MoE` with JAX's scales (``N(0, 1)`` times ``d**-0.5`` for
    the router and ``wi``, ``f**-0.5`` for ``wo``; the shared experts'
    ``dense_init``), drawn in f32 on the generator's device (``keep``: as
    ``layers.fill_``'s)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    width = m.num_shared_experts * f

    def draws():
        yield "router", layers.dense_init(gen, d, e, torch.float32)
        for name, shape, scale in (("wi", (e, d, 2 * f), d ** -0.5),
                                   ("wo", (e, f, d), f ** -0.5)):
            yield name, torch.randn(shape, generator=gen, dtype=torch.float32,
                                    device=gen.device).mul_(scale)
        if m.num_shared_experts:
            yield "shared.wi", layers.dense_init(gen, d, 2 * width, dtype)
            yield "shared.wo", layers.dense_init(gen, width, d, dtype)

    return layers.fill_(MoE(cfg, dtype, gen.device if keep is None else "meta"),
                        draws(), keep)


def capacity(group_size: int, num_experts: int, top_k: int,
             factor: float) -> int:
    """Slots an expert has in a group: ``int(g·k·factor / E)`` rounded up to
    a multiple of 8, at least 8 (JAX's arithmetic)."""
    c = int(group_size * top_k * factor / num_experts)
    return max(8, (c + 7) // 8 * 8)


def group_size(n_tok: int, configured: int) -> int:
    """The largest divisor of ``n_tok`` that is at most ``configured``."""
    g = min(configured, n_tok)
    while n_tok % g:
        g -= 1
    return g


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, ties toward
    the lower index (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def one_hot(idx, n: int):
    """``F.one_hot(idx, n)`` without its check of the classes, which reads
    them on the host (a device sync a call, once an MoE layer)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def queue_positions(idx, g_sz: int, num_experts: int):
    """idx [n, k] → each choice's place in its expert's queue in its group
    of ``g_sz`` tokens: the count of earlier choices of that expert in
    (token, choice) order, earlier tokens first."""
    n, k = idx.shape
    choice = idx.reshape(n // g_sz, g_sz * k)
    onehot = one_hot(choice, num_experts)
    pos = (onehot.cumsum(1) - onehot).gather(2, choice[..., None])
    return pos.reshape(n, k)


def route(logits, m, g_sz: int):
    """The routing of router ``logits [n, E]`` (f32) in groups of
    ``g_sz``: (probs [n, E], gates [n, k] renormalised then zeroed where
    dropped, idx [n, k], keep [n, k] bool, pos [n, k] each choice's place in
    its expert's queue, capacity)."""
    e, k = m.num_experts, m.top_k
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = capacity(g_sz, e, k, m.capacity_factor)
    pos = queue_positions(idx, g_sz, e)
    keep = pos < cap
    return probs, gates * keep, idx, keep, pos, cap


def apply_moe(p: MoE, x, ctx: layers.Ctx, cfg, *, metrics: bool = True):
    """x [B, S, d] → (out [B, S, d], {"moe_aux", "moe_dropped"}): the
    routed experts' gated sum, plus the shared experts; the Switch
    load-balance loss ``E · mean_g Σ_e density · router_mean`` (density from
    the choices, without gradient) and the fraction of choices dropped.
    With ``metrics=False`` the second item is ``{}`` and neither is
    computed (the serving steps, which drop them as JAX's jitted steps
    drop them as dead code).

    On a training mesh (``ctx.plan``; ``x`` this rank's rows) the groups
    are the global microbatch's: ``group_size`` of the global token count;
    a rank routes its own groups where they hold whole groups, else every
    group (its tokens gathered over the batch axes; it keeps its rows of
    the output). Under expert parallelism the router's logits are gathered
    over ``model``, the rank runs its experts on their slots and the
    output is summed over ``model``; the shared experts are tensor-parallel
    as ``layers.apply_mlp``. The metrics are global: ``moe_aux`` the sum of
    every rank's share (its gradient the share's: the term enters the loss
    once), ``moe_dropped`` the global kept count over the global
    choices. Under ``ctx.seq`` (``x`` this rank's rows) the rows are
    gathered over ``model`` before dispatch, so the groups, the capacity
    and the routes are those without it; the combined output is
    reduce-scattered to the rank's rows (cut to them without expert
    parallelism, every model rank then routing alike and taking a share of
    ``moe_aux``); the shared experts run as ``layers.apply_mlp`` under
    ``seq``."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    plan = ctx.plan
    seq = ctx.seq
    ep = plan is not None and plan.experts
    xs = plan.gather_seq(x) if seq else x           # every row under seq
    b, s, d = xs.shape
    tokens = xs.reshape(b * s, d)
    n_own = tokens.shape[0]
    n_all = n_own * (1 if plan is None else plan.batch_ranks)
    g_sz = group_size(n_all, m.group_size)
    spans = n_own % g_sz != 0          # a group spans batch ranks (a mesh)
    if spans:
        tokens = plan.gather_batch(tokens)
    if plan is not None and not seq:
        tokens = plan.enter(tokens, ep)
    n = tokens.shape[0]
    n_g = n // g_sz
    logits = tokens.float() @ layers.weight(ctx, p.router, "mlp.router")
    probs, gates, idx, keep, pos, cap = route(
        plan.expert_logits(logits) if ep else logits, m, g_sz)

    # slot (expert, group, place) of each kept choice of this rank's experts
    # (e_loc from e0; all of them on one device) in a buffer
    # [e_loc, n_g·cap, d]; the other choices go to one trailing row, cut off
    e_loc, e0 = (e, 0) if plan is None else (plan.experts_local,
                                             plan.expert_offset)
    mine = keep if e_loc == e else keep & (idx >= e0) & (idx < e0 + e_loc)
    n_slots = e_loc * n_g * cap
    grp = (torch.arange(n, device=x.device) // g_sz)[:, None]
    slot = (idx - e0) * (n_g * cap) + grp * cap + pos
    dest = torch.where(mine, slot, n_slots).reshape(-1)
    xe = tokens.new_zeros(n_slots + 1, d).index_add(
        0, dest, tokens.repeat_interleave(k, dim=0))[:n_slots]
    h = torch.bmm(xe.view(e_loc, n_g * cap, d),
                  layers.weight(ctx, p.wi, "mlp.wi"))
    g, u = h.chunk(2, dim=-1)
    ye = torch.bmm(F.silu(g) * u,
                   layers.weight(ctx, p.wo, "mlp.wo")).view(n_slots, d)
    # the combine: each token's choices of these experts, weighted by their
    # gates (another choice reads slot 0 with gate 0)
    yk = ye[torch.where(mine, slot, 0)]                          # [n, k, d]
    w = gates if e_loc == e else gates * mine
    out = torch.bmm(w.to(x.dtype)[:, None], yk)[:, 0]
    if spans:
        out = plan.own_rows(out, n_own)
    out = out.view(b, s, d)
    if plan is not None:
        out = plan.leave(out, ep, seq)
    if p.shared is not None:
        out = out + layers.apply_mlp(p.shared, x, ctx, "mlp.shared.")
    if not metrics:
        return out, {}

    density = one_hot(idx, e).sum(1).float().view(n_g, g_sz, e).mean(1)
    router_mean = probs.view(n_g, g_sz, e).mean(1)
    balance = (density * router_mean).sum(-1)
    kept = keep.sum()
    if plan is None:
        aux = e * balance.mean()
    else:
        aux = plan.moe_sum(e * balance.sum()
                           / (n_all // g_sz * plan.moe_share(spans, seq)), seq)
        if not spans:
            kept = plan.batch_sum_(kept)
    return out, {"moe_aux": aux, "moe_dropped": 1.0 - kept / (n_all * k)}


def moe_reference(p: MoE, x, cfg):
    """Dense per-expert loop without capacity (the tests' oracle): every
    expert on every token, weighted by the renormalised top-k gates."""
    m = cfg.moe
    b, s, d = x.shape
    tokens = x.reshape(b * s, d).float()
    probs = torch.softmax(tokens @ p.router, dim=-1)
    gates, idx = top_k(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(tokens)
    for ex in range(m.num_experts):
        g, u = (tokens @ p.wi[ex].float()).chunk(2, dim=-1)
        y = (F.silu(g) * u) @ p.wo[ex].float()
        w = torch.where(idx == ex, gates, 0.0).sum(-1)
        out = out + w[:, None] * y
    out = out.view(b, s, d).to(x.dtype)
    if p.shared is not None:
        out = out + layers.apply_mlp(p.shared, x)
    return out
