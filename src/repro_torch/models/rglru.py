"""RG-LRU recurrent block of the port (counterpart of ``repro.models.rglru``;
Griffin / RecurrentGemma, arXiv:2402.19427).

The recurrence  h_t = a_t ⊙ h_{t-1} + √(1-a_t²) ⊙ (i_t ⊙ x_t)  is an
elementwise gated linear scan with no QKᵀ or softmax, so no attention kernel
applies: it is plain torch, as the JAX block is plain JAX. Prefill runs the
scan in O(log S) elementwise steps (:func:`_linear_scan`, the counterpart of
``jax.lax.associative_scan``); decode is one state update.

Block layout (Griffin recurrent block):
  x → [linear → conv1d(4) → RG-LRU]  ⊙  [linear → gelu]  → linear out

Serving state: a contiguous cache holds ``{"h": [B, Dr] f32, "conv":
[B, 3, Dr] f32}`` per layer; a paged one the same with ``max_batch + 1``
rows, the last a *trash row* that absorbs padding tokens' gathers and
non-end scatters, as the page pool's trash page does. Unlike the JAX block,
which returns new arrays, the caches are updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers

_C = 8.0  # Griffin's fixed exponent scale for a_t


class RGLRU(nn.Module):
    """The recurrent mixer's weights: ``wx, wg [d, Dr]``, ``wo [Dr, d]``, the
    depthwise ``conv [4, Dr]``, the gates ``w_inp, w_rec [Dr, Dr]`` and
    ``lambda [Dr]`` (f32, registered under JAX's leaf name, a Python
    keyword)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, dr = cfg.d_model, cfg.rglru.d_rnn
        self.wx = layers._param((d, dr), dtype, device)
        self.wg = layers._param((d, dr), dtype, device)
        self.wo = layers._param((dr, d), dtype, device)
        self.conv = layers._param((4, dr), dtype, device)
        self.w_inp = layers._param((dr, dr), dtype, device)
        self.w_rec = layers._param((dr, dr), dtype, device)
        self.register_parameter("lambda", layers._param((dr,), torch.float32,
                                                        device))


@torch.no_grad()
def init_rglru(gen: torch.Generator, cfg, dtype, keep=None) -> RGLRU:
    """An :class:`RGLRU` with JAX's shapes and scales: ``dense_init``
    matrices, conv ``N(0, 1) · 0.1`` and Λ = softplus⁻¹(−log(a) / c) for
    a ~ U(0.9, 0.999), so that the retention at r = 1 lies in (0.9, 0.999)
    (``keep``: as ``layers.fill_``'s)."""
    d, dr = cfg.d_model, cfg.rglru.d_rnn

    def draws():
        for name, (d_in, d_out) in (("wx", (d, dr)), ("wg", (d, dr)),
                                    ("wo", (dr, d)), ("w_inp", (dr, dr)),
                                    ("w_rec", (dr, dr))):
            yield name, layers.dense_init(gen, d_in, d_out, dtype)
        yield "conv", torch.randn((4, dr), generator=gen, device=gen.device) * 0.1
        lam = torch.rand((dr,), generator=gen, device=gen.device) * 0.099 + 0.9
        yield "lambda", torch.log(torch.expm1(-torch.log(lam) / _C))

    return layers.fill_(RGLRU(cfg, dtype, gen.device if keep is None else "meta"),
                        draws(), keep)


def init_rglru_cache(cfg, batch: int, device, channels=None):
    """Zero state rows: ``h [batch, Dr]`` and ``conv [batch, 3, Dr]``, f32
    (``channels`` in place of Dr: a mesh rank's share of them)."""
    dr = channels or cfg.rglru.d_rnn
    return {"h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, 3, dr), dtype=torch.float32,
                                device=device)}


def _conv1d_causal(x, w, state=None):
    """Depthwise causal conv over time. x [B,S,D], w [K,D]; state (decode)
    [B, K-1, D] the previous inputs. Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
        xp = torch.cat([pad, x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return y, xp[:, -(k - 1):]


# ---------------------------------------------------------------------------
# packed per-slot state routing (paged serving prefill)
#
# A packed prefill row holds one or more prompt spans back to back (then
# padding). The state resets at every span start; a span that resumes a
# sequence mid-prompt (chunked prefill) resumes from the state its slot's
# row stored after the previous chunk. State rows are [n_slots + 1, ...],
# the last the trash row.
# ---------------------------------------------------------------------------

def _packed_seg(paged, positions):
    """Per-token span fields from the paged routing dict:
    ``paged["state_slots"] [B,S]`` each token's decode slot (-1 padding),
    ``paged["state_local"] [B,S]`` its offset in its span. Returns (slots,
    local, is_start, inject, is_end): the span-start mask, the carried-state
    injection mask (span starts that resume past global position 0) and the
    span-end mask (the token whose state is scattered back)."""
    slots = paged["state_slots"].long()
    local = paged["state_local"].long()
    positions = torch.broadcast_to(positions, slots.shape).long()
    live = slots >= 0
    is_start = live & (local == 0)
    cont = live & (positions - local > 0)     # the span resumes mid-sequence
    nxt = torch.cat([slots[:, 1:], torch.full_like(slots[:, :1], -1)], dim=1)
    is_end = live & (slots != nxt)
    return slots, local, is_start, is_start & cont, is_end


def _rows(slots, n_rows: int):
    """Slot ids as row indices: padding (-1) → the trash row ``n_rows - 1``."""
    return torch.where(slots >= 0, slots, n_rows - 1)


def _conv1d_causal_packed(x, w, state, slots, local, positions):
    """Packed multi-span depthwise causal conv with per-slot carried state.

    x [B,S,D]; w [K,D]; state [n_slots+1, K-1, D] (state[j] holds the input
    at lag K-1-j before the span start). A lag-l read stays in the row while
    ``local >= l``, falls back to the slot's carried state for continuation
    spans, and is zero for a fresh span. Returns (y, lags), lags[l] each
    token's lag-l input."""
    k, s = w.shape[0], x.shape[1]
    cont = ((slots >= 0) & (positions - local > 0))[..., None]
    rows = _rows(slots, state.shape[0])
    lags = [x]
    for lag in range(1, k):
        in_row = F.pad(x, (0, 0, lag, 0))[:, :s]
        j = torch.clamp(k - 1 - lag + local, 0, k - 2)
        carried = state[rows, j].to(x.dtype)
        lags.append(torch.where((local >= lag)[..., None], in_row,
                                torch.where(cont, carried, torch.zeros_like(x))))
    y = sum(w[k - 1 - lag] * lags[lag] for lag in range(k))
    return y, lags


def _conv_state_of(lags):
    """Per-token lag values as conv-state rows [B,S,K-1,D] (row j = lag
    K-2-j: what the next token's conv needs)."""
    k = len(lags)
    return torch.stack([lags[k - 2 - j] for j in range(k - 1)], dim=2)


def _scatter_state(state, values, slots, is_end):
    """Write per-token values [B,S,...] into state rows [n_slots+1, ...] in
    place at span-end tokens; every other token lands on the trash row. At
    most one span a slot per call, so a real row sees at most one write."""
    idx = _rows(torch.where(is_end, slots, -1), state.shape[0]).reshape(-1)
    state[idx] = values.reshape((-1,) + tuple(values.shape[2:])).to(state.dtype)


def _linear_scan(a, b):
    """h_t = a_t · h_{t-1} + b_t over axis 1 from h_{-1} = 0, for [B,S,D]
    tensors: the doubling form of the associative scan (log2 S steps, each
    folding the prefix that ends ``shift`` tokens back)."""
    shift = 1
    while shift < a.shape[1]:
        b = torch.cat([b[:, :shift], b[:, shift:] + a[:, shift:] * b[:, :-shift]],
                      dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def _gate_norm(u):
    """√max(u, 1e-12) for u = 1 − a_t². ``torch.maximum`` splits the
    gradient at a tie as ``jnp.maximum`` does (``clamp`` would pass all of
    it to u)."""
    return torch.sqrt(torch.maximum(u, u.new_tensor(1e-12)))


def _gates(lam, r):
    """a_t = exp(−c · softplus(Λ) · r_t) (in (0, 1]) and √(1 − a_t²)."""
    a = torch.exp(-_C * F.softplus(lam) * r)
    return a, _gate_norm(1.0 - a * a)


def _rglru_scan(x, r, i, lam):
    """x, r, i [B,S,D] f32 → h [B,S,D] from a zero state."""
    a, norm = _gates(lam, r)
    return _linear_scan(a, norm * (i * x))


def _rglru_step(x, r, i, lam, h_prev):
    """One step: x, r, i, h_prev [B,D] f32 → h [B,D]."""
    a, norm = _gates(lam, r)
    return a * h_prev + norm * (i * x)


def _rglru_scan_packed(x, r, i, lam, h_init, is_start, inject):
    """The multi-span scan: :func:`_rglru_scan` with the recurrence reset at
    span starts (a_t zeroed there) and continuation spans resuming from
    ``h_init`` [B,S,D] (their slot's stored state, gathered per token), added
    as a_t · h_init into the injected start's source term, which is the
    sequential step exactly."""
    a, norm = _gates(lam, r)
    gated = norm * (i * x) + inject.float()[..., None] * a * h_init
    return _linear_scan(a * (~is_start).float()[..., None], gated)


def apply_rglru(p: RGLRU, x, ctx: layers.Ctx, cfg, *, cache=None,
                positions=None, paged=None):
    """x [B, S, d] → (out [B, S, d], cache or None).

    cache (serving): ``{"h", "conv"}`` state rows, updated in place. paged:
    the per-slot state protocol, rows [n_slots+1, ...]. Prefill routes spans
    through ``paged["state_slots"]`` / ``["state_local"]`` (the packed scan
    with zero or carried initial state, span-end states scattered back);
    decode updates rows [:B] where ``paged["kv_len"] > 0``, so masked and
    inactive slots keep their state.

    On a mesh (``ctx.plan``) whose ``model`` axis splits the channels (the
    state rows then hold the rank's channels): ``wx``/``wg`` column-parallel, the conv, the gates' Λ and
    the scan on this rank's channels, ``w_inp``/``w_rec`` its rows (the
    rules shard their first ``rnn`` dim only), so the gates' products are
    partial sums, summed over ``model`` and cut to its channels; ``wo``
    row-parallel and summed.

    Under ``ctx.seq`` (``x`` this rank's rows) the rows are gathered over
    ``model`` before the in-projections, the conv and the scan run on the
    rank's channels (all of them where ``model`` does not split them) over
    the whole sequence, and the out-projection's partial sums are
    reduce-scattered to the rank's rows (cut to them where not split)."""
    plan = ctx.plan
    split = plan is not None and plan.rnn
    if plan is not None:
        x = plan.enter(x, split, ctx.seq)
    b, s, _ = x.shape
    lam = getattr(p, "lambda")
    xr = x @ layers.weight(ctx, p.wx, "rec:mixer.wx")         # recurrence branch
    gate = F.gelu(x @ layers.weight(ctx, p.wg, "rec:mixer.wg"),
                  approximate="tanh")              # gate branch (jax.nn.gelu)

    def gates_of(xr):
        xf = xr.float()
        r, i = xf @ p.w_rec.float(), xf @ p.w_inp.float()
        if split:
            r, i = plan.scatter(torch.stack([r, i])).unbind(0)
        return xf, torch.sigmoid(r), torch.sigmoid(i)

    if paged is not None:
        if cache is None:
            raise ValueError("paged serving always threads state rows")
        hs, convs = cache["h"], cache["conv"]
        if ctx.decode:
            xr, new_conv = _conv1d_causal(xr, p.conv, convs[:b])
            xf, r, i = gates_of(xr)
            h = _rglru_step(xf[:, 0], r[:, 0], i[:, 0], lam, hs[:b])
            live = (paged["kv_len"] > 0)[:, None]
            hs[:b] = torch.where(live, h, hs[:b])
            convs[:b] = torch.where(live[:, None], new_conv.to(convs.dtype),
                                    convs[:b])
            h = h[:, None, :]
        else:
            if "state_slots" not in paged:
                raise ValueError(
                    "recurrent paged prefill needs state routing: pass "
                    "state_slots/state_local (lm.paged_prefill/"
                    "paged_chunk_prefill)")
            slots, local, is_start, inject, is_end = _packed_seg(paged,
                                                                 positions)
            pos = torch.broadcast_to(positions, slots.shape).long()
            xr, lags = _conv1d_causal_packed(xr, p.conv, convs, slots, local,
                                             pos)
            xf, r, i = gates_of(xr)
            h = _rglru_scan_packed(xf, r, i, lam,
                                   hs[_rows(slots, hs.shape[0])].float(),
                                   is_start, inject)
            _scatter_state(hs, h, slots, is_end)
            _scatter_state(convs, _conv_state_of(lags), slots, is_end)
        out = (h.to(x.dtype) * gate) @ layers.weight(ctx, p.wo, "rec:mixer.wo")
        return (out if plan is None else plan.leave(out, split, ctx.seq)), cache

    xr, new_conv = _conv1d_causal(xr, p.conv,
                                  None if cache is None else cache["conv"])
    xf, r, i = gates_of(xr)
    if ctx.decode:
        if s != 1 or cache is None:
            raise ValueError("decode takes one token per row and a cache")
        h = _rglru_step(xf[:, 0], r[:, 0], i[:, 0], lam, cache["h"])
        cache["h"].copy_(h)
        cache["conv"].copy_(new_conv)
        h = h[:, None, :]
    else:
        h = _rglru_scan(xf, r, i, lam)
        if cache is not None:              # prefill: keep the final state
            cache["h"].copy_(h[:, -1])
            cache["conv"].copy_(new_conv)
    out = (h.to(x.dtype) * gate) @ layers.weight(ctx, p.wo, "rec:mixer.wo")
    return (out if plan is None else plan.leave(out, split, ctx.seq)), cache
