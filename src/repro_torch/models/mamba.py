"""Mamba-1 selective-state-space mixer of the port (counterpart of
``repro.models.mamba``; falcon-mamba-7b, arXiv:2410.05355).

The arch is attention-free, so no attention kernel applies: the mixer is
plain torch, as the JAX mixer is plain JAX. The selective scan
h_t = Ā_t ⊙ h_{t-1} + B̄_t x_t is linear in h. Prefill and training scan
chunks of ``CHUNK`` tokens one after another, carrying h [B, Di, N], with
the doubling scan of ``rglru._linear_scan`` inside each chunk (peak memory
[B, chunk, Di, N] f32 an operand); decode is one state update.

The chunk rule is JAX's (``_ssm_scan``): a sequence whose length is not a
multiple of ``CHUNK`` is scanned as one chunk. It fixes the order of the
roundings, and it fixes the memory: at falcon-mamba's width (Di 8192, N
16) one [1, 256, Di, N] f32 operand is 128 MiB, a whole 2048-token row
taken as one chunk 1 GiB. So lengths on the card are multiples of 256.
The carried state enters a chunk as the sequential step does, as
a_0 · h_prev added to the chunk's first source term; JAX adds a_cum · h_prev
after its in-chunk scan, which rounds differently (within 2e-5 in f32,
``tests/test_torch_mamba.py``).

Serving state: a contiguous cache holds ``{"h": [B, Di, N] f32, "conv":
[B, K-1, Di] f32}`` per layer; a paged one the same with ``max_batch + 1``
rows, the last the trash row, under the per-slot protocol of
``models/rglru.py``. Unlike the JAX mixer, which returns new arrays, the
caches are updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.rglru import (_conv1d_causal, _conv1d_causal_packed,
                                      _conv_state_of, _linear_scan,
                                      _packed_seg, _rows, _scatter_state)

#: the tokens a scan chunk holds (JAX ``_ssm_scan``'s ``chunk``)
CHUNK = 256


class Mamba(nn.Module):
    """The mixer's weights under JAX's leaf names: ``in_proj [d, 2·Di]``,
    the depthwise ``conv [K, Di]``, ``w_bc [Di, 2N]``, the low-rank
    ``w_dt1 [Di, R]`` and ``w_dt2 [R, Di]``, ``dt_bias [Di]``, ``A_log
    [Di, N]``, ``D [Di]`` and ``out_proj [Di, d]``. ``dt_bias``, ``A_log``
    and ``D`` are f32 in any model dtype, as in JAX."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        mc = cfg.mamba
        d, di, n = cfg.d_model, mc.d_inner, mc.ssm_state
        self.in_proj = layers._param((d, 2 * di), dtype, device)
        self.conv = layers._param((mc.conv_kernel, di), dtype, device)
        self.w_bc = layers._param((di, 2 * n), dtype, device)
        self.w_dt1 = layers._param((di, mc.dt_rank), dtype, device)
        self.w_dt2 = layers._param((mc.dt_rank, di), dtype, device)
        self.dt_bias = layers._param((di,), torch.float32, device)
        self.A_log = layers._param((di, n), torch.float32, device)
        self.D = layers._param((di,), torch.float32, device)
        self.out_proj = layers._param((di, d), dtype, device)


@torch.no_grad()
def init_mamba(gen: torch.Generator, cfg, dtype, keep=None) -> Mamba:
    """A :class:`Mamba` with JAX's shapes and scales: ``dense_init``
    matrices, conv ``N(0, 1) · 0.1``, ``dt_bias`` 0, ``D`` 1 and the S4D-real
    ``A_log = log(1..N)`` in every channel (A = -[1..N]) (``keep``: as
    ``layers.fill_``'s)."""
    mc = cfg.mamba
    d, di, n, r = cfg.d_model, mc.d_inner, mc.ssm_state, mc.dt_rank
    dev = gen.device

    def draws():
        for name, (d_in, d_out) in (("in_proj", (d, 2 * di)),
                                    ("w_bc", (di, 2 * n)), ("w_dt1", (di, r)),
                                    ("w_dt2", (r, di)), ("out_proj", (di, d))):
            yield name, layers.dense_init(gen, d_in, d_out, dtype)
        yield "conv", torch.randn((mc.conv_kernel, di), generator=gen,
                                  device=dev) * 0.1
        yield "dt_bias", torch.zeros((di,), device=dev)
        yield "A_log", torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                              device=dev)).expand(di, n)
        yield "D", torch.ones((di,), device=dev)

    return layers.fill_(Mamba(cfg, dtype, dev if keep is None else "meta"),
                        draws(), keep)


def init_mamba_cache(cfg, batch: int, device, channels=None):
    """Zero state rows: ``h [batch, Di, N]`` and ``conv [batch, K-1, Di]``,
    f32 (``channels`` in place of Di: a mesh rank's share of them)."""
    mc = cfg.mamba
    di = channels or mc.d_inner
    return {"h": torch.zeros((batch, di, mc.ssm_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, mc.conv_kernel - 1, di),
                                dtype=torch.float32, device=device)}


def _chunks(s: int, chunk: int):
    """The slices of the chunk scan over ``s`` tokens (JAX's rule: one
    chunk when ``s`` is not a multiple of ``chunk``)."""
    chunk = chunk if s % chunk == 0 else s
    return [slice(c, c + chunk) for c in range(0, s, chunk)]


def _discretise(u, dt, B, A):
    """Ā = exp(dt · A) and B̄x = (dt · u) ⊗ B, [B, S, Di, N] each."""
    return (torch.exp(dt[..., None] * A),
            (dt * u)[..., None] * B[:, :, None, :])


def _ssm_scan(u, dt, B, C, A, D, *, chunk: int = CHUNK):
    """u, dt [B, S, Di] f32; B, C [B, S, N]; A [Di, N]; D [Di] → (y [B, S, Di]
    f32, h_last [B, Di, N]), from a zero state."""
    h = u.new_zeros((u.shape[0], u.shape[2], A.shape[1]))
    ys = []
    for i, sl in enumerate(_chunks(u.shape[1], chunk)):
        a_bar, bx = _discretise(u[:, sl], dt[:, sl], B[:, sl], A)
        if i:
            bx[:, 0] += a_bar[:, 0] * h             # the carried state
        hs = _linear_scan(a_bar, bx)
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, C[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1) + D * u, h


def _ssm_step(u, dt, B, C, A, D, h_prev):
    """One decode step: u, dt [B, Di]; B, C [B, N]; h_prev [B, Di, N] →
    (y [B, Di], h)."""
    a_bar = torch.exp(dt[..., None] * A)
    h = a_bar * h_prev + (dt * u)[..., None] * B[:, None, :]
    return torch.einsum("bdn,bn->bd", h, C) + D * u, h


def _ssm_steps(u, dt, B, C, A, D):
    """The scan's oracle: :func:`_ssm_step` over the sequence one token at a
    time, from a zero state; ``_ssm_scan``'s signature and result."""
    h = u.new_zeros((u.shape[0], u.shape[2], A.shape[1]))
    ys = []
    for t in range(u.shape[1]):
        y, h = _ssm_step(u[:, t], dt[:, t], B[:, t], C[:, t], A, D, h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


def _ssm_scan_packed(u, dt, B, C, A, D, state_h, slots, is_start, inject,
                     is_end, *, chunk: int = CHUNK):
    """The multi-span chunk scan of packed paged prefill: :func:`_ssm_scan`
    with the recurrence reset at span starts (Ā zeroed there, so neither
    the in-chunk scan nor the carry crosses a span boundary); continuation
    spans resume from their slot's row of ``state_h`` [n_slots+1, Di, N],
    added as Ā · h_init into the injected start's source term (the
    sequential step exactly); each span-end h is scattered back to its
    slot's row in place inside the chunk loop (other tokens land on the
    trash row). Returns y [B, S, Di] f32."""
    rows = _rows(slots, state_h.shape[0])
    h = u.new_zeros((u.shape[0], u.shape[2], A.shape[1]))
    ys = []
    for i, sl in enumerate(_chunks(u.shape[1], chunk)):
        a_bar, bx = _discretise(u[:, sl], dt[:, sl], B[:, sl], A)
        bx += inject[:, sl].float()[..., None, None] * a_bar * state_h[rows[:, sl]]
        a_eff = a_bar * (~is_start[:, sl]).float()[..., None, None]
        if i:
            bx[:, 0] += a_eff[:, 0] * h
        hs = _linear_scan(a_eff, bx)
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, C[:, sl]))
        _scatter_state(state_h, hs, slots[:, sl], is_end[:, sl])
        h = hs[:, -1]
    return torch.cat(ys, dim=1) + D * u


def apply_mamba(p: Mamba, x, ctx: layers.Ctx, cfg, *, cache=None,
                positions=None, paged=None):
    """x [B, S, d] → (out [B, S, d], cache or None).

    cache (serving): ``{"h", "conv"}`` state rows, updated in place. paged:
    the per-slot state protocol, rows [n_slots+1, ...]. Prefill routes spans
    through ``paged["state_slots"]`` / ``["state_local"]`` (the packed scan
    with zero or carried initial state, span-end states scattered back);
    decode updates rows [:B] where ``paged["kv_len"] > 0``, so masked and
    inactive slots keep their state (as ``rglru.apply_rglru``).

    On a mesh (``ctx.plan``) whose ``model`` axis splits the channels (the
    state rows then hold the rank's channels): ``in_proj`` column-parallel on this rank's channels of
    both halves (u and z), the conv, ``dt_bias``, ``A_log``, ``D`` and the
    chunked scan on them; ``w_bc`` and ``w_dt1`` its rows, their partial
    products summed over ``model`` (B, C and the dt rank are every
    channel's); ``w_dt2`` column-parallel; ``out_proj`` row-parallel and
    summed.

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
    u, z = (x @ layers.weight(ctx, p.in_proj, "ssm:mixer.in_proj")).chunk(2, dim=-1)
    a = -torch.exp(p.A_log)

    def scan_inputs(u):
        """The conv's output → (u, dt, B, C) of the scan, f32; the
        projections run in the model's dtype, as in JAX."""
        u = F.silu(u).float()
        ux = u.to(x.dtype)
        bc, dt = ux @ p.w_bc, ux @ p.w_dt1
        if split:
            bc, dt = plan.reenter(torch.cat([bc, dt], dim=-1)).split(
                [bc.shape[-1], dt.shape[-1]], dim=-1)
        bm, cm = bc.float().chunk(2, dim=-1)
        dt = F.softplus((dt @ p.w_dt2).float() + p.dt_bias)
        return u, dt, bm, cm

    if paged is not None:
        if cache is None:
            raise ValueError("paged serving always threads state rows")
        hs, convs = cache["h"], cache["conv"]
        if ctx.decode:
            u, new_conv = _conv1d_causal(u, p.conv, convs[:b])
            u, dt, bm, cm = scan_inputs(u)
            y, h = _ssm_step(u[:, 0], dt[:, 0], bm[:, 0], cm[:, 0], a, p.D,
                             hs[:b])
            live = (paged["kv_len"] > 0)[:, None, None]
            hs[:b] = torch.where(live, h, hs[:b])
            convs[:b] = torch.where(live, new_conv.to(convs.dtype), convs[:b])
            y = y[:, None]
        else:
            if "state_slots" not in paged:
                raise ValueError(
                    "recurrent paged prefill needs state routing: pass "
                    "state_slots/state_local (lm.paged_prefill/"
                    "paged_chunk_prefill)")
            slots, local, is_start, inject, is_end = _packed_seg(paged,
                                                                 positions)
            pos = torch.broadcast_to(positions, slots.shape).long()
            u, lags = _conv1d_causal_packed(u, p.conv, convs, slots, local, pos)
            u, dt, bm, cm = scan_inputs(u)
            y = _ssm_scan_packed(u, dt, bm, cm, a, p.D, hs, slots, is_start,
                                 inject, is_end)
            _scatter_state(convs, _conv_state_of(lags), slots, is_end)
    else:
        u, new_conv = _conv1d_causal(u, p.conv,
                                     None if cache is None else cache["conv"])
        u, dt, bm, cm = scan_inputs(u)
        if ctx.decode:
            if s != 1 or cache is None:
                raise ValueError("decode takes one token per row and a cache")
            y, h = _ssm_step(u[:, 0], dt[:, 0], bm[:, 0], cm[:, 0], a, p.D,
                             cache["h"])
            y = y[:, None]
        else:
            y, h = _ssm_scan(u, dt, bm, cm, a, p.D)
        if cache is not None:             # keep the final state
            cache["h"].copy_(h)
            cache["conv"].copy_(new_conv)
    out = (y.to(x.dtype) * F.silu(z)) @ layers.weight(ctx, p.out_proj,
                                                      "ssm:mixer.out_proj")
    return (out if plan is None else plan.leave(out, split, ctx.seq)), cache
