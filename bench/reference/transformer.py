"""Plain-PyTorch reference of the pre-norm transformer the benchmark's
configurations describe, written from a configuration file's numbers alone.

Two forms, chosen by the file: a decoder (``causal``, token embedding,
gated-SiLU MLP) and an encoder (not causal, frame embeddings of
``frontend_dim`` projected in, tanh-GELU MLP). Every block: RMSNorm (eps
``rms_norm_eps``), attention with ``num_kv_heads`` K/V heads shared by
``num_heads // num_kv_heads`` query heads each, rotary positions (half-split
form, base ``rope_theta``) on q and k, scale ``head_dim ** -0.5``, the
output projection, a residual; RMSNorm, the MLP, a residual. A final
RMSNorm and an untied output head. Weights are ``[d_in, d_out]`` and applied
as ``x @ w``; the gated MLP's ``wi`` holds the gate's columns, then the up
projection's. Loss: next-token cross-entropy (decoder) or per-position
cross-entropy (encoder), the mean over positions. AdamW: clipping by the
global norm, bias-corrected moments, decoupled weight decay on every leaf,
a constant rate.

f32 with TF32 off; attention in blocks of query rows and, with autograd,
each block recomputed in the backward (``checkpoint``), so a 40-layer,
4096-token step fits beside the optimizer's state. It imports nothing but
torch.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: query rows a block of the blocked attention
ATTN_BLOCK = 512


@contextlib.contextmanager
def full_f32():
    """Matrix products in full f32 (TF32 off) inside the block; the flags
    are restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _dims(c: dict):
    return (c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"],
            c["d_ff"], c["vocab_size"])


def leaves(c: dict) -> List[Tuple[str, Tuple[int, ...], Optional[float], int]]:
    """Every weight of the model: (name, shape, initial scale, block). A
    matrix starts as N(0, 1) times its scale, a norm weight (scale None) as
    ones. Block ``i`` holds layer ``i``'s leaves, block ``num_layers`` the
    rest."""
    d, hq, hkv, hd, ff, vocab = _dims(c)
    gated = c["mlp_type"] == "gated_silu"
    out = []
    for i in range(c["num_layers"]):
        p = f"blocks.{i}."
        out += [(p + "norm1", (d,), None, i),
                (p + "mixer.wq", (d, hq * hd), d ** -0.5, i),
                (p + "mixer.wk", (d, hkv * hd), d ** -0.5, i),
                (p + "mixer.wv", (d, hkv * hd), d ** -0.5, i),
                (p + "mixer.wo", (hq * hd, d), (hq * hd) ** -0.5, i),
                (p + "norm2", (d,), None, i),
                (p + "mlp.wi", (d, (2 if gated else 1) * ff), d ** -0.5, i),
                (p + "mlp.wo", (ff, d), ff ** -0.5, i)]
    top = c["num_layers"]
    out += [("embed", (vocab, d), 0.02, top),
            ("final_norm", (d,), None, top),
            ("lm_head", (d, vocab), d ** -0.5, top)]
    if c.get("frontend"):
        fd = c["frontend_dim"]
        out.append(("frontend_proj", (fd, d), fd ** -0.5, top))
    return out


def matmul_weights(c: dict) -> Tuple[int, int]:
    """(body, head): the weights a token meets in matrix products, the
    output head's apart; every 2-D leaf but the embedding, which is a
    gather. The benchmark's model flops are counted from them."""
    body = sum(_numel(shape) for name, shape, _, _ in leaves(c)
               if len(shape) == 2 and name not in ("embed", "lm_head"))
    return body, c["d_model"] * c["vocab_size"]


def attention_layers(c: dict) -> int:
    """Layers with attention: every block."""
    return c["num_layers"]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def rope(x, positions, theta: float):
    """x [B, S, H, D], positions [S]: rotate the first half against the
    second by angle position · theta^(-j / (D/2))."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attn_rows(q, k, v, a: int, causal: bool):
    """Rows ``a .. a + q.shape[2]`` of softmax(q k^T · scale) v; k/v hold
    every key the rows may see."""
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        qp = torch.arange(a, a + q.shape[2], device=q.device)[:, None]
        kp = torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(kp > qp, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def attention(q, k, v, causal: bool):
    """q [B, Hq, S, D], k/v [B, Hkv, S, D] → [B, Hq, S, D], in blocks of
    ``ATTN_BLOCK`` query rows (a causal block sees keys up to its last
    row)."""
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = q.shape[2]
    out = []
    for a in range(0, s, ATTN_BLOCK):
        b = min(s, a + ATTN_BLOCK)
        end = b if causal else s
        args = (q[:, :, a:b], k[:, :, :end], v[:, :, :end], a, causal)
        out.append(checkpoint(_attn_rows, *args, use_reentrant=False)
                   if torch.is_grad_enabled() else _attn_rows(*args))
    return torch.cat(out, dim=2)


def layer(p: Dict[str, torch.Tensor], i: int, x, c: dict, positions):
    """Block ``i`` on x [B, S, d]."""
    d, hq, hkv, hd, _, _ = _dims(c)
    pre = f"blocks.{i}."
    b, s, _ = x.shape
    h = rms_norm(x, p[pre + "norm1"], c["rms_norm_eps"])
    q = (h @ p[pre + "mixer.wq"]).view(b, s, hq, hd)
    k = (h @ p[pre + "mixer.wk"]).view(b, s, hkv, hd)
    v = (h @ p[pre + "mixer.wv"]).view(b, s, hkv, hd)
    q = rope(q, positions, c["rope_theta"]).transpose(1, 2)
    k = rope(k, positions, c["rope_theta"]).transpose(1, 2)
    o = attention(q, k, v.transpose(1, 2), c["causal"])
    x = x + o.transpose(1, 2).reshape(b, s, hq * hd) @ p[pre + "mixer.wo"]
    h = rms_norm(x, p[pre + "norm2"], c["rms_norm_eps"]) @ p[pre + "mlp.wi"]
    if c["mlp_type"] == "gated_silu":
        gate, up = h.chunk(2, dim=-1)
        h = F.silu(gate) * up
    else:
        h = F.gelu(h, approximate="tanh")
    return x + h @ p[pre + "mlp.wo"]


def hidden(p: Dict[str, torch.Tensor], c: dict, *, tokens=None, embeds=None):
    """The final norm's output [B, S, d] for tokens [B, S] or embeds
    [B, S, frontend_dim]; with autograd each layer is recomputed in the
    backward."""
    x = p["embed"][tokens.long()] if embeds is None else embeds @ p["frontend_proj"]
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(c["num_layers"]):
        if torch.is_grad_enabled():
            x = checkpoint(layer, p, i, x, c, positions, use_reentrant=False)
        else:
            x = layer(p, i, x, c, positions)
    return rms_norm(x, p["final_norm"], c["rms_norm_eps"])


def loss(p: Dict[str, torch.Tensor], c: dict, batch: Dict[str, torch.Tensor]):
    """Mean cross-entropy: next-token (decoder) or per-position (encoder)."""
    logits = hidden(p, c, tokens=batch.get("tokens"),
                    embeds=batch.get("embeds")) @ p["lm_head"]
    labels = batch["labels"].long()
    if c["causal"]:
        logits, labels = logits[:, :-1], labels[:, 1:]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def _clipped_grads(p: Dict[str, torch.Tensor], c: dict, batch: dict, clip: float):
    """(loss, {leaf: gradient clipped by the global norm}) at ``p``, whose
    leaves require grad; their ``.grad`` is cleared."""
    lv = loss(p, c, batch)
    lv.backward()
    with torch.no_grad():
        grads = {n: t.grad if t.grad is not None else torch.zeros_like(t)
                 for n, t in p.items()}
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(clip / (norm + 1e-9), max=1.0)
        for n, t in p.items():
            grads[n].mul_(scale)
            t.grad = None
    return float(lv.detach()), grads


def grad_norms(p: Dict[str, torch.Tensor], c: dict, batch: dict, opt: dict):
    """(loss, {leaf: norm of the clipped gradient}) of one step at ``p``,
    which is left as it is."""
    for t in p.values():
        t.requires_grad_(True)
    lv, grads = _clipped_grads(p, c, batch, opt["grad_clip"])
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
    for t in p.values():
        t.requires_grad_(False)
    return lv, norms


def train(p: Dict[str, torch.Tensor], c: dict, batches: Sequence[dict],
          opt: dict):
    """AdamW steps on ``p`` (leaves, updated in place), one a batch.
    Returns (each step's loss, {leaf: norm of the first step's gradient
    after clipping})."""
    for t in p.values():
        t.requires_grad_(True)
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, first = [], {}
    for step, batch in enumerate(batches, 1):
        lv, grads = _clipped_grads(p, c, batch, opt["grad_clip"])
        losses.append(lv)
        with torch.no_grad():
            b1c = 1.0 - opt["b1"] ** step
            b2c = 1.0 - opt["b2"] ** step
            for n, t in p.items():
                g = grads[n]
                if step == 1:
                    first[n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v[n].mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                u = (m[n] / b1c) / ((v[n] / b2c).sqrt() + opt["eps"])
                t.sub_(opt["lr"] * (u + opt["weight_decay"] * t))
    for t in p.values():
        t.requires_grad_(False)
    return losses, first


@torch.no_grad()
def logits_rows(p: Dict[str, torch.Tensor], c: dict, tokens, rows):
    """Logits [len(rows), vocab] at positions ``rows`` of one sequence
    tokens [S]."""
    h = hidden(p, c, tokens=tokens[None])[0]
    return h[torch.as_tensor(rows, device=h.device)] @ p["lm_head"]
