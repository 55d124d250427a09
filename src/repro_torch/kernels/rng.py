"""Counter-based dropout RNG, bit-identical to ``repro.kernels.rng``.

The mask is a pure function of the element's coordinates (seed, batch,
q-head, q_pos, kv_pos), so the fused kernels regenerate it instead of storing
it. The CUDA kernels compute the same hash with native ``uint32_t``
arithmetic (``csrc/flash_fwd.cu``); this plain-torch version emulates
uint32 in int64 with ``& 0xFFFFFFFF``, because torch on the CPU has no
``>>``, ``+`` or ``>=`` on ``torch.uint32``. Bits come back as int64 values
in ``[0, 2**32)``.
"""

from __future__ import annotations

import torch

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_M3 = 0x27D4EB2F
_GOLDEN = 0x9E3779B9
_MASK = 0xFFFFFFFF


def int32(x: int) -> int:
    """A Python int wrapped to int32, as JAX's int32 seed arithmetic wraps."""
    return (int(x) + 2**31) % 2**32 - 2**31


def _u32(x) -> torch.Tensor:
    """Any int (tensor or scalar, negative int32 included) → its uint32 bits."""
    return torch.as_tensor(x, dtype=torch.int64) & _MASK


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for uint32 ``x`` without overflowing int64: the
    product is split at bit 16 so each partial product stays below 2**48."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul(x, _M1)
    x = x ^ (x >> 13)
    x = _mul(x, _M2)
    x = x ^ (x >> 16)
    return x


def random_bits(seed, b, h, q_pos, kv_pos) -> torch.Tensor:
    """uint32 bits (as int64) for each broadcast (b, h, q_pos, kv_pos) point.

    ``seed``, ``b``, ``h`` are ints or integer tensors; ``q_pos``/``kv_pos``
    are integer index grids (global positions) that broadcast together.
    """
    s = ((_mul(_u32(seed), _GOLDEN) + _mul(_u32(b), _M3)) & _MASK) ^ \
        ((_u32(h) + _GOLDEN) & _MASK)
    x = (_mul(_u32(q_pos), _M1) + _mul(_u32(kv_pos), _M2) + s) & _MASK
    x = _mix(x)
    x = _mix((_mul(x, _M3) + _GOLDEN) & _MASK)
    return x


def keep_threshold(rate: float) -> int:
    """The uint32 threshold: keep iff ``bits >= rate * 2**32``."""
    return min(int(rate * 4294967296.0), 4294967295)


def dropout_keep_mask(rate: float, seed, b, h, q_pos,
                      kv_pos) -> torch.Tensor:
    """Boolean keep-mask with P(keep) = 1 - rate, reproducible from coordinates."""
    return random_bits(seed, b, h, q_pos, kv_pos) >= keep_threshold(rate)
