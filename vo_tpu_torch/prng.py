"""Threefry-2x32 keys, uniform, normal and integer draws, compatible with ``jax.random``.

The engine draws every RANSAC sample from ``fold_in(key(seed), frame_id)``, then
``split`` and ``uniform`` (vo_tpu/engine/vo.py, vo_tpu/estimation/pnp.py); training
draws its pairs, photometric jitter and initial weights with ``uniform`` over a range
and ``normal`` (vo_tpu/train/pairs.py, vo_tpu/models/patchnet.py). These are the same
functions over torch int64 tensors holding uint32 values, in the bit layout of jax's
``jax_threefry_partitionable`` mode (the default of jax 0.9), so the port samples
exactly the hypotheses the JAX package samples.

A key is an int64 tensor of shape (..., 2); leading axes batch keys.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block on broadcastable uint32-valued int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.key(seed)`` for a seed in the int32 or uint32 range: [0, seed],
    made on the device (a tensor from a list would be copied up, a host sync)."""
    return torch.arange(2, dtype=torch.int64, device=device) * (seed & _M32)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` may be an int or an integer tensor that
    broadcasts against the key's leading axes."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    if n >= 2 ** 32:
        raise ValueError("more than 2**32 draws from one key")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return torch.zeros_like(lo), lo


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    hi, lo = _counters(num, k.device)
    b1, b2 = threefry2x32(k[..., 0, None], k[..., 1, None], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def uniform(k: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in fp32 over [minval,
    maxval): (...,) + shape.

    jax scales the [0, 1) draw as ``u * (maxval - minval) + minval`` with one
    rounding (XLA contracts it into a fused multiply-add) and then takes the max with
    ``minval``; the product of two fp32 values is exact in fp64, so the fp64 sum
    rounded once to fp32 gives the same bits.
    """
    n = math.prod(shape)
    hi, lo = _counters(n, k.device)
    b1, b2 = threefry2x32(k[..., 0, None], k[..., 1, None], hi, lo)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000          # below 2**31: exact in int32
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    floats = floats.reshape(k.shape[:-1] + tuple(shape))
    if (minval, maxval) == (0.0, 1.0):
        return torch.clamp(floats, min=0.0)
    lo32, hi32 = (torch.tensor(v, dtype=torch.float32).item() for v in (minval, maxval))
    span = torch.tensor(hi32, dtype=torch.float32) - torch.tensor(lo32, dtype=torch.float32)
    scaled = (floats.to(torch.float64) * span.item() + lo32).to(torch.float32)
    return torch.clamp(scaled, min=lo32)


# Giles' single-precision erfinv polynomials, the ones XLA evaluates for
# ``lax.erf_inv`` on fp32 (torch.erfinv computes another approximation).
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """fp32 erfinv on (-1, 1) by XLA's polynomials, evaluated in fp32 (Horner). The
    square root is taken in fp64 and rounded once, which gives the correctly rounded
    fp32 root that XLA computes (torch's fp32 CPU root is not always)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w.to(torch.float64)).to(torch.float32) - 3.0)
    p = torch.where(small, _ERFINV_W_LT5[0], _ERFINV_W_GE5[0])
    for a, b in zip(_ERFINV_W_LT5[1:], _ERFINV_W_GE5[1:]):
        p = torch.where(small, a, b) + p * w
    return p * x


def normal(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in fp32: ``sqrt(2) * erfinv(u)`` for u
    uniform on (nextafter(-1, 0), 1); (...,) + shape."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _erfinv(uniform(k, shape, lo, 1.0)) * float(np.float32(np.sqrt(2.0)))


_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _rem(a: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """uint32 remainder; ``a % 0`` is ``a``, as XLA defines it for unsigned types."""
    return torch.where(span == 0, a, a % torch.where(span == 0, 1, span))


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint32 product with wrap-around, for uint32 values held in int64."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & _M32


def randint(k: torch.Tensor, shape: tuple[int, ...], minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): (...,) + shape.

    jax's algorithm: 32 random bits from each half of ``split(key)`` reduced into the
    span with ``(hi % span) * (2**32 % span) + lo % span``, all in uint32 arithmetic
    (held here in int64 and wrapped with ``_M32``). ``minval`` and ``maxval`` are
    clipped to the int32 range; ``maxval <= minval`` gives ``minval``.
    """
    minval, maxval = (v.to(k.device, torch.int64) if isinstance(v, torch.Tensor)
                      else torch.full((), v, dtype=torch.int64, device=k.device)
                      for v in (minval, maxval))
    out_of_range = maxval > _I32_MAX
    minval = minval.clamp(_I32_MIN, _I32_MAX)
    maxval = maxval.clamp(_I32_MIN, _I32_MAX)
    n = math.prod(shape)
    hi, lo = _counters(n, k.device)
    ks = split(k)
    bits = []
    for i in range(2):
        b1, b2 = threefry2x32(ks[..., i, 0, None], ks[..., i, 1, None], hi, lo)
        bits.append((b1 ^ b2).reshape(k.shape[:-1] + tuple(shape)))
    higher, lower = bits

    span = (maxval - minval) & _M32
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    span = torch.where(out_of_range & (maxval > minval), (span + 1) & _M32, span)
    multiplier = _rem(torch.full_like(span, 2 ** 16), span)
    multiplier = _rem(_mul32(multiplier, multiplier), span)
    offset = _mul32(_rem(higher, span), multiplier)
    offset = _rem((offset + _rem(lower, span)) & _M32, span)
    out = (minval + offset - _I32_MIN) & _M32                 # int32 wrap-around
    return (out + _I32_MIN).to(torch.int32)
