"""Upright dense-packed BRIEF. Port of ``vo_tpu/features/dense_brief.py``.

The blurred image is rounded to bf16 before the 256 shifted compares, exactly as the
JAX package does (``.to(torch.bfloat16)`` rounds to nearest even, like XLA's convert).
The packed words are int32 with the same bit pattern as the JAX package's uint32
words: torch has no uint32 shifts on CUDA, so bit 31 lands in the sign bit, and the
unpacking masks with ``& 1`` after each right shift, which is arithmetic on int32.

``upright_brief_descriptors`` gives the bits of ``dense_packed_brief`` then
``gather_brief_descriptors`` (which stay as the reference) but makes the compares at the
keypoints only (``ops/brief.py``: a CUDA kernel on the card, plain torch elsewhere).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vo_tpu_torch.ops.brief import keypoint_brief
from vo_tpu_torch.ops.image import gaussian_blur

BRIEF_BITS = 256
_PATTERN_RADIUS = 13


def dense_brief_offsets(bits: int = BRIEF_BITS, seed: int = 8214) -> np.ndarray:
    """(bits, 2, 2) integer [pair, point, (dx, dy)] offsets; the JAX package's table."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, _PATTERN_RADIUS / 2.0, size=(bits, 2, 2))
    return np.clip(np.round(pts), -_PATTERN_RADIUS, _PATTERN_RADIUS).astype(np.int32)


def dense_packed_brief(gray: torch.Tensor, bits: int = BRIEF_BITS,
                       blur_sigma: float = 2.0) -> torch.Tensor:
    """(B, H, W) gray -> (B, H, W, bits // 32) int32 words (uint32 bit patterns)."""
    offsets = dense_brief_offsets(bits)
    smoothed = gaussian_blur(gray, blur_sigma)
    pad = _PATTERN_RADIUS
    B, H, W = gray.shape
    xp = F.pad(smoothed.to(torch.bfloat16), (pad, pad, pad, pad))

    words = []
    acc = torch.zeros((B, H, W), dtype=torch.int32, device=gray.device)
    for b in range(bits):
        (ax, ay), (bx, by) = offsets[b]
        va = xp[:, ay + pad: ay + pad + H, ax + pad: ax + pad + W]
        vb = xp[:, by + pad: by + pad + H, bx + pad: bx + pad + W]
        acc = acc | ((va < vb).to(torch.int32) << (b % 32))
        if b % 32 == 31:
            words.append(acc)
            acc = torch.zeros((B, H, W), dtype=torch.int32, device=gray.device)
    return torch.stack(words, dim=-1)


def gather_brief_descriptors(packed: torch.Tensor, kp: torch.Tensor,
                             valid: torch.Tensor, bits: int = BRIEF_BITS) -> torch.Tensor:
    """Gather packed words at (B, K, 2) keypoints -> (B, K, bits) +-1 bf16, 0 if invalid."""
    B, H, W, nw = packed.shape
    xi = kp[..., 0].to(torch.int64).clamp(0, W - 1)
    yi = kp[..., 1].to(torch.int64).clamp(0, H - 1)
    flat = (yi * W + xi)[..., None].expand(B, kp.shape[1], nw)
    words = torch.gather(packed.reshape(B, H * W, nw), 1, flat)          # (B, K, nw)
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bitvals = (words[..., None] >> shifts) & 1                          # (B, K, nw, 32)
    desc = bitvals.reshape(B, kp.shape[1], nw * 32).to(torch.bfloat16) * 2.0 - 1.0
    return torch.where(valid[..., None], desc, 0.0)


# The offsets table on each device, by (bits, device): uploaded at a first call, so that
# a call inside a CUDA-graph capture copies nothing from the host.
_tables: dict = {}


def _offsets_on(bits: int, device: torch.device) -> torch.Tensor:
    table = _tables.get((bits, device))
    if table is None:
        table = _tables[bits, device] = torch.from_numpy(dense_brief_offsets(bits)).to(device)
    return table


def upright_brief_descriptors(gray: torch.Tensor, kp: torch.Tensor, valid: torch.Tensor,
                              bits: int = BRIEF_BITS, blur_sigma: float = 2.0) -> torch.Tensor:
    """(B, H, W) fp32 gray + (B, K, 2) fp32 kp -> (B, K, bits) +-1 bf16, 0 rows where not
    valid; ``bits`` a multiple of 32. The compares of the dense path at the keypoints."""
    return keypoint_brief(gaussian_blur(gray, blur_sigma), kp, valid,
                          _offsets_on(bits, gray.device))
