"""Oriented BRIEF-style binary descriptors (ORB's rBRIEF), batched over frames.

Port of ``vo_tpu/features/brief.py``: per keypoint, the intensity-centroid orientation
of a blurred (2r+1)^2 patch, then 256 comparisons of bilinear samples at the sampling
pattern turned by that orientation. Descriptors are +-1 bf16 vectors (0 rows for
invalid keypoints), so Hamming matching is the same descriptor product as for the
upright BRIEF of the main path. The JAX package ``vmap``s one image at a time; here
every function takes a leading batch of frames.
"""

from __future__ import annotations

import numpy as np
import torch

from vo_tpu_torch.features.detect import _gather_hw
from vo_tpu_torch.ops.image import gaussian_blur

BRIEF_BITS = 256
_PATTERN_RADIUS = 13.0
_PATCH_RADIUS = 20  # sampling patch half-side; covers rotated offsets up to r*sqrt(2)


def brief_offsets(bits: int = BRIEF_BITS, seed: int = 8214) -> np.ndarray:
    """Fixed Gaussian sampling pattern: (bits, 2, 2) [pair, point, (dx, dy)], drawn
    from numpy's ``default_rng(seed)``: the same bytes as the JAX package's."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, _PATTERN_RADIUS / 2.0, size=(bits, 2, 2))
    return np.clip(pts, -_PATTERN_RADIUS, _PATTERN_RADIUS).astype(np.float32)


# The sampling pattern on each device, by (bits, device): uploaded at a first call, so
# that a call inside a CUDA-graph capture copies nothing from the host.
_patterns: dict = {}


def _offsets_on(bits: int, device: torch.device) -> torch.Tensor:
    pattern = _patterns.get((bits, device))
    if pattern is None:
        pattern = _patterns[bits, device] = torch.from_numpy(brief_offsets(bits)).to(device)
    return pattern


def _orientation(patches: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Intensity-centroid orientation of (..., P, P) patches -> (cos, sin) (...,):
    theta = atan2(m01, m10) over the centred disk, as ORB."""
    P = patches.shape[-1]
    r = (P - 1) / 2.0
    xs = torch.arange(P, dtype=torch.float32, device=patches.device) - r
    disk = ((xs[None, :] ** 2 + xs[:, None] ** 2) <= r * r).to(torch.float32)
    w = patches * disk
    m10 = torch.sum(w * xs[None, :], dim=(-2, -1))
    m01 = torch.sum(w * xs[:, None], dim=(-2, -1))
    norm = torch.sqrt(m10 * m10 + m01 * m01) + 1e-9
    return m10 / norm, m01 / norm


def _extract_patches(img: torch.Tensor, kp: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, H, W) images, (B, K, 2) keypoints -> (B, K, P, P) patches centred at the
    truncated keypoint, the centre clipped so the patch lies inside the image."""
    H, W = img.shape[1:]
    cx = kp[..., 0].to(torch.int64).clamp(radius, W - 1 - radius)
    cy = kp[..., 1].to(torch.int64).clamp(radius, H - 1 - radius)
    d = torch.arange(-radius, radius + 1, device=img.device)
    return _gather_hw(img, cy[..., None, None] + d[:, None], cx[..., None, None] + d)


def oriented_brief_descriptors(gray: torch.Tensor, kp: torch.Tensor, valid: torch.Tensor,
                               bits: int = BRIEF_BITS,
                               blur_sigma: float = 2.0) -> torch.Tensor:
    """(B, H, W) gray, (B, K, 2) [x, y] keypoints, (B, K) mask -> (B, K, bits) bf16
    in {-1, +1}, 0 rows for invalid keypoints. A single (H, W) image with (K, 2)
    keypoints gives (K, bits)."""
    if gray.ndim == 2:
        return oriented_brief_descriptors(gray[None], kp[None], valid[None], bits,
                                          blur_sigma)[0]
    B, K = kp.shape[:2]
    offsets = _offsets_on(bits, gray.device)                            # (bits, 2, 2)
    smoothed = gaussian_blur(gray.to(torch.float32), blur_sigma)
    patches = _extract_patches(smoothed, kp, _PATCH_RADIUS)             # (B, K, P, P)
    cos_t, sin_t = (c[..., None, None] for c in _orientation(patches))

    # The pattern turned per keypoint: (B, K, bits, 2 points), patch-local coords.
    ox, oy = offsets[..., 0], offsets[..., 1]
    rx = cos_t * ox - sin_t * oy + _PATCH_RADIUS
    ry = sin_t * ox + cos_t * oy + _PATCH_RADIUS

    P = 2 * _PATCH_RADIUS + 1
    x0c = torch.floor(rx).to(torch.int64).clamp(0, P - 2)
    y0c = torch.floor(ry).to(torch.int64).clamp(0, P - 2)
    fx = torch.clamp(rx - x0c, 0.0, 1.0)
    fy = torch.clamp(ry - y0c, 0.0, 1.0)

    flat = patches.reshape(B, K, P * P)

    def at(y, x):
        return torch.gather(flat, 2, (y * P + x).reshape(B, K, -1)).reshape(y.shape)

    v00, v01 = at(y0c, x0c), at(y0c, x0c + 1)
    v10, v11 = at(y0c + 1, x0c), at(y0c + 1, x0c + 1)
    samples = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
               + fy * ((1 - fx) * v10 + fx * v11))                      # (B, K, bits, 2)

    desc = torch.where(samples[..., 0] < samples[..., 1], 1.0, -1.0)
    desc = torch.where(valid[..., None], desc, 0.0)
    return desc.to(torch.bfloat16)
