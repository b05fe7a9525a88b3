"""SURF-style features: box-filter Hessian detector + upright Haar-wavelet SURF-64.

Port of ``vo_tpu/features/surf.py``: separable shift-and-add box sums (the integral
image's role), the determinant-of-Hessian response at lobes 3/5/7 max-reduced over
scale, dense Haar planes box-pooled once per cell size, and 16 gathers per keypoint
(a 4 x 4 grid of 5 px cells) of (sum dx, sum |dx|, sum dy, sum |dy|) -> 64 values,
L2-normalised, bf16. Matched with ``ratio_float`` at 0.85 (``config.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

N_CELLS = 4     # 4x4 spatial grid
CELL_SIZE = 5   # px per cell => 20x20 px support
HAAR_S = 2      # Haar wavelet half-size (responses over 2s x 2s support)


def _box_sum_1d(img: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Unnormalised 1-D box sum along H (axis=1) or W (axis=2) of (B, H, W), SAME,
    zero-padded ((size-1)//2 before, size//2 after, so even sizes work), summed tap by
    tap in order."""
    lo, hi = (size - 1) // 2, size // 2
    xp = F.pad(img, (0, 0, lo, hi) if axis == 1 else (lo, hi))
    n = img.shape[axis]
    out = torch.zeros_like(img)
    for i in range(size):
        out = out + xp.narrow(axis, i, n)
    return out


def _shift(img: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """Shift with zero fill: out[..., i, ...] = img[..., i + d, ...]."""
    n = img.shape[axis]
    lo, hi = max(-d, 0), max(d, 0)
    xp = F.pad(img, (0, 0, lo, hi) if axis == 1 else (lo, hi))
    return xp.narrow(axis, hi, n)


def hessian_response(gray: torch.Tensor, lobes: tuple[int, ...] = (3, 5, 7)) -> torch.Tensor:
    """(B, H, W) -> (B, H, W) determinant-of-Hessian response, max over scales.

    Per lobe L (filter size 3L): Dxx is three vertical bands (width L, height 2L-1,
    weights +1 -2 +1), Dyy its transpose, Dxy four L x L quadrant boxes centred
    (L+1)//2 off the filter centre; each normalised by the filter's area, and
    det H = Dxx Dyy - (0.9 Dxy)^2.
    """
    gray = gray.to(torch.float32)
    out = None
    for L in lobes:
        band_h = 2 * L - 1
        s = _box_sum_1d(_box_sum_1d(gray, L, axis=2), band_h, axis=1)
        dxx = _shift(s, -L, axis=2) - 2.0 * s + _shift(s, L, axis=2)
        t = _box_sum_1d(_box_sum_1d(gray, L, axis=1), band_h, axis=2)
        dyy = _shift(t, -L, axis=1) - 2.0 * t + _shift(t, L, axis=1)
        q = _box_sum_1d(_box_sum_1d(gray, L, axis=1), L, axis=2)
        o = (L + 1) // 2
        pp = _shift(_shift(q, o, axis=1), o, axis=2)
        mm = _shift(_shift(q, -o, axis=1), -o, axis=2)
        pm = _shift(_shift(q, o, axis=1), -o, axis=2)
        mp = _shift(_shift(q, -o, axis=1), o, axis=2)
        dxy = pp + mm - pm - mp
        norm = 1.0 / float((3 * L) ** 2)
        dxx, dyy, dxy = dxx * norm, dyy * norm, dxy * norm
        det = dxx * dyy - (0.9 * dxy) ** 2
        out = det if out is None else torch.maximum(out, det)
    return out


def dense_haar_planes(gray: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H, W, 4) cell-pooled (dx, |dx|, dy, |dy|) Haar planes."""
    gray = gray.to(torch.float32)
    s = HAAR_S
    bx = _box_sum_1d(_box_sum_1d(gray, s, axis=2), 2 * s, axis=1)
    dx = _shift(bx, (s + 1) // 2, axis=2) - _shift(bx, -((s + 1) // 2), axis=2)
    by = _box_sum_1d(_box_sum_1d(gray, s, axis=1), 2 * s, axis=2)
    dy = _shift(by, (s + 1) // 2, axis=1) - _shift(by, -((s + 1) // 2), axis=1)
    # One box pool per plane gives every pixel its cell's sum; the four planes are
    # pooled as one (4B, H, W) batch.
    planes = torch.cat([dx, torch.abs(dx), dy, torch.abs(dy)])
    pooled = _box_sum_1d(_box_sum_1d(planes, CELL_SIZE, axis=1), CELL_SIZE, axis=2)
    return torch.stack(pooled.chunk(4), dim=-1)


def gather_surf_descriptors(pooled: torch.Tensor, kp: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4) pooled planes + (B, K, 2) kp -> (B, K, 64) L2-normalised bf16.
    Cell centres are rounded half to even (as ``jnp.round``) and clipped into the
    image."""
    B, H, W, _ = pooled.shape
    c = (torch.arange(N_CELLS, dtype=torch.float32, device=kp.device)
         - (N_CELLS - 1) / 2.0) * CELL_SIZE
    oy, ox = torch.meshgrid(c, c, indexing="ij")
    offs = torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)        # (16, 2)

    pts = kp[:, :, None, :] + offs                                      # (B, K, 16, 2)
    xi = torch.round(pts[..., 0]).to(torch.int64).clamp(0, W - 1)
    yi = torch.round(pts[..., 1]).to(torch.int64).clamp(0, H - 1)
    flat = (yi * W + xi).reshape(B, -1, 1).expand(-1, -1, 4)
    cells = torch.gather(pooled.reshape(B, H * W, 4), 1, flat)          # (B, K*16, 4)
    desc = cells.reshape(B, kp.shape[1], N_CELLS * N_CELLS * 4)

    desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp(min=1e-8)
    desc = torch.where(valid[..., None], desc, 0.0)
    return desc.to(torch.bfloat16)


def surf_descriptors(gray: torch.Tensor, kp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return gather_surf_descriptors(dense_haar_planes(gray), kp, valid)
