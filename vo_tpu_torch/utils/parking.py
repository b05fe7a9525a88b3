"""Parking-spot geometry: plane-homography projection, mask scanning, midpoint lifting.

Port of ``vo_tpu/utils/parking.py``:

- ``world_to_image``: plane points through H;
- ``find_spot_corners``: the first free column along two fitted lines of a road mask,
  every column at once (the first hit is an argmax over the hit mask, cast to int32:
  ``torch.argmax`` takes no bool tensor on the card);
- ``fit_line``, ``find_midpoint`` (the diagonals' intersection, lifted to the plane
  through H^-1) and ``plane_consensus_mask`` (homography inliers rasterised into a
  road mask).

Functions taking arrays run on ``device`` (default: where their first array lies if
it is a tensor, else cuda).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vo_tpu_torch.device import device_for, to_device
from vo_tpu_torch.estimation.homography import apply_homography


def world_to_image(H, plane_pts, device: str | torch.device | None = None):
    """Plane coordinates (..., N, 2) -> image pixels (..., N, 2) through H."""
    dev = device_for(H, device)
    return apply_homography(to_device(H, dev, torch.float32),
                            to_device(plane_pts, dev, torch.float32))


def fit_line(pts: torch.Tensor, weights: torch.Tensor | None = None):
    """Weighted least-squares line y = m x + c through (N, 2) points -> (m, c)."""
    w = torch.ones(pts.shape[0], device=pts.device) if weights is None else weights
    x, y = pts[..., 0], pts[..., 1]
    wsum = w.sum().clamp(min=1e-9)
    xm = (w * x).sum() / wsum
    ym = (w * y).sum() / wsum
    cov = (w * (x - xm) * (y - ym)).sum()
    var = (w * (x - xm) ** 2).sum().clamp(min=1e-9)
    m = cov / var
    return m, ym - m * xm


class SpotCorners(NamedTuple):
    corners: torch.Tensor  # (4, 2) [bl, br, tr, tl] image coordinates [x, y]
    found: torch.Tensor    # () bool


def find_spot_corners(mask, line_top: tuple, line_bottom: tuple, spot_width_px: int = 200,
                      device: str | torch.device | None = None) -> SpotCorners:
    """First free spot along two boundary lines of a parking row: for each line
    y = m x + c, the smallest x whose mask pixel is road (mask > 0); the spot spans
    ``spot_width_px`` columns from there. A column with no hit gives x = 0 and
    ``found`` False."""
    dev = device_for(mask, device)
    mask = to_device(mask, dev)
    Hh, Ww = mask.shape
    x = torch.arange(Ww, device=dev)

    def first_hit(m, c):
        y = torch.clamp((m * x + c).to(torch.int32), 0, Hh - 1)
        hit = mask[y, x] > 0
        return torch.argmax(hit.to(torch.int32)), hit.any()   # first True (0 if none)

    (mt, ct), (mb, cb) = line_top, line_bottom
    xt, okt = first_hit(mt, ct)
    xb, okb = first_hit(mb, cb)

    def at(m, c, xi):
        xi = xi.to(torch.float32)
        return torch.stack([xi, m * xi + c])

    corners = torch.stack([
        at(mb, cb, xb),                        # bl
        at(mb, cb, xb + spot_width_px),        # br
        at(mt, ct, xt + spot_width_px),        # tr
        at(mt, ct, xt),                        # tl
    ])
    return SpotCorners(corners=corners, found=okt & okb)


def find_midpoint(corners, H, device: str | torch.device | None = None):
    """Midpoint of the spot quadrilateral as the intersection of its diagonals, and
    its world-plane position through H^-1. corners: (4, 2) [bl, br, tr, tl].
    Returns (midpoint_px (2,), midpoint_world (2,))."""
    dev = device_for(corners, device)
    corners, H = to_device(corners, dev, torch.float32), to_device(H, dev, torch.float32)
    m1, c1 = fit_line(corners[[0, 2]])   # bl-tr diagonal
    m2, c2 = fit_line(corners[[1, 3]])   # br-tl diagonal
    one = torch.ones_like(m1)
    A = torch.stack([torch.stack([-m1, one]), torch.stack([-m2, one])])
    mid = torch.linalg.solve_ex(A, torch.stack([c1, c2]))[0].flip(0)   # [x, y]
    world = apply_homography(torch.linalg.inv_ex(H)[0], mid[None])[0]
    return mid, world


def plane_consensus_mask(shape: tuple[int, int], kp, inliers, radius: int = 6,
                         device: str | torch.device | None = None) -> torch.Tensor:
    """Rasterise homography-inlier keypoints into a dense (H, W) road mask: pixels
    within ``radius`` of any inlier keypoint are road."""
    dev = device_for(kp, device)
    kp, inliers = to_device(kp, dev, torch.float32), to_device(inliers, dev, torch.bool)
    Hh, Ww = shape
    yy = torch.arange(Hh, device=dev, dtype=torch.float32)[:, None].expand(Hh, Ww)
    xx = torch.arange(Ww, device=dev, dtype=torch.float32)[None, :].expand(Hh, Ww)
    d2 = ((xx[None] - kp[:, 0, None, None]) ** 2 + (yy[None] - kp[:, 1, None, None]) ** 2)
    near = (d2 <= radius * radius) & inliers[:, None, None]
    return near.any(0)
