"""Pinhole camera model: projection, back-projection, distortion, visibility.

Port of ``vo_tpu/geometry/camera.py``: the same formulas, batched over leading axes,
fixed-shape (masks, never filtering).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeCamera(NamedTuple):
    """Intrinsics container. ``K`` is the (3, 3) intrinsic matrix."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @classmethod
    def from_K(cls, K) -> PinholeCamera:
        K = torch.as_tensor(K)
        return cls(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2])

    @property
    def K(self) -> torch.Tensor:
        fx = torch.as_tensor(self.fx, dtype=torch.float32)
        z = torch.zeros_like(fx)
        o = torch.ones_like(fx)
        return torch.stack([
            torch.stack([fx, z, torch.as_tensor(self.cx, dtype=fx.dtype)]),
            torch.stack([z, torch.as_tensor(self.fy, dtype=fx.dtype),
                         torch.as_tensor(self.cy, dtype=fx.dtype)]),
            torch.stack([z, z, o]),
        ])


def project(points_3d: torch.Tensor, K: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., N, 3) -> (pixels (..., N, 2), depths (..., N)).

    Points with z <= 0 project behind the camera; callers mask on z themselves."""
    z = points_3d[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = K[0, 0] * points_3d[..., 0] / z_safe + K[0, 2]
    v = K[1, 1] * points_3d[..., 1] / z_safe + K[1, 2]
    return torch.stack([u, v], dim=-1), z


def unproject(kp: torch.Tensor, depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + depth (...) -> camera-frame points (..., 3): d K^-1 [u, v, 1]."""
    x = (kp[..., 0] - K[0, 2]) / K[0, 0]
    y = (kp[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def normalize_kp(kp: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> normalised image coordinates (..., 2)."""
    x = (kp[..., 0] - K[0, 2]) / K[0, 0]
    y = (kp[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y], dim=-1)


def depth_to_3d_at(depth_img: torch.Tensor, kp: torch.Tensor,
                   K: torch.Tensor) -> torch.Tensor:
    """Back-project the depth image at integer keypoint locations.

    depth_img (..., H, W), kp (..., N, 2) float [x, y] -> (..., N, 3). Coordinates are
    truncated toward zero and then clipped into the image, as the reference's
    ``.astype(np.int32)`` gather does. Zero depth yields z == 0, which the engine's
    depth gate rejects.
    """
    H, W = depth_img.shape[-2:]
    xi = kp[..., 0].to(torch.int64).clamp(0, W - 1)
    yi = kp[..., 1].to(torch.int64).clamp(0, H - 1)
    flat = depth_img.reshape(*depth_img.shape[:-2], H * W)
    d = torch.gather(flat, -1, yi * W + xi)
    return unproject(kp.to(depth_img.dtype), d, K)


def depth_to_3d(depth_img: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Dense back-projection of an (H, W) depth image -> (H, W, 3) camera points."""
    H, W = depth_img.shape
    u = torch.arange(W, dtype=depth_img.dtype, device=depth_img.device)[None, :].expand(H, W)
    v = torch.arange(H, dtype=depth_img.dtype, device=depth_img.device)[:, None].expand(H, W)
    return unproject(torch.stack([u, v], dim=-1), depth_img, K)


class Distortion(NamedTuple):
    """Radial-tangential (Brown-Conrady) coefficients in OpenCV's order
    [k1, k2, p1, p2, k3]."""

    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    k3: torch.Tensor

    @classmethod
    def from_coeffs(cls, d) -> Distortion:
        d = torch.as_tensor(d, dtype=torch.float32).reshape(-1)
        d = torch.cat([d, d.new_zeros(max(0, 5 - d.shape[0]))])
        return cls(d[0], d[1], d[2], d[3], d[4])

    @property
    def is_zero(self) -> torch.Tensor:
        return ((self.k1 == 0) & (self.k2 == 0) & (self.p1 == 0) & (self.p2 == 0)
                & (self.k3 == 0))


def distort_normalized(xy: torch.Tensor, dist: Distortion) -> torch.Tensor:
    """Apply radial-tangential distortion to normalised image coords (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (dist.k1 + r2 * (dist.k2 + r2 * dist.k3))
    xd = x * radial + 2.0 * dist.p1 * x * y + dist.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + dist.p1 * (r2 + 2.0 * y * y) + 2.0 * dist.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(xy_d: torch.Tensor, dist: Distortion,
                         iters: int = 8) -> torch.Tensor:
    """Invert the distortion by a fixed number of fixed-point iterations (OpenCV's
    ``undistortPoints`` compensation loop)."""
    xd, yd = xy_d[..., 0], xy_d[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (dist.k1 + r2 * (dist.k2 + r2 * dist.k3))
        dx = 2.0 * dist.p1 * x * y + dist.p2 * (r2 + 2.0 * x * x)
        dy = dist.p1 * (r2 + 2.0 * y * y) + 2.0 * dist.p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([x, y], dim=-1)


def _to_pixels(xy: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    return torch.stack([K[0, 0] * xy[..., 0] + K[0, 2], K[1, 1] * xy[..., 1] + K[1, 2]],
                       dim=-1)


def undistort_points(kp: torch.Tensor, K: torch.Tensor, dist: Distortion,
                     iters: int = 8) -> torch.Tensor:
    """Distorted pixel coords (..., 2) -> ideal pixel coords (..., 2)."""
    return _to_pixels(undistort_normalized(normalize_kp(kp, K), dist, iters), K)


def distort_points(kp: torch.Tensor, K: torch.Tensor, dist: Distortion) -> torch.Tensor:
    """Ideal pixel coords (..., 2) -> distorted pixel coords (..., 2)."""
    return _to_pixels(distort_normalized(normalize_kp(kp, K), dist), K)


def is_in_frame(uv: torch.Tensor, width: int, height: int,
                margin: float = 0.0) -> torch.Tensor:
    """Pixel-bounds test: margin <= u < width - margin, likewise for v."""
    return ((uv[..., 0] >= margin) & (uv[..., 0] < width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < height - margin))


def are_visible(points_3d: torch.Tensor, K: torch.Tensor, width: int, height: int,
                z_near: float = 0.0, z_far: float = float("inf")) -> torch.Tensor:
    """In front of the camera (z_near < z < z_far) and inside the frame."""
    uv, z = project(points_3d, K)
    return is_in_frame(uv, width, height) & (z > z_near) & (z < z_far)
