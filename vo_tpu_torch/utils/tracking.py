"""Scene-point tracking: follow a designated 3D point through the trajectory.

Port of ``vo_tpu/utils/tracking.py``: lift a pixel to 3D with the first frame's depth,
then reproject it into every frame of an estimated trajectory. Functions taking arrays
run on ``device`` (default: where their first array lies if it is a tensor, else cuda).
"""

from __future__ import annotations

import torch

from vo_tpu_torch.device import device_for, to_device
from vo_tpu_torch.geometry.camera import project, unproject
from vo_tpu_torch.geometry.se3 import pose_inverse, transform_points


def lift_point(depth_img, pixel_xy, K, device: str | torch.device | None = None):
    """Pixel of frame 0 -> 3D point in frame 0's camera coordinates (the world for an
    identity start). A host-side helper: the pixel is read as Python ints."""
    dev = device_for(depth_img, device)
    depth_img, K = to_device(depth_img, dev, torch.float32), to_device(K, dev, torch.float32)
    x, y = int(pixel_xy[0]), int(pixel_xy[1])
    d = depth_img[y, x][None]
    return unproject(torch.tensor([[float(x), float(y)]], device=dev), d, K)[0]


def track_point(point_w, poses, K, device: str | torch.device | None = None):
    """Reproject a world point into every frame of a (F, 4, 4) camera-to-world
    trajectory -> (uv (F, 2), depth (F,), visible (F,))."""
    dev = device_for(point_w, device)
    point_w, poses, K = (to_device(x, dev, torch.float32) for x in (point_w, poses, K))
    pts_c = transform_points(point_w[None, None, :], pose_inverse(poses))[:, 0]  # (F, 3)
    uv, z = project(pts_c, K)
    return uv, z, z > 0.0


def distance_to_point(point_w, poses, device: str | torch.device | None = None):
    """Euclidean camera-to-point distance per frame, (F,)."""
    dev = device_for(point_w, device)
    point_w, poses = to_device(point_w, dev, torch.float32), to_device(poses, dev, torch.float32)
    return torch.linalg.vector_norm(poses[:, :3, 3] - point_w[None, :], dim=-1)
