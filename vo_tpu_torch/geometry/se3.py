"""SE(3) rigid transforms as (..., 4, 4) tensors. Port of ``vo_tpu/geometry/se3.py``."""

from __future__ import annotations

import torch

from vo_tpu_torch.geometry.so3 import hat, so3_exp, so3_log

_EPS = 1e-8


def identity_pose(dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def pose_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4) homogeneous pose."""
    batch = R.shape[:-2]
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t.reshape(batch + (3,))
    T[..., 3, 3] = 1.0
    return T


def orthonormalize_pose(T: torch.Tensor) -> torch.Tensor:
    """Two Newton steps R <- 1.5 R - 0.5 R R^T R back onto SO(3), batched."""
    R = T[..., :3, :3]
    for _ in range(2):
        R = 1.5 * R - 0.5 * (R @ R.transpose(-1, -2) @ R)
    out = T.clone()
    out[..., :3, :3] = R
    return out


def pose_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse: [R t]^-1 = [R^T  -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t_inv = -(Rt @ T[..., :3, 3:4])[..., 0]
    return pose_from_rt(Rt, t_inv)


def pose_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Compose homogeneous transforms: A @ B, batched."""
    return A @ B


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def chain_relative_poses(rel_poses: torch.Tensor,
                         initial: torch.Tensor | None = None) -> torch.Tensor:
    """global[i] = initial @ rel[0] @ rel[1] @ ... @ rel[i] for (N, 4, 4) relative
    poses, as an inclusive prefix product in log2(N) batched steps (the JAX package
    uses an associative scan: the same products, grouped in another order)."""
    out = rel_poses
    step = 1
    while step < out.shape[0]:
        out = torch.cat([out[:step], out[:-step] @ out[step:]])
        step *= 2
    if initial is not None:
        out = torch.einsum("ij,njk->nik", initial, out)
    return out


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist [v, w] -> (..., 4, 4) pose."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    R = so3_exp(w)
    W = hat(w)
    W2 = W @ W
    # V = I + (1-cos t)/t^2 W + (t - sin t)/t^3 W^2
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS * _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / (theta2 * theta).clamp(min=_EPS * _EPS * _EPS))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(R.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ v[..., None])[..., 0]
    return pose_from_rt(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) pose -> (..., 6) twist [v, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    W = hat(w)
    W2 = W @ W
    # V^-1 = I - W/2 + (1/t^2 - (1+cos t)/(2 t sin t)) W^2
    half = theta * 0.5
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half).clamp(min=_EPS))
        / theta2.clamp(min=_EPS * _EPS))
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(R.shape)
    V_inv = eye - 0.5 * W + cot_term[..., None, None] * W2
    v = (V_inv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)
