"""SO(3) Lie-group operations on (..., 3) / (..., 3, 3) tensors.

Port of ``vo_tpu/geometry/so3.py``: the same formulas and small-angle guards.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis vector -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    rows = [
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew-symmetric matrix -> (..., 3) axis vector."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) tangent -> (..., 3, 3) rotation, Taylor-guarded near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) tangent; near-pi axis from diag(R + I)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w_raw = vee((R - R.transpose(-1, -2)) * 0.5)

    sin_theta = torch.sin(theta)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3

    scale_generic = torch.where(
        small, 1.0 + theta * theta / 6.0,
        theta / torch.where(sin_theta == 0, torch.ones_like(sin_theta), sin_theta))
    w_generic = scale_generic[..., None] * w_raw

    S = R + torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(S, -1, k[..., None, None].expand(*k.shape, 3, 1))[..., 0]
    axis = col / torch.linalg.vector_norm(col, dim=-1, keepdim=True).clamp(min=_EPS)
    sign = torch.where(torch.sum(axis * w_raw, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    w_pi = sign * axis * theta[..., None]

    return torch.where(near_pi[..., None], w_pi, w_generic)


# OpenCV-style names (rotation vector <-> matrix), as in the JAX package.
rodrigues = so3_exp
inv_rodrigues = so3_log
