"""Batched two-view DLT triangulation. Port of ``vo_tpu/geometry/triangulation.py``.

One (4, 4) homogeneous system per point, solved for all N points at once by a batched
SVD. On the card ``torch.linalg.svd`` checks its solver's status on the host, once per
call (a host sync).
"""

from __future__ import annotations

import torch

from vo_tpu_torch.device import device_for, to_device
from vo_tpu_torch.geometry.camera import normalize_kp


def _dlt_solve(A: torch.Tensor) -> torch.Tensor:
    """Solve A x = 0 per batch row: the null vector is the last right-singular vector,
    dehomogenised (its sign cancels in X / w). A row with a non-finite entry gives NaN,
    as in JAX (``torch.linalg.svd`` would raise on it)."""
    finite = torch.isfinite(A).all(dim=(-2, -1))
    _, _, vt = torch.linalg.svd(torch.where(finite[..., None, None], A, 0.0))
    X = vt[..., -1, :]
    w = X[..., 3:]
    w_safe = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return torch.where(finite[..., None], X[..., :3] / w_safe, torch.nan)


def triangulate(kp1, kp2, T_1w, T_2w, K, device: str | torch.device | None = None):
    """Triangulate pixel correspondences into world-frame 3D points, on ``device``
    (default: where ``kp1`` lies if it is a tensor, else cuda).

    kp1, kp2: (N, 2) pixels in views 1 and 2; T_1w, T_2w: (4, 4) world-to-view
    transforms; K: (3, 3). Returns (X_w, X_1, X_2): (N, 3) points in the world, view-1
    and view-2 frames.
    """
    dev = device_for(kp1, device)
    kp1, kp2, T_1w, T_2w, K = (to_device(x, dev, torch.float32)
                               for x in (kp1, kp2, T_1w, T_2w, K))
    n1 = normalize_kp(kp1, K)
    n2 = normalize_kp(kp2, K)
    P1 = T_1w[:3, :]   # (3, 4) normalised projection matrices
    P2 = T_2w[:3, :]

    def rows(n, P):
        # x * P[2] - P[0] = 0 ; y * P[2] - P[1] = 0
        return (n[..., 0:1] * P[2][None, :] - P[0][None, :],
                n[..., 1:2] * P[2][None, :] - P[1][None, :])

    a0, a1 = rows(n1, P1)
    b0, b1 = rows(n2, P2)
    A = torch.stack([a0, a1, b0, b1], dim=-2)   # (N, 4, 4)
    X_w = _dlt_solve(A)

    Xh = torch.cat([X_w, torch.ones_like(X_w[..., :1])], dim=-1)
    return X_w, (P1 @ Xh.T).T, (P2 @ Xh.T).T
