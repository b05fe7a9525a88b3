"""The replay cell's plain reference, geometry half: threefry draws, small fixed-size
linear algebra, SO(3) / SE(3), Kabsch and PnP-RANSAC in plain torch.

A frozen copy of the port's plain versions (its ``prng``, ``ops/smalllinalg``,
``geometry/so3``, ``geometry/se3``, ``estimation/procrustes`` and
``estimation/pnp``), kept here so that the yardstick does not move when the program
does. It imports nothing of the program. Everything runs in the dtype of its inputs;
the fp32 matrix products keep TF32 off unless the caller turns it on (the control).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

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


def uniform(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in fp32 over [0, 1): (...,) + shape."""
    n = math.prod(shape)
    hi, lo = _counters(n, k.device)
    b1, b2 = threefry2x32(k[..., 0, None], k[..., 1, None], hi, lo)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000          # below 2**31: exact in int32
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats.reshape(k.shape[:-1] + tuple(shape)), min=0.0)


_EPS = 1e-12


def _unit(i: int, like: torch.Tensor) -> torch.Tensor:
    """The i-th unit vector, broadcast to ``like``'s shape. Built on the device: writing
    a Python number into a CUDA tensor copies it up from the host, a sync."""
    eye = torch.eye(like.shape[-1], dtype=like.dtype, device=like.device)
    return eye[i].expand(like.shape)


def cholesky_small(A: torch.Tensor, n: int) -> torch.Tensor:
    """Unrolled Cholesky of (..., n, n) SPD matrices (lower triangular)."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=_EPS))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s2 = A[..., i, j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 * inv_d
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
            for i in range(n)]
    return torch.stack(rows, dim=-2)


def cho_solve_small(L: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Solve A x = b given L = cholesky_small(A). b: (..., n)."""
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def solve_spd_small(A: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """A^{-1} b for SPD (..., n, n) via unrolled Cholesky."""
    return cho_solve_small(cholesky_small(A, n), b, n)


def det3x3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactor expansion along the first row."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def eigh3x3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form symmetric 3x3 eigendecomposition (Cardano).

    Returns (w, V): eigenvalues ascending (..., 3), eigenvectors as columns (..., 3, 3).
    """
    a00 = A[..., 0, 0]; a11 = A[..., 1, 1]; a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]; a02 = A[..., 0, 2]; a12 = A[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))
    inv_p = 1.0 / p
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02)) * (inv_p ** 3)
    r = torch.clamp(detB * 0.5, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    w2 = q + 2.0 * p * torch.cos(phi)                        # largest
    w0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    w1 = 3.0 * q - w2 - w0

    def eigvec(lmbda, other):
        r0 = torch.stack([a00 - lmbda, a01, a02], dim=-1)
        r1 = torch.stack([a01, a11 - lmbda, a12], dim=-1)
        r2 = torch.stack([a02, a12, a22 - lmbda], dim=-1)
        c01 = torch.linalg.cross(r0, r1)
        c02 = torch.linalg.cross(r0, r2)
        c12 = torch.linalg.cross(r1, r2)
        n01 = torch.sum(c01 * c01, dim=-1, keepdim=True)
        n02 = torch.sum(c02 * c02, dim=-1, keepdim=True)
        n12 = torch.sum(c12 * c12, dim=-1, keepdim=True)
        best = torch.where(n01 >= torch.maximum(n02, n12), c01,
                           torch.where(n02 >= n12, c02, c12))
        norm2 = torch.sum(best * best, dim=-1, keepdim=True)
        # Degenerate (repeated eigenvalue): pick anything orthogonal to `other`.
        alt = torch.linalg.cross(other, _unit(0, best))
        alt_n2 = torch.sum(alt * alt, dim=-1, keepdim=True)
        alt = torch.where(alt_n2 > 1e-8, alt, torch.linalg.cross(other, _unit(1, best)))
        v = torch.where(norm2 < 1e-18, alt, best)
        return v / _norm(v).clamp(min=_EPS)

    v2 = eigvec(w2, _unit(0, torch.zeros(A.shape[:-2] + (3,), dtype=A.dtype,
                                         device=A.device)))
    v0 = eigvec(w0, v2)
    v0 = v0 - torch.sum(v0 * v2, dim=-1, keepdim=True) * v2
    v0 = v0 / _norm(v0).clamp(min=_EPS)
    v1 = torch.linalg.cross(v2, v0)

    w = torch.stack([w0, w1, w2], dim=-1)
    V = torch.stack([v0, v1, v2], dim=-1)  # columns
    return w, V


def svd3x3(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD of (..., 3, 3): H = U diag(S) V^T, S descending, U/V orthogonal (det +-1)."""
    AtA = H.transpose(-1, -2) @ H
    w, V_asc = eigh3x3(AtA)
    S = torch.sqrt(torch.clamp(w.flip(-1), min=0.0))
    V = V_asc.flip(-1)
    U_raw = H @ V
    c0, c1, c2 = U_raw[..., :, 0], U_raw[..., :, 1], U_raw[..., :, 2]
    u0 = c0 / _norm(c0).clamp(min=1e-9)
    c1o = c1 - torch.sum(c1 * u0, dim=-1, keepdim=True) * u0
    n1o = _norm(c1o)
    fallback1 = torch.linalg.cross(u0, _unit(2, u0))
    fallback1b = torch.linalg.cross(u0, _unit(1, u0))
    fallback1 = torch.where(_norm(fallback1) > 1e-6, fallback1, fallback1b)
    fallback1 = fallback1 / _norm(fallback1).clamp(min=_EPS)
    u1 = torch.where(n1o > 1e-8, c1o / n1o.clamp(min=_EPS), fallback1)
    u2 = torch.linalg.cross(u0, u1)
    sgn = torch.sign(torch.sum(c2 * u2, dim=-1, keepdim=True))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    u2 = u2 * sgn
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, S, V.transpose(-1, -2)


def smallest_eigvec(AtA: torch.Tensor, n: int, iters: int = 8) -> torch.Tensor:
    """Smallest-eigenvalue eigenvector of SPD (..., n, n) by inverse iteration."""
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    ridge = 1e-10 * tr + 1e-12
    L = cholesky_small(AtA + ridge * torch.eye(n, dtype=AtA.dtype, device=AtA.device), n)
    x = torch.ones(AtA.shape[:-2] + (n,), dtype=AtA.dtype, device=AtA.device)
    for _ in range(iters):
        x = cho_solve_small(L, x, n)
        # max-abs prescale keeps norm^2 finite in fp32 on near-singular solves.
        x = x / torch.amax(torch.abs(x), dim=-1, keepdim=True).clamp(min=_EPS)
        x = x / _norm(x).clamp(min=_EPS)
    return x


_EPS_SE3 = 1e-8


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


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) tangent -> (..., 3, 3) rotation, Taylor-guarded near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS_SE3 * _EPS_SE3)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS_SE3 * _EPS_SE3))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def pose_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4) homogeneous pose."""
    batch = R.shape[:-2]
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t.reshape(batch + (3,))
    T[..., 3, 3].fill_(1.0)      # no ``= 1.0``: that copies the number up, a host sync
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


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist [v, w] -> (..., 4, 4) pose."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS_SE3 * _EPS_SE3)
    small = theta2 < 1e-8
    R = so3_exp(w)
    W = hat(w)
    W2 = W @ W
    # V = I + (1-cos t)/t^2 W + (t - sin t)/t^3 W^2
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=_EPS_SE3 * _EPS_SE3))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / (theta2 * theta).clamp(min=_EPS_SE3 * _EPS_SE3 * _EPS_SE3))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(R.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ v[..., None])[..., 0]
    return pose_from_rt(R, t)


def kabsch(A: torch.Tensor, B: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """Rigid transform from A to B: (..., 4, 4) T with B ~= R A + t.

    A, B: (..., m, 3) corresponding points; w: optional (..., m) weights.
    """
    if w is None:
        w = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    wsum = torch.sum(w, dim=-1, keepdim=True) + 1e-12
    ca = torch.sum(A * w[..., None], dim=-2) / wsum
    cb = torch.sum(B * w[..., None], dim=-2) / wsum
    A0 = A - ca[..., None, :]
    B0 = B - cb[..., None, :]
    H = torch.einsum("...mi,...mj,...m->...ij", A0, B0, w)
    U, _, Vt = svd3x3(H)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    # Proper rotation (det +1): flip the smallest singular direction if needed.
    D = torch.eye(3, dtype=A.dtype, device=A.device).expand(H.shape).clone()
    D[..., 2, 2] = det3x3(V @ Ut)
    R = V @ D @ Ut
    t = cb - (R @ ca[..., None])[..., 0]
    return pose_from_rt(R, t)


@dataclass(frozen=True)
class PnPConfig:
    """The JAX package's PnPConfig: same fields, same defaults."""

    n_hypotheses: int = 512
    sample_size: int = 6
    reproj_threshold: float = 1.5
    min_inliers: int = 20
    gn_iterations: int = 10
    min_depth: float = 1e-3
    min_inliers_floor: int = 8
    accept_ratio: float = 0.6
    anneal: tuple = (64.0, 32.0, 16.0, 8.0, 4.0, 2.0)


class PnPResult(NamedTuple):
    pose: torch.Tensor       # (4, 4) keyframe-camera -> current-camera transform
    inliers: torch.Tensor    # (N,) bool at the returned pose
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor without reading it back to the host (indexing
    with a 0-d CUDA tensor reads it, a host sync)."""
    return x.index_select(0, i.reshape(1))[0]


def _sample_indices(key: torch.Tensor, valid: torch.Tensor, n_hyp: int, m: int) -> torch.Tensor:
    """(n_hyp, m) indices drawn uniformly from the valid entries, with replacement."""
    order = torch.sort((~valid).to(torch.uint8), stable=True).indices  # valid first
    n_valid = torch.clamp(valid.sum(), min=1)
    u = uniform(key, (n_hyp, m))
    slot = torch.minimum((u * n_valid).to(torch.int64), n_valid - 1)
    return order[slot]


def _dlt_pose(X: torch.Tensor, x_norm: torch.Tensor) -> torch.Tensor:
    """Batched normalised DLT: X (H, m, 3), x_norm (H, m, 2) -> (H, 4, 4) poses."""
    m = X.shape[-2]
    c = X.mean(dim=-2, keepdim=True)
    scale = torch.sqrt(torch.mean(torch.sum((X - c) ** 2, dim=-1), dim=-1)) + 1e-9
    Xn = (X - c) / scale[..., None, None]
    Xh = torch.cat([Xn, torch.ones_like(Xn[..., :1])], dim=-1)       # (H, m, 4)
    zeros = torch.zeros_like(Xh)
    u = x_norm[..., 0:1]
    v = x_norm[..., 1:2]
    rows_u = torch.cat([Xh, zeros, -u * Xh], dim=-1)                 # (H, m, 12)
    rows_v = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)                          # (H, 2m, 12)

    AtA = A.transpose(-1, -2) @ A
    p = smallest_eigvec(AtA, 12)
    P = p.reshape(p.shape[:-1] + (3, 4))

    # Undo conditioning: P_full = P @ [[I/s, -c/s], [0, 1]]
    T = torch.eye(4, dtype=X.dtype, device=X.device).repeat(X.shape[:-2] + (1, 1))
    T[..., :3, :3] = T[..., :3, :3] / scale[..., None, None]
    T[..., :3, 3] = -c[..., 0, :] / scale[..., None]
    P = P @ T

    sign = torch.sign(det3x3(P[..., :3]))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    P = P * sign[..., None, None]
    U, S, Vt = svd3x3(P[..., :3])
    R = U @ Vt
    s = torch.mean(S, dim=-1) + 1e-12
    t = P[..., 3] / s[..., None]
    return pose_from_rt(R, t)


def _reproject_residuals(pose, X, x_px, K):
    """(..., N) pixel residual norms + camera-frame depth."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3]
    Y = torch.einsum("...ij,nj->...ni", R, X) + t[..., None, :]
    z = Y[..., 2]
    z_safe = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = K[0, 0] * Y[..., 0] / z_safe + K[0, 2]
    v = K[1, 1] * Y[..., 1] / z_safe + K[1, 2]
    res = torch.sqrt((u - x_px[..., :, 0]) ** 2 + (v - x_px[..., :, 1]) ** 2)
    return res, z


def _gn_refine(pose, X, x_px, valid, K, cfg: PnPConfig, thresholds=None):
    """Fixed-iteration reweighted Gauss-Newton over SE(3), masked (no gathers).

    ``thresholds``: per-iteration inlier cutoffs in px; default repeats
    cfg.reproj_threshold (a tight polish). A wide-to-tight schedule turns the same
    loop into a wide-basin solver.
    """
    fx, fy = K[0, 0], K[1, 1]
    if thresholds is None:
        thresholds = [cfg.reproj_threshold] * cfg.gn_iterations
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device).expand(X.shape[0], 3, 3)
    for thr in thresholds:
        R = pose[:3, :3]
        t = pose[:3, 3]
        Y = X @ R.T + t
        z = Y[:, 2]
        z_ok = z > cfg.min_depth
        z_safe = torch.where(z_ok, z, torch.ones_like(z))
        u = fx * Y[:, 0] / z_safe + K[0, 2]
        v = fy * Y[:, 1] / z_safe + K[1, 2]
        r = torch.stack([u - x_px[:, 0], v - x_px[:, 1]], dim=-1)          # (N, 2)
        res_norm = torch.linalg.vector_norm(r, dim=-1)
        w = (valid & z_ok & (res_norm < thr)).to(X.dtype)

        zinv = 1.0 / z_safe
        zero = torch.zeros_like(zinv)
        J_proj = torch.stack([
            torch.stack([fx * zinv, zero, -fx * Y[:, 0] * zinv * zinv], dim=-1),
            torch.stack([zero, fy * zinv, -fy * Y[:, 1] * zinv * zinv], dim=-1),
        ], dim=-2)                                                         # (N, 2, 3)
        J_pose = torch.cat([eye3, -hat(Y)], dim=-1)                        # (N, 3, 6)
        J = J_proj @ J_pose                                                # (N, 2, 6)

        JTJ = torch.einsum("nik,nij,n->kj", J, J, w) + 1e-6 * eye6
        JTr = torch.einsum("nik,ni,n->k", J, r, w)
        delta = -solve_spd_small(JTJ, JTr, 6)
        delta = torch.where(w.sum() >= 4, delta, torch.zeros_like(delta))
        pose = se3_exp(delta) @ pose
    return pose


def pnp_ransac(
    key: torch.Tensor,
    points_3d: torch.Tensor,
    points_2d: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    cfg: PnPConfig = PnPConfig(),
    points_3d_cur: torch.Tensor | None = None,
    valid_cur: torch.Tensor | None = None,
) -> PnPResult:
    """Object->camera pose from fixed-budget 3D-2D correspondences.

    key: threefry key (2,) int64 (``fold_in(key(8214), frame_id)``).
    points_3d (N, 3) keyframe-camera points, points_2d (N, 2) current pixels,
    valid (N,) mask, K (3, 3). points_3d_cur / valid_cur (rgbd) enable the Kabsch bank.
    """
    x_norm = torch.stack([
        (points_2d[:, 0] - K[0, 2]) / K[0, 0],
        (points_2d[:, 1] - K[1, 2]) / K[1, 1],
    ], dim=-1)

    if points_3d_cur is None:
        idx = _sample_indices(key, valid, cfg.n_hypotheses, cfg.sample_size)
        hyp_poses = _dlt_pose(points_3d[idx], x_norm[idx])
    else:
        n_kab = (3 * cfg.n_hypotheses) // 4
        n_dlt = cfg.n_hypotheses - n_kab
        v_cur = valid & valid_cur if valid_cur is not None else valid
        k1, k2 = split(key)
        idx_k = _sample_indices(k1, v_cur, n_kab, 3)
        hyp_kab = kabsch(points_3d[idx_k], points_3d_cur[idx_k])
        idx_d = _sample_indices(k2, valid, n_dlt, cfg.sample_size)
        hyp_dlt = _dlt_pose(points_3d[idx_d], x_norm[idx_d])
        hyp_poses = torch.cat([hyp_kab, hyp_dlt], dim=0)

    res, z = _reproject_residuals(hyp_poses, points_3d, points_2d, K)     # (H, N)
    inl = (res < cfg.reproj_threshold) & (z > cfg.min_depth) & valid[None, :]
    counts = inl.sum(dim=-1)
    best = torch.argmax(counts)
    best_pose, best_count, best_inl = (_pick(x, best) for x in (hyp_poses, counts, inl))

    if cfg.anneal:
        # The JAX package skips the identity-seeded annealed candidate with a lax.cond
        # unless the banks are weak. Here it is always computed and then selected, so
        # that no value goes back to the host; the result is that of the cond.
        n_avail0 = valid.sum()
        bank_weak = (best_count < 0.5 * n_avail0) | (n_avail0 < 64)
        anneal = list(cfg.anneal) + [float(cfg.reproj_threshold)] * 4
        eye4 = torch.eye(4, dtype=points_3d.dtype, device=points_3d.device)
        pose_id = _gn_refine(eye4, points_3d, points_2d, valid, K, cfg, thresholds=anneal)
        res_i, z_i = _reproject_residuals(pose_id, points_3d, points_2d, K)
        inl_i = (res_i < cfg.reproj_threshold) & (z_i > cfg.min_depth) & valid
        pose_id = torch.where(bank_weak, pose_id, best_pose)
        count_i = torch.where(bank_weak, inl_i.sum(), best_count)
        inl_i = torch.where(bank_weak, inl_i, best_inl)

        use_id = count_i > best_count
        pose0 = torch.where(use_id, pose_id, best_pose)
        best_count = torch.maximum(best_count, count_i)
        best_inl = torch.where(use_id, inl_i, best_inl)
    else:
        pose0 = best_pose

    pose = _gn_refine(pose0, points_3d, points_2d, valid, K, cfg)

    res_f, z_f = _reproject_residuals(pose, points_3d, points_2d, K)
    inliers = (res_f < cfg.reproj_threshold) & (z_f > cfg.min_depth) & valid
    n_inliers = inliers.sum()
    # Keep whichever of {refined, best candidate} scores higher.
    better = n_inliers >= best_count
    pose = torch.where(better, pose, pose0)
    inliers = torch.where(better, inliers, best_inl)
    n_inliers = torch.maximum(n_inliers, best_count).to(torch.int32)

    n_avail = valid.sum()
    ratio_ok = ((n_inliers >= cfg.min_inliers_floor)
                & (n_inliers >= cfg.accept_ratio * n_avail))
    ok = (n_inliers > cfg.min_inliers) | ratio_ok
    return PnPResult(pose=pose, inliers=inliers, n_inliers=n_inliers, ok=ok)
