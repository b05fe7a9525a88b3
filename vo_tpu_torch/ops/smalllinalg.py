"""Small fixed-size linear algebra as unrolled element-wise tensor ops.

Port of ``vo_tpu/ops/smalllinalg.py`` with the same unrolled operation order, so the
pose solvers agree with the JAX package to fp32 rounding. Everything broadcasts over
leading batch axes.
"""

from __future__ import annotations

import math

import torch

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


def adjugate3x3(M: torch.Tensor) -> torch.Tensor:
    """Adjugate of (..., 3, 3): ``M @ adj = det(M) I``. With
    ``det = M00 adj00 + M01 adj10 + M02 adj20`` it gives the inverse without an LU
    (``torch.linalg.inv`` checks its status on the host, a sync)."""
    a = [[M[..., i, j] for j in range(3)] for i in range(3)]
    return torch.stack([
        torch.stack([a[1][1] * a[2][2] - a[1][2] * a[2][1],
                     a[0][2] * a[2][1] - a[0][1] * a[2][2],
                     a[0][1] * a[1][2] - a[0][2] * a[1][1]], dim=-1),
        torch.stack([a[1][2] * a[2][0] - a[1][0] * a[2][2],
                     a[0][0] * a[2][2] - a[0][2] * a[2][0],
                     a[0][2] * a[1][0] - a[0][0] * a[1][2]], dim=-1),
        torch.stack([a[1][0] * a[2][1] - a[1][1] * a[2][0],
                     a[0][1] * a[2][0] - a[0][0] * a[2][1],
                     a[0][0] * a[1][1] - a[0][1] * a[1][0]], dim=-1),
    ], dim=-2)


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
