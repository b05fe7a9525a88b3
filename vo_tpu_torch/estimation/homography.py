"""Plane homographies: batched DLT, RANSAC estimation, plane-induced depth.

Port of ``vo_tpu/estimation/homography.py``, batched over leading axes:

- ``homography_dlt``: the normalised, weighted DLT, solved as the smallest eigenvector
  of the 9x9 normal matrix (a batched ``eigh``; the vector's sign cancels in the
  H[2, 2] normalisation);
- ``homography_ransac``: a bank of 4-point DLT solves drawn with ``prng.randint``
  (the JAX package's samples), scored by the symmetric transfer error, the first best
  polished by IRLS rounds;
- ``plane_induced_depth``, ``plane_depth_reference_convention`` and
  ``homography_from_plane``.

Solves and inverses are ``solve_ex``/``inv_ex``: no host sync on the card, and the
results of ``solve``/``inv``. ``torch.linalg.eigh`` on the card checks its solver's
status on the host, once per call.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from vo_tpu_torch import prng
from vo_tpu_torch.device import device_for, to_device


def _inv(M: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(M)[0]


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Map (..., N, 2) points through (..., 3, 3) H (projective normalise)."""
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    q = torch.einsum("...ij,...nj->...ni", H, p)
    w = q[..., 2:3]
    return q[..., :2] / (w + 1e-12 * torch.sign(w + 1e-30))


def _normalize_pts(pts: torch.Tensor, w: torch.Tensor):
    """Hartley normalisation: zero mean, mean distance sqrt(2) (weighted)."""
    wsum = w.sum(-1, keepdim=True).clamp(min=1e-9)
    mean = (pts * w[..., None]).sum(-2, keepdim=True) / wsum[..., None]
    d = torch.linalg.vector_norm(pts - mean, dim=-1)
    scale = math.sqrt(2.0) / ((d * w).sum(-1, keepdim=True) / wsum).clamp(min=1e-9)
    s = scale[..., 0]
    z = torch.zeros_like(s)
    T = torch.stack([torch.stack([s, z, -s * mean[..., 0, 0]], dim=-1),
                     torch.stack([z, s, -s * mean[..., 0, 1]], dim=-1),
                     torch.stack([z, z, torch.ones_like(s)], dim=-1)], dim=-2)
    return (pts - mean) * scale[..., None], T


def homography_dlt(src: torch.Tensor, dst: torch.Tensor,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted normalised DLT: (..., N>=4, 2) x2 -> (..., 3, 3) with H[2, 2] = 1."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    sn, Ts = _normalize_pts(src, weights)
    dn, Td = _normalize_pts(dst, weights)

    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                                # (..., 2N, 9)
    w2 = torch.cat([weights, weights], dim=-1)
    AtA = torch.einsum("...ni,...n,...nj->...ij", A, w2, A)
    # A non-finite system gives NaN, as in JAX (torch.linalg.eigh would raise on it).
    finite = torch.isfinite(AtA).all(dim=(-2, -1))[..., None]
    _, vecs = torch.linalg.eigh(torch.where(finite[..., None], AtA, 0.0))
    h = torch.where(finite, vecs[..., 0], torch.nan)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    H = torch.linalg.solve_ex(Td, Hn @ Ts)[0]
    return H / (H[..., 2:3, 2:3] + 1e-12)


@dataclass(frozen=True)
class HomographyConfig:
    """The JAX package's HomographyConfig: same fields, same defaults."""

    n_hypotheses: int = 256
    inlier_px: float = 3.0        # symmetric transfer error threshold
    refine_iters: int = 3         # IRLS re-weighted DLT polish rounds
    min_inliers: int = 8


class HomographyResult(NamedTuple):
    H: torch.Tensor          # (3, 3)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool


def _sym_transfer_err(H, src, dst):
    fwd = torch.linalg.vector_norm(apply_homography(H, src) - dst, dim=-1)
    bwd = torch.linalg.vector_norm(apply_homography(_inv(H), dst) - src, dim=-1)
    return fwd + bwd


def homography_ransac(key, src, dst, valid, cfg: HomographyConfig = HomographyConfig(),
                      device: str | torch.device | None = None) -> HomographyResult:
    """Fixed-shape RANSAC homography from (N, 2) correspondences with a validity mask,
    on ``device`` (default: where ``src`` lies if it is a tensor, else cuda).

    A bank of ``n_hypotheses`` 4-point DLT solves, scored by the symmetric transfer
    error over all points at once, then IRLS polish on the first best one's inliers.
    """
    dev = device_for(src, device)
    key = to_device(key, dev, torch.int64)
    src, dst = to_device(src, dev, torch.float32), to_device(dst, dev, torch.float32)
    valid = to_device(valid, dev, torch.bool)
    N = src.shape[0]
    w = valid.to(src.dtype)
    thr = 2 * cfg.inlier_px

    idx = prng.randint(key, (cfg.n_hypotheses, 4), 0, N).long()
    Hs = homography_dlt(src[idx], dst[idx])                        # (Hyp, 3, 3)

    err = _sym_transfer_err(Hs[:, None], src[None], dst[None])     # (Hyp, N)
    scores = ((err < thr) & valid[None]).sum(-1)
    H = Hs.index_select(0, torch.argmax(scores).reshape(1))[0]

    for _ in range(cfg.refine_iters):
        wgt = w * (_sym_transfer_err(H, src, dst) < thr)
        H = homography_dlt(src, dst, wgt)

    inliers = (_sym_transfer_err(H, src, dst) < thr) & valid
    n = inliers.sum().to(torch.int32)
    return HomographyResult(H=H, inliers=inliers, n_inliers=n, ok=n >= cfg.min_inliers)


def plane_induced_depth(kp: torch.Tensor, K: torch.Tensor, normal: torch.Tensor,
                        dist) -> torch.Tensor:
    """Depth (camera z) of pixels (..., N, 2) on the plane n . X = d (camera frame).

    Each pixel's ray is r = K^-1 [u, v, 1] (r_z = 1), met by the plane at
    lambda = d / (n . r). Returns (..., N); 0 where the ray is (near-)parallel.
    """
    ones = torch.ones_like(kp[..., :1])
    rays = torch.einsum("ij,...nj->...ni", _inv(K), torch.cat([kp, ones], dim=-1))
    denom = torch.einsum("...ni,i->...n", rays, normal)
    return torch.where(torch.abs(denom) > 1e-9, dist / denom, 0.0)


def plane_depth_reference_convention(H_plane: torch.Tensor, kp: torch.Tensor,
                                     divisor: float = 100.0) -> torch.Tensor:
    """The reference notebook's road-depth rule: lift pixels through H^-1, normalise by
    |last coordinate|, and read depth as |x| / divisor."""
    ones = torch.ones_like(kp[..., :1])
    q = torch.einsum("ij,...nj->...ni", _inv(H_plane), torch.cat([kp, ones], dim=-1))
    qn = q / torch.abs(q[..., 2:3]).clamp(min=1e-12)
    return torch.abs(qn[..., 0]) / divisor


def homography_from_plane(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                          normal: torch.Tensor, dist) -> torch.Tensor:
    """H = K (R + t n^T / d) K^-1: maps view-1 pixels of points on the plane
    n . X1 = d to view 2, for X2 = R X1 + t."""
    return K @ (R + torch.outer(t, normal) / dist) @ _inv(K)
