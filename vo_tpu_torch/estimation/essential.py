"""Essential-matrix RANSAC and pose recovery: the monocular front-end, on the device.

Port of ``vo_tpu/estimation/essential.py``, shaped like the PnP solver (fixed shapes,
hypothesis banks, masked scoring):

- hypotheses: a bank of Cauchy-IRLS least-squares E fits on 48-point samples (the null
  vector of each 9x9 normal matrix by inverse iteration, ``smallest_eigvec``),
  projected onto the essential manifold by ``svd3x3``; the bank is one batch over the
  hypothesis axis, with no loop over hypotheses;
- scoring: the Sampson distance of every correspondence under every hypothesis;
- polish: the best hypotheses (a stable descending sort of the inlier counts, the
  order of ``lax.top_k``) start a Gauss-Newton on the 5-dof (R, unit t) manifold, all
  starts in one batch; the JAX package's ``jax.jacfwd`` of the Sampson residual is
  written out analytically (``_residual_and_jacobian``); the winner gets two
  hard-gated rounds;
- pose recovery: the 4 (R, t) decompositions scored by cheirality over the inliers.

Nothing here reads a value back to the host, and no constant is copied up from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from vo_tpu_torch import prng
from vo_tpu_torch.device import device_for, to_device
from vo_tpu_torch.estimation.pnp import _pick, _sample_indices
from vo_tpu_torch.geometry.se3 import pose_from_rt
from vo_tpu_torch.geometry.so3 import hat, so3_exp
from vo_tpu_torch.ops.smalllinalg import det3x3, smallest_eigvec, solve_spd_small, svd3x3


@dataclass(frozen=True)
class EssentialConfig:
    """The JAX package's EssentialConfig: same fields, same defaults."""

    n_hypotheses: int = 128
    sample_size: int = 48             # "fat RANSAC": minimal 8-point fits are unstable
    irls_rounds: int = 4              # Cauchy IRLS rounds inside each hypothesis
    sampson_threshold: float = 2e-6   # squared, on normalised coords (~1 px at f=700)
    polish_starts: int = 8            # top-K hypotheses fed to the manifold GN polish
    polish_iters: int = 15            # GN iterations per start
    min_inliers: int = 20


class EssentialResult(NamedTuple):
    E: torch.Tensor          # (3, 3)
    pose: torch.Tensor       # (4, 4): x2 ~ R x1 + t (unit-norm t, scale-free)
    inliers: torch.Tensor    # (N,)
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _epipolar_design(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(..., m, 9) design rows of the epipolar constraint x2^T E x1 = 0."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], dim=-1)


def _project_essential(e: torch.Tensor) -> torch.Tensor:
    """(..., 9) -> (..., 3, 3) on the essential manifold (singular values (s, s, 0))."""
    U, S, Vt = svd3x3(e.reshape(e.shape[:-1] + (3, 3)))
    s = (S[..., 0] + S[..., 1]) * 0.5
    # U diag(1, 1, 0) V^T: the products with 1 and 0 are exact.
    return U[..., :, :2] @ Vt[..., :2, :] * s[..., None, None]


def _eight_point(x1: torch.Tensor, x2: torch.Tensor,
                 w: torch.Tensor | None = None) -> torch.Tensor:
    """(Weighted) LS essential matrix from (..., m, 2) normalised correspondences,
    projected onto the manifold; batched over leading axes."""
    A = _epipolar_design(x1, x2)
    Aw = A if w is None else A * w[..., None]
    return _project_essential(smallest_eigvec(Aw.transpose(-1, -2) @ A, 9))


def _sampson_dist(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance of (..., N, 2) normalised points under (..., 3, 3) E."""
    p1, p2 = _homogeneous(x1), _homogeneous(x2)
    Ex1 = torch.einsum("...ij,...nj->...ni", E, p1)
    Etx2 = torch.einsum("...ji,...nj->...ni", E, p2)
    x2tEx1 = torch.sum(p2 * Ex1, dim=-1)
    denom = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
             + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return x2tEx1 ** 2 / denom.clamp(min=1e-12)


def _irls_essential(x1s: torch.Tensor, x2s: torch.Tensor, rounds: int,
                    sigma2: float) -> torch.Tensor:
    """Cauchy-IRLS essential fit on (..., m, 2) samples, batched over hypotheses."""
    E = _eight_point(x1s, x2s)
    for _ in range(rounds):
        d = _sampson_dist(E, x1s, x2s)
        E = _eight_point(x1s, x2s, 1.0 / (1.0 + d / sigma2))
    return E


def _midpoint_depths(R, t, x1, x2):
    """Depths (d1, d2) along both rays of each correspondence, for cheirality: the
    least-squares solution of [R p1, -p2] [d1, d2]^T = -t (2x2 normal equations).
    R (..., 3, 3), t (..., 3), x (N, 2) -> (..., N) each."""
    f1, f2 = _homogeneous(x1), _homogeneous(x2)
    a = torch.einsum("...ij,nj->...ni", R, f1)
    b = -f2
    aa = torch.sum(a * a, -1)
    ab = torch.sum(a * b, -1)
    bb = torch.sum(b * b, -1)
    at = -torch.einsum("...ni,...i->...n", a, t)
    bt = -torch.einsum("ni,...i->...n", b, t)
    det = (aa * bb - ab * ab).clamp(min=1e-12)
    return (at * bb - ab * bt) / det, (aa * bt - ab * at) / det


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit t -> (..., 3, 2) orthonormal basis of its tangent plane."""
    c = (torch.abs(t[..., 0]) < 0.9).to(t.dtype)     # a = e_x if |t_x| < 0.9, else e_y
    a = torch.stack([c, 1.0 - c, torch.zeros_like(c)], dim=-1)
    b1 = torch.linalg.cross(t, a)
    b1 = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True).clamp(min=1e-9)
    b2 = torch.linalg.cross(t, b1)
    return torch.stack([b1, b2], dim=-1)


def _residual_and_jacobian(R, t, B, p1, p2):
    """Signed Sampson residuals r (..., N) of (R, t) and their Jacobian J (..., N, 5)
    with respect to (dw, db) at 0, where R <- exp(dw) R and t <- normalize(t + B db).

    At 0 the derivatives of E = [t]x R are [t]x [e_k]x R (k = 0..2) and [B_j]x R
    (B is orthonormal to the unit t), and r = x2^T E x1 / |(E x1)_01, (E^T x2)_01|
    differentiates by the quotient rule: one batch of 5 directions, no autodiff."""
    E = hat(t) @ R                                                    # (..., 3, 3)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    dR = hat(eye) @ R[..., None, :, :]                                # (..., 3, 3, 3)
    dE = torch.cat([hat(t)[..., None, :, :] @ dR,
                    hat(B.transpose(-1, -2)) @ R[..., None, :, :]], dim=-3)  # (..., 5, 3, 3)
    Ex1 = p1 @ E.transpose(-1, -2)                                    # (..., N, 3)
    Etx2 = p2 @ E
    num = torch.sum(p2 * Ex1, dim=-1)
    den = torch.sqrt((Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
                      + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2).clamp(min=1e-12))
    r = num / den
    dEx1 = p1 @ dE.transpose(-1, -2)                                  # (..., 5, N, 3)
    dEtx2 = p2 @ dE
    dnum = torch.sum(p2 * dEx1, dim=-1)                               # (..., 5, N)
    dden = (Ex1[..., None, :, 0] * dEx1[..., 0] + Ex1[..., None, :, 1] * dEx1[..., 1]
            + Etx2[..., None, :, 0] * dEtx2[..., 0]
            + Etx2[..., None, :, 1] * dEtx2[..., 1]) / den[..., None, :]
    J = (dnum - r[..., None, :] * dden) / den[..., None, :]
    return r, J.transpose(-1, -2)


def _refine_pose_sampson(R0, t0, x1, x2, valid_w, sigma2: float = 1e-5,
                         iters: int = 10):
    """Fixed-iteration Gauss-Newton on the 5-dof (R, unit t) manifold minimising the
    Cauchy-weighted Sampson error, for S starts at once: R0 (S, 3, 3), t0 (S, 3),
    valid_w (N,) or (S, N) weights. R <- exp(dw) R, t <- normalize(t + B db) with B an
    orthonormal basis of t's tangent plane; 5x5 unrolled Cholesky solve."""
    p1, p2 = _homogeneous(x1), _homogeneous(x2)
    eye5 = torch.eye(5, dtype=R0.dtype, device=R0.device)
    R, t = R0, t0
    for _ in range(iters):
        B = _tangent_basis(t)
        r, J = _residual_and_jacobian(R, t, B, p1, p2)
        # Cauchy IRLS: soft robust weights recomputed each iteration.
        w = valid_w / (1.0 + (r * r) / sigma2)
        JTJ = torch.einsum("...ni,...nj,...n->...ij", J, J, w) + 1e-9 * eye5
        JTr = torch.einsum("...ni,...n->...i", J, r * w)
        delta = -solve_spd_small(JTJ, JTr, 5)
        R = so3_exp(delta[..., :3]) @ R
        t = t + (B @ delta[..., 3:, None])[..., 0]
        t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp(min=1e-9)
    return R, t


def _uw(U: torch.Tensor) -> torch.Tensor:
    """U @ W with W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]: columns (u1, -u0, u2)."""
    return torch.stack([U[..., 1], -U[..., 0], U[..., 2]], dim=-1)


def _uwt(U: torch.Tensor) -> torch.Tensor:
    """U @ W^T: columns (-u1, u0, u2)."""
    return torch.stack([-U[..., 1], U[..., 0], U[..., 2]], dim=-1)


def _detfix(R: torch.Tensor) -> torch.Tensor:
    """R * sign(det R) (sign(0) = 0, as in JAX); cofactor determinant, no LU."""
    return R * torch.sign(det3x3(R))[..., None, None]


def essential_ransac(key, kp1, kp2, valid, K, cfg: EssentialConfig = EssentialConfig(),
                     device: str | torch.device | None = None) -> EssentialResult:
    """E and the relative pose (view 1 -> view 2, |t| = 1) from (N, 2) pixel matches,
    on ``device`` (default: where ``kp1`` lies if it is a tensor, else cuda)."""
    dev = device_for(kp1, device)
    key = to_device(key, dev, torch.int64)
    kp1, kp2, K = (to_device(x, dev, torch.float32) for x in (kp1, kp2, K))
    valid = to_device(valid, dev, torch.bool)
    thr = cfg.sampson_threshold

    def normalise(kp):
        return torch.stack([(kp[:, 0] - K[0, 2]) / K[0, 0],
                            (kp[:, 1] - K[1, 2]) / K[1, 1]], dim=-1)

    x1, x2 = normalise(kp1), normalise(kp2)
    idx = _sample_indices(key, valid, cfg.n_hypotheses, cfg.sample_size)
    E_hyp = _irls_essential(x1[idx], x2[idx], cfg.irls_rounds, thr)    # (H, 3, 3)

    counts = ((_sampson_dist(E_hyp, x1, x2) < thr) & valid[None, :]).sum(-1)
    # Multi-start manifold polish from the top-K hypotheses (lax.top_k's order: a
    # stable descending sort), each start with R from U W V^T and from U W^T V^T.
    top = torch.sort(counts, descending=True, stable=True).indices[:cfg.polish_starts]
    E_top = E_hyp[top]
    U, _, Vt = svd3x3(torch.cat([E_top, E_top], dim=0))
    S = cfg.polish_starts
    R0 = _detfix(torch.cat([_uw(U[:S]) @ Vt[:S], _uwt(U[S:]) @ Vt[S:]]))
    R_pol, t_pol = _refine_pose_sampson(R0, U[..., :, 2], x1, x2, valid.float(),
                                        sigma2=thr, iters=cfg.polish_iters)
    cnt = ((_sampson_dist(hat(t_pol) @ R_pol, x1, x2) < thr) & valid).sum(-1)
    bi = torch.argmax(cnt)
    R_best, t_best = _pick(R_pol, bi)[None], _pick(t_pol, bi)[None]

    # Two rounds on the winner with hard inlier gating: once the basin is right the
    # consensus set is nearly clean, and dropping the outliers removes their bias.
    for _ in range(2):
        hard = (_sampson_dist(hat(t_best) @ R_best, x1, x2) < thr) & valid
        R_best, t_best = _refine_pose_sampson(R_best, t_best, x1, x2, hard.float(),
                                              sigma2=thr, iters=cfg.polish_iters)
    E = (hat(t_best) @ R_best)[0]
    inliers = (_sampson_dist(E, x1, x2) < thr) & valid

    # The 4-fold (R, t) ambiguity of the refined E, resolved by cheirality.
    U, _, Vt = svd3x3(E)
    R1 = _detfix(_uw(U) @ Vt)
    R2 = _detfix(_uwt(U) @ Vt)
    t0 = U[:, 2]
    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([t0, -t0, t0, -t0])
    d1, d2 = _midpoint_depths(cands_R, cands_t, x1, x2)
    ci = torch.argmax(((d1 > 0) & (d2 > 0) & inliers).sum(-1))
    pose = pose_from_rt(_pick(cands_R, ci), _pick(cands_t, ci))

    n_inl = inliers.sum().to(torch.int32)
    return EssentialResult(E=E, pose=pose, inliers=inliers, n_inliers=n_inl,
                           ok=n_inl > cfg.min_inliers)


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D tensor: the mean of the two middle non-NaN values for
    an even count (``torch.nanmedian`` returns the lower one), NaN when all are NaN.
    The linear interpolation of JAX's quantile, on the device."""
    a = torch.sort(x).values                         # NaN sorts last
    n = (~torch.isnan(a)).sum().to(x.dtype)
    q = 0.5 * (n - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w
    low = torch.clamp(torch.minimum(low, n - 1.0), min=0.0).long().reshape(1)
    high = torch.clamp(torch.minimum(high, n - 1.0), min=0.0).long().reshape(1)
    return (a.index_select(0, low) * low_w + a.index_select(0, high) * high_w)[0]


def relative_scale(key, pts_a, pts_b, valid, n_pairs: int = 4096,
                   inlier_ratio_band: float = 0.1,
                   device: str | torch.device | None = None) -> torch.Tensor:
    """Robust scale s with |pts_b| distances ~= s * |pts_a| distances, on ``device``
    (default: where ``pts_a`` lies if it is a tensor, else cuda).

    Point pairs are sampled, their distance ratios taken, the median found, then a
    least-squares fit through the origin over the ratios within a band of it.
    """
    dev = device_for(pts_a, device)
    key = to_device(key, dev, torch.int64)
    pts_a, pts_b = to_device(pts_a, dev, torch.float32), to_device(pts_b, dev, torch.float32)
    valid = to_device(valid, dev, torch.bool)
    k1, k2 = prng.split(key)
    ia = _sample_indices(k1, valid, n_pairs, 1)[:, 0]
    ib = _sample_indices(k2, valid, n_pairs, 1)[:, 0]
    da = torch.linalg.vector_norm(pts_a[ia] - pts_a[ib], dim=-1)
    db = torch.linalg.vector_norm(pts_b[ia] - pts_b[ib], dim=-1)
    good = (ia != ib) & (da > 1e-6) & (db > 1e-6) & valid[ia] & valid[ib]
    ratio = torch.where(good, db / da.clamp(min=1e-9), torch.nan)
    med = _nanmedian(ratio)
    wf = ((torch.abs(ratio - med) < inlier_ratio_band * med) & good).to(torch.float32)
    s = torch.sum(wf * da * db) / torch.sum(wf * da * da).clamp(min=1e-9)
    return torch.where(torch.isfinite(s) & (s > 0), s, med)
