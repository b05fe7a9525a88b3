"""Windowed bundle adjustment with Schur-complement reduction, on the device.

Port of ``vo_tpu/ba/bundle_adjust.py``: the same fixed shapes (P poses x M observation
slots per pose, L landmark slots, validity masks instead of sparse structures), the
same Levenberg-Marquardt with Huber IRLS weights and a fixed iteration count, pose 0
frozen for the gauge, and the landmark blocks eliminated by the Schur complement with
a closed-form 3x3 inverse.

The JAX package runs the iterations as one ``lax.scan``; here they are a Python loop
with the carry on the device. Step acceptance is a ``torch.where`` and nothing is read
back to the host: the caller reads the result once. What differs on the card:
- the reduced camera system is solved with ``torch.linalg.solve_ex`` and no error
  check, so a singular system gives non-finite values (a step that is then rejected,
  or a result the caller skips), as ``jnp.linalg.solve`` does, where
  ``torch.linalg.solve`` would raise and synchronise with the host;
- ``segment_sum`` is ``ba/segment.py``'s fixed-order sum (the ids sorted once per
  call, each segment summed in order), so a solve on the card is bitwise repeatable;
- S's landmark correction is one (6P, 3L) x (3L, 6P) product; no (L, 6P, 6P) array is
  formed.

Conventions: poses are world-to-camera T_cw (4, 4); landmark X is world-frame;
residual = project(K, T_cw X) - uv.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from vo_tpu_torch.ba.segment import segment_sum, segments
from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.geometry.se3 import se3_exp
from vo_tpu_torch.geometry.so3 import hat
from vo_tpu_torch.ops.smalllinalg import adjugate3x3


@dataclass(frozen=True)
class BAConfig:
    """The JAX package's BAConfig: same fields, same defaults."""

    iterations: int = 12
    damping_init: float = 1e-3
    huber_delta: float = 2.0         # px
    min_depth: float = 1e-2
    fix_first_pose: bool = True
    depth_weight: float = 1.0        # weight of the rgbd depth residual (0 disables),
                                     # in pixel-equivalent units fx (z - z_meas) / z_meas


class BAProblem(NamedTuple):
    """Fixed-shape windowed BA problem.

    poses:    (P, 4, 4) world-to-camera initial estimates
    points:   (L, 3) world-frame landmark initial estimates
    obs_lm:   (P, M) int landmark index per observation slot
    obs_uv:   (P, M, 2) pixel measurements
    obs_valid:(P, M) bool
    K:        (3, 3) intrinsics
    obs_z:    optional (P, M) measured camera-frame depth (rgbd); <= min_depth disables
              the depth residual for that observation
    """

    poses: torch.Tensor
    points: torch.Tensor
    obs_lm: torch.Tensor
    obs_uv: torch.Tensor
    obs_valid: torch.Tensor
    K: torch.Tensor
    obs_z: torch.Tensor | None = None

    def to(self, device: torch.device) -> BAProblem:
        return BAProblem(*(None if x is None else x.to(device) for x in self))


def _residuals_and_jacobians(poses, points, prob: BAProblem, cfg: BAConfig,
                             jacobians: bool = True):
    """Per-observation residuals + pose/landmark Jacobians, all fixed-shape.

    Returns r (P, M, 3), Jp (P, M, 3, 6), Jl (P, M, 3, 3), w (P, M); the Jacobians are
    None when ``jacobians`` is false.
    """
    K = prob.K
    fx, fy = K[0, 0], K[1, 1]
    X = points[prob.obs_lm]                                   # (P, M, 3) world
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    Y = torch.einsum("pij,pmj->pmi", R, X) + t[:, None, :]    # camera frame
    z = Y[..., 2]
    z_ok = z > cfg.min_depth
    z_safe = torch.where(z_ok, z, 1.0)
    u = fx * Y[..., 0] / z_safe + K[0, 2]
    v = fy * Y[..., 1] / z_safe + K[1, 2]

    # Optional rgbd depth residual in pixel-equivalent units: fx (z - z_m) / z_m.
    if prob.obs_z is not None:
        z_m = prob.obs_z
        z_has = z_m > cfg.min_depth
        z_m_safe = torch.where(z_has, z_m, 1.0)
        wz = cfg.depth_weight * fx / z_m_safe * z_has.to(Y.dtype)
        r3 = wz * (z - z_m_safe)
    else:
        wz = torch.zeros_like(z)
        r3 = torch.zeros_like(z)
    r = torch.stack([u - prob.obs_uv[..., 0], v - prob.obs_uv[..., 1], r3], dim=-1)

    # Huber IRLS weights on the 2-D reprojection norm, masked.
    rn = torch.linalg.vector_norm(r[..., :2], dim=-1)
    huber = torch.where(rn <= cfg.huber_delta, 1.0, cfg.huber_delta / rn.clamp(min=1e-9))
    w = huber * (prob.obs_valid & z_ok).to(r.dtype)
    if not jacobians:
        return r, None, None, w

    zinv = 1.0 / z_safe
    zero = torch.zeros_like(zinv)
    Jproj = torch.stack([
        torch.stack([fx * zinv, zero, -fx * Y[..., 0] * zinv * zinv], dim=-1),
        torch.stack([zero, fy * zinv, -fy * Y[..., 1] * zinv * zinv], dim=-1),
        torch.stack([zero, zero, wz], dim=-1),
    ], dim=-2)                                                # (P, M, 3, 3)
    eye = torch.eye(3, dtype=Y.dtype, device=Y.device).expand(Y.shape + (3,))
    Jpose_Y = torch.cat([eye, -hat(Y)], dim=-1)               # (P, M, 3, 6)
    Jp = Jproj @ Jpose_Y                                      # (P, M, 3, 6)
    Jl = Jproj @ R[:, None]                                   # dY/dX = R
    return r, Jp, Jl, w


def _segment_plans(obs_lm, L):
    """The segment plans of the landmark blocks (by landmark) and of the couplings
    (by landmark and pose): fixed for a problem, so sorted once per solve."""
    P, M = obs_lm.shape
    flat_lm = obs_lm.reshape(-1)
    pose_ids = torch.arange(P, device=obs_lm.device).repeat_interleave(M)
    return segments(flat_lm, L), segments(flat_lm * P + pose_ids, L * P)


def _assemble_reduced_system(r, Jp, Jl, w, obs_lm, L, damping, plans=None):
    """Schur-complement assembly. Returns (S (6P, 6P), g (6P,), lm_terms).

    Hpp: (P, 6, 6) block-diag; Hll: (L, 3, 3) block-diag; U (L, 6P, 3) stacks each
    landmark's per-pose couplings. S = Hpp - sum_l U_l Hll_l^-1 U_l^T. ``plans`` are
    ``_segment_plans(obs_lm, L)``, made here when not given.
    """
    P, M = obs_lm.shape
    by_lm, by_lm_pose = plans if plans is not None else _segment_plans(obs_lm, L)
    Hpp = torch.einsum("pmik,pmil,pm->pkl", Jp, Jp, w)              # (P, 6, 6)
    bp = -torch.einsum("pmik,pmi,pm->pk", Jp, r, w)                 # (P, 6)

    Hll = segment_sum(torch.einsum("pmik,pmil,pm->pmkl", Jl, Jl, w).reshape(-1, 3, 3),
                      by_lm)
    bl = segment_sum(-torch.einsum("pmik,pmi,pm->pmk", Jl, r, w).reshape(-1, 3), by_lm)

    # U[l, p] = sum of the (6, 3) couplings of pose p's observations of landmark l.
    Wpl = torch.einsum("pmik,pmil,pm->pmkl", Jp, Jl, w).reshape(-1, 6, 3)
    U = segment_sum(Wpl, by_lm_pose).reshape(L, P * 6, 3)

    inv3 = damped_inv3(Hll, damping)                                # (L, 3, 3)
    Hinv_Ut = inv3 @ U.transpose(1, 2)                              # (L, 3, 6P)
    U_rows = U.permute(1, 0, 2).reshape(6 * P, 3 * L)               # column 3l + k
    S_corr = U_rows @ Hinv_Ut.reshape(3 * L, 6 * P)                 # (6P, 6P)
    g_corr = U_rows @ (inv3 @ bl[..., None]).reshape(3 * L)         # (6P,)

    eye_p = torch.eye(P, dtype=Hpp.dtype, device=Hpp.device)
    S = torch.einsum("pkl,pq->pkql", Hpp, eye_p).reshape(6 * P, 6 * P) - S_corr
    g = bp.reshape(6 * P) - g_corr
    return S, g, (inv3, bl, U)


def damped_inv3(Hll: torch.Tensor, damping) -> torch.Tensor:
    """LM-damped inverse of (L, 3, 3) landmark blocks via the closed-form adjugate.
    The damping is trace-relative so unobserved (all-zero) blocks stay invertible."""
    trace = Hll[..., 0, 0] + Hll[..., 1, 1] + Hll[..., 2, 2]
    eye = torch.eye(3, dtype=Hll.dtype, device=Hll.device)
    H = Hll + (damping * torch.clamp(trace, min=1e-6)[..., None, None] / 3.0 + 1e-8) * eye
    adj = adjugate3x3(H)
    # Cofactor expansion along row 0 (JAX takes an LU determinant: same value to fp32
    # rounding, without a batched LU on the card).
    det = (H[..., 0, 0] * adj[..., 0, 0] + H[..., 0, 1] * adj[..., 1, 0]
           + H[..., 0, 2] * adj[..., 2, 0])
    return adj / det.clamp(min=1e-12)[..., None, None]             # (L, 3, 3)


def _backsub_landmarks(delta_pose_flat, lm_terms):
    """delta_l = Hll^-1 (bl - U^T delta_p)."""
    inv3, bl, U = lm_terms
    Ut_dp = torch.einsum("lak,a->lk", U, delta_pose_flat)
    return (inv3 @ (bl - Ut_dp)[..., None])[..., 0]


def _total_cost(r, w):
    return torch.sum(w * torch.sum(r * r, dim=-1))


def bundle_adjust(prob: BAProblem, cfg: BAConfig = BAConfig(),
                  device: str | torch.device | None = None):
    """LM-damped Schur BA on ``device`` (default cuda; raises if there is no GPU).

    Returns (poses, points, info) as device tensors; info holds ``costs``
    (iterations, 2) [before, after each step], ``final_cost`` and ``mean_reproj``.
    """
    dev = resolve_device(device)
    prob = prob.to(dev)._replace(obs_lm=prob.obs_lm.to(dev, torch.int64))
    P = prob.poses.shape[0]
    L = prob.points.shape[0]
    poses, points = prob.poses, prob.points
    damping = torch.tensor(cfg.damping_init, dtype=poses.dtype, device=dev)
    gauge = torch.ones(6 * P, dtype=poses.dtype, device=dev)
    gauge[:6] = 0.0

    plans = _segment_plans(prob.obs_lm, L)

    costs = []
    for _ in range(cfg.iterations):
        r, Jp, Jl, w = _residuals_and_jacobians(poses, points, prob, cfg)
        cost0 = _total_cost(r, w)
        S, g, lm_terms = _assemble_reduced_system(r, Jp, Jl, w, prob.obs_lm, L, damping,
                                                  plans)

        # LM damping on the reduced camera system + gauge fixing.
        S = S + damping * torch.diag(torch.clamp(torch.diagonal(S), min=1e-6))
        if cfg.fix_first_pose:
            S = S * gauge[:, None] * gauge[None, :] + torch.diag(1.0 - gauge)
            g = g * gauge
        delta_p = torch.linalg.solve_ex(S, g, check_errors=False)[0]
        delta_l = _backsub_landmarks(delta_p, lm_terms)

        new_poses = se3_exp(delta_p.reshape(P, 6)) @ poses
        new_points = points + delta_l
        r2, _, _, w2 = _residuals_and_jacobians(new_poses, new_points, prob, cfg,
                                                jacobians=False)
        cost1 = _total_cost(r2, w2)
        improved = cost1 < cost0
        poses = torch.where(improved, new_poses, poses)
        points = torch.where(improved, new_points, points)
        damping = torch.where(improved, damping * 0.5, damping * 4.0)
        costs.append(torch.stack([cost0, cost1]))

    r, _, _, w = _residuals_and_jacobians(poses, points, prob, cfg, jacobians=False)
    final = _total_cost(r, w)
    info = {"costs": torch.stack(costs) if costs else r.new_zeros((0, 2)),
            "final_cost": final,
            "mean_reproj": torch.sqrt(final / torch.clamp(torch.sum(w), min=1.0))}
    return poses, points, info
