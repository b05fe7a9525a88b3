"""Vectorised PnP-RANSAC. Port of ``vo_tpu/estimation/pnp.py``.

H minimal sets are drawn at once from a threefry key (``vo_tpu_torch.prng``, the same
draws as ``jax.random``); hypotheses come from a 3-point Kabsch bank (when the current
frame has depth) and a 6-point DLT bank; all hypotheses score all N correspondences;
the best seeds a fixed-iteration reweighted Gauss-Newton polish. Shapes never depend
on the data and nothing here reads a value back to the host.

The bank and its scoring (``_bank``) and the Gauss-Newton solve (``_gn_refine``) each
run as a hand-written CUDA kernel on CUDA tensors (``ops/pnp_bank.py``,
``ops/pnp_gn.py``); their plain versions, ``_bank_plain`` and ``_gn_refine_plain``,
serve CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from vo_tpu_torch import prng
from vo_tpu_torch.estimation.procrustes import kabsch
from vo_tpu_torch.geometry.se3 import pose_from_rt, se3_exp
from vo_tpu_torch.geometry.so3 import hat
from vo_tpu_torch.ops.pnp_bank import launch_bank
from vo_tpu_torch.ops.pnp_gn import launch_gn
from vo_tpu_torch.ops.smalllinalg import det3x3, smallest_eigvec, solve_spd_small, svd3x3
from vo_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class PnPConfig:
    """The JAX package's PnPConfig: same fields, same defaults."""

    n_hypotheses: int = 512
    sample_size: int = 6            # the DLT bank's points; CUDA's bank kernel takes 6-16
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
    ok: torch.Tensor         # () bool


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor without reading it back to the host (indexing
    with a 0-d CUDA tensor reads it, a host sync)."""
    return x.index_select(0, i.reshape(1))[0]


def _sample_indices(key: torch.Tensor, valid: torch.Tensor, n_hyp: int, m: int) -> torch.Tensor:
    """(n_hyp, m) indices drawn uniformly from the valid entries, with replacement."""
    order = torch.sort((~valid).to(torch.uint8), stable=True).indices  # valid first
    n_valid = torch.clamp(valid.sum(), min=1)
    u = prng.uniform(key, (n_hyp, m))
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
    """Fixed-iteration reweighted Gauss-Newton over SE(3), masked (no gathers): the
    plain version on the CPU, one launch of the CUDA kernel (``ops/pnp_gn.py``) on CUDA.

    ``thresholds``: per-iteration inlier cutoffs in px; default repeats
    cfg.reproj_threshold (a tight polish). A wide-to-tight schedule turns the same
    loop into a wide-basin solver.
    """
    if thresholds is None:
        thresholds = [cfg.reproj_threshold] * cfg.gn_iterations
    if X.device.type == "cpu":
        return _gn_refine_plain(pose, X, x_px, valid, K, cfg, thresholds)
    return launch_gn(pose, X, x_px, valid, K, thresholds, cfg.min_depth)


def _gn_refine_plain(pose, X, x_px, valid, K, cfg: PnPConfig, thresholds):
    """``_gn_refine`` in plain PyTorch ops: the kernel's oracle."""
    fx, fy = K[0, 0], K[1, 1]
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

    key: threefry key (2,) int64 (``prng.fold_in(prng.key(8214), frame_id)``).
    points_3d (N, 3) keyframe-camera points, points_2d (N, 2) current pixels,
    valid (N,) mask, K (3, 3). points_3d_cur / valid_cur (rgbd) enable the Kabsch bank.
    """
    with span("pnp.ransac"):
        best_pose, best_count, best_inl = _bank(key, points_3d, points_2d, valid, K, cfg,
                                                points_3d_cur, valid_cur)
        if cfg.anneal:
            with span("pnp.anneal"):
                pose0, best_count, best_inl = _anneal(best_pose, best_count, best_inl,
                                                      points_3d, points_2d, valid, K, cfg)
        else:
            pose0 = best_pose
        with span("pnp.refine"):
            return _refine(pose0, best_count, best_inl, points_3d, points_2d, valid, K,
                           cfg)


def _bank(key, points_3d, points_2d, valid, K, cfg: PnPConfig, points_3d_cur, valid_cur):
    """The hypothesis bank, scored -> (best_pose (4, 4), best_count () int64, best_inl
    (N,)): the first hypothesis with the most inliers. The plain version on the CPU, the
    CUDA kernel (``ops/pnp_bank.py``, two launches) on CUDA."""
    if points_3d.device.type == "cpu":
        return _bank_plain(key, points_3d, points_2d, valid, K, cfg, points_3d_cur,
                           valid_cur)
    bank = launch_bank(key, points_3d, points_2d, valid, K, cfg.n_hypotheses,
                       cfg.sample_size, cfg.reproj_threshold, cfg.min_depth,
                       points_3d_cur, valid_cur)
    return bank.pose, bank.count, bank.inliers


def _bank_plain(key, points_3d, points_2d, valid, K, cfg: PnPConfig, points_3d_cur,
                valid_cur):
    """``_bank`` in plain PyTorch ops: the kernel's oracle."""
    with span("pnp.hypotheses"):
        hyp_poses = _hypotheses(key, points_3d, points_2d, valid, K, cfg, points_3d_cur,
                                valid_cur)
    with span("pnp.score"):
        res, z = _reproject_residuals(hyp_poses, points_3d, points_2d, K)   # (H, N)
        inl = (res < cfg.reproj_threshold) & (z > cfg.min_depth) & valid[None, :]
        counts = inl.sum(dim=-1)
        best = torch.argmax(counts)
        return tuple(_pick(x, best) for x in (hyp_poses, counts, inl))


def _hypotheses(key, points_3d, points_2d, valid, K, cfg: PnPConfig, points_3d_cur,
                valid_cur) -> torch.Tensor:
    """The (H, 4, 4) hypothesis bank: minimal sets drawn from ``key``, then the DLT bank
    alone, or the Kabsch bank (3/4 of H) and the DLT bank when the frame has depth."""
    x_norm = torch.stack([
        (points_2d[:, 0] - K[0, 2]) / K[0, 0],
        (points_2d[:, 1] - K[1, 2]) / K[1, 1],
    ], dim=-1)
    if points_3d_cur is None:
        idx = _sample_indices(key, valid, cfg.n_hypotheses, cfg.sample_size)
        return _dlt_pose(points_3d[idx], x_norm[idx])
    n_kab = (3 * cfg.n_hypotheses) // 4
    n_dlt = cfg.n_hypotheses - n_kab
    v_cur = valid & valid_cur if valid_cur is not None else valid
    k1, k2 = prng.split(key)
    idx_k = _sample_indices(k1, v_cur, n_kab, 3)
    hyp_kab = kabsch(points_3d[idx_k], points_3d_cur[idx_k])
    idx_d = _sample_indices(k2, valid, n_dlt, cfg.sample_size)
    hyp_dlt = _dlt_pose(points_3d[idx_d], x_norm[idx_d])
    return torch.cat([hyp_kab, hyp_dlt], dim=0)


def _anneal(best_pose, best_count, best_inl, points_3d, points_2d, valid, K,
            cfg: PnPConfig):
    """The identity-seeded annealed candidate against the bank's best -> (pose0,
    best_count, best_inl).

    The JAX package skips the candidate with a lax.cond unless the banks are weak.
    Here it is always computed and then selected, so that no value goes back to the
    host; the result is that of the cond."""
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
    return pose0, torch.maximum(best_count, count_i), torch.where(use_id, inl_i, best_inl)


def _refine(pose0, best_count, best_inl, points_3d, points_2d, valid, K,
            cfg: PnPConfig) -> PnPResult:
    """The final Gauss-Newton polish from ``pose0``, rescored; keeps whichever of the
    refined pose and the best candidate has more inliers, and applies the acceptance
    rule."""
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
