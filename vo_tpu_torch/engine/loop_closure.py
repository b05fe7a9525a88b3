"""Loop-closure detection + pose-graph trajectory optimization.

Port of ``vo_tpu/engine/loop_closure.py``. Candidate keyframe pairs are proposed by
estimated proximity (near in space, far along the path), verified with the
descriptor-match + PnP-RANSAC machinery of ``engine/refine.py::verify_row_pairs``,
and the verified relative poses become loop edges of a pose graph
(``vo_tpu_torch.ba.pose_graph``) over the keyframe chain; non-keyframe poses follow
their keyframe's correction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vo_tpu_torch.ba.pose_graph import PoseGraphConfig, optimize_pose_graph
from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.engine.refine import (RefineConfig, _fetch, _host_features, _rows_of,
                                         verify_row_pairs)


@dataclass(frozen=True)
class LoopClosureConfig:
    """The JAX package's LoopClosureConfig: same fields, same defaults (the reasons
    for the path-gap gate and the anisotropic information are in
    ``vo_tpu/engine/loop_closure.py``)."""

    min_gap: int = 8             # min keyframe-index separation for a loop candidate
    radius: float = 10.0         # candidate search radius around the current estimate (m)
    # A candidate must be near in space but far along the path:
    # path separation > max(min_path_gap_factor * pair distance, min_path_sep).
    min_path_gap_factor: float = 2.5
    min_path_sep: float = 10.0
    max_candidates: int = 24     # verification budget
    min_inliers: int = 30        # PnP inlier gate for accepting a loop edge
    matcher_ratio: float = 0.9
    binary_desc: bool = True
    odo_weight: float = 1.0
    loop_weight: float = 20.0    # loop edges trusted over accumulated odometry
    # Per-component [v, w] information of odometry edges (1/1/0: isotropic scalars).
    odo_trans_info: float = 1.0
    odo_rot_info: float = 1.0
    turn_soft_rad: float = 0.0   # >0: soften rotation info on turning edges
    pgo: PoseGraphConfig = PoseGraphConfig(iterations=25)


def detect_loop_closures(kf_ids, poses, kp, desc, valid, kp3d, K,
                         cfg: LoopClosureConfig = LoopClosureConfig(),
                         feat_rows=None, device: str | torch.device | None = None):
    """Find verified loop-closure edges between keyframes, verifying on ``device``
    (default cuda; raises if there is no GPU).

    Returns a list of (a, b, Z_ab (4,4), n_inliers) with a < b indices into kf_ids.
    ``feat_rows``: frame id of each row of kp/desc/valid/kp3d when features were
    retained sparsely; None means row i holds frame i's features.
    """
    dev = resolve_device(device)
    kf_ids = np.asarray(kf_ids)
    poses, _, _, _, kp3d_valid = _host_features(poses, kp, valid, kp3d)
    rows = _rows_of(poses.shape[0], feat_rows)[kf_ids]
    if (rows < 0).any():
        missing = kf_ids[rows < 0]
        raise ValueError(f"no retained features for keyframes {missing[:8]}...")

    # Candidates: near in space (radius), far along the path, non-adjacent.
    pos = poses[kf_ids][:, :3, 3]
    n = len(kf_ids)
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=-1)
    s = np.concatenate([[0.0], np.cumsum(steps)])       # path length per frame
    path_sep = np.abs(s[kf_ids][:, None] - s[kf_ids][None, :])
    a_idx, b_idx = np.nonzero((np.triu(np.ones((n, n), bool), cfg.min_gap)) &
                              (d < cfg.radius) &
                              (path_sep > np.maximum(cfg.min_path_gap_factor * d,
                                                     cfg.min_path_sep)))
    if len(a_idx) == 0:
        return []
    order = np.argsort(d[a_idx, b_idx])[: cfg.max_candidates]
    a_idx, b_idx = a_idx[order], b_idx[order]

    rcfg = RefineConfig(matcher_ratio=cfg.matcher_ratio, binary_desc=cfg.binary_desc)
    _, _, pz, n_in = verify_row_pairs(rows[a_idx], rows[b_idx], kp, desc, valid,
                                      kp3d, kp3d_valid, K, rcfg, dev)

    edges = []
    for c in range(len(a_idx)):
        if n_in[c] >= cfg.min_inliers:
            # the PnP pose maps a-cam -> b-cam, so the c2w relative edge is its inverse
            edges.append((int(a_idx[c]), int(b_idx[c]), np.linalg.inv(pz[c]),
                          int(n_in[c])))
    return edges


def optimize_with_loops(poses, kf_ids, loop_edges,
                        cfg: LoopClosureConfig = LoopClosureConfig(),
                        device: str | torch.device | None = None):
    """Pose-graph optimize the keyframe chain (odometry + loop edges) on ``device``
    (default cuda), then re-anchor every non-keyframe to its keyframe.

    Returns (corrected (F, 4, 4) trajectory, {"n_loop_edges", "pgo_cost"}). With no
    loop edge this is a no-op up to numerics.
    """
    dev = resolve_device(device)
    poses = np.asarray(poses)
    kf_ids = np.asarray(kf_ids)
    n = len(kf_ids)
    kf_poses = poses[kf_ids]

    inv_kf = np.linalg.inv(kf_poses)
    edges_ij = [(i, i + 1) for i in range(n - 1)]
    edges_z = list(inv_kf[:-1] @ kf_poses[1:])
    aniso = (cfg.odo_trans_info != 1.0 or cfg.odo_rot_info != 1.0
             or cfg.turn_soft_rad > 0)
    if aniso:
        rel = np.stack(edges_z)
        tr = np.clip(0.5 * (np.einsum("eii->e", rel[:, :3, :3]) - 1.0), -1.0, 1.0)
        ang = np.arccos(tr)
        w_t = cfg.odo_weight * cfg.odo_trans_info * np.ones(n - 1)
        soft = (1.0 / (1.0 + (ang / cfg.turn_soft_rad) ** 2)
                if cfg.turn_soft_rad > 0 else 1.0)
        w_r = cfg.odo_weight * cfg.odo_rot_info * soft
        edges_w = [np.array([t, t, t, r, r, r]) for t, r in zip(w_t, w_r * np.ones(n - 1))]
        loop_w = np.full(6, cfg.loop_weight)
    else:
        edges_w = [cfg.odo_weight] * (n - 1)
        loop_w = cfg.loop_weight
    for a, b, Z, _ in loop_edges:
        edges_ij.append((a, b))
        edges_z.append(Z)
        edges_w.append(loop_w)

    opt, costs = optimize_pose_graph(
        kf_poses.astype(np.float32), np.asarray(edges_ij, np.int64),
        np.stack(edges_z).astype(np.float32), np.asarray(edges_w, np.float32),
        cfg.pgo, device=dev)
    opt, costs = _fetch(opt, costs)

    # Re-anchor: each frame follows its most recent keyframe's correction (frames
    # before the first keyframe follow it too).
    F = poses.shape[0]
    j_of = np.clip(np.searchsorted(kf_ids, np.arange(F), side="right") - 1, 0, n - 1)
    corr = opt @ inv_kf                     # (n, 4, 4) correction transforms
    out = np.einsum("fij,fjk->fik", corr[j_of], poses)
    return out, {"n_loop_edges": len(loop_edges),
                 "pgo_cost": [float(c) for c in costs]}
