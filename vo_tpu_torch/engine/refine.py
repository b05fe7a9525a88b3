"""Post-VO trajectory refinement: windowed bundle adjustment over keyframes, loop
closure, and the adaptive product pipeline (``refine_full``).

Port of ``vo_tpu/engine/refine.py``. After the forward VO pass, temporally adjacent
keyframes are re-matched and verified (descriptor match + PnP-RANSAC), their
depth-backed keypoints lifted to world-frame landmarks, and the keyframe poses
polished with the Schur-complement BA (``vo_tpu_torch.ba``). Non-keyframe poses follow
their keyframe's correction.

Pair verification (``verify_row_pairs``) is a loop over pairs: each pair's match goes
through ``ops.match`` (the wgmma kernel for binary descriptors on the card, the plain
version on the CPU) and one 256-hypothesis PnP-RANSAC, and the whole batch is read
back once. The JAX package ``vmap``s the same computation over chunks of 16 pairs;
each pair draws from the same key, ``fold_in(key(8214), row_a * 10007 + row_b)``.
The problem builders are host numpy, as in JAX; each BA solve runs on the device and
is read back once per window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from vo_tpu_torch import prng
from vo_tpu_torch.ba.bundle_adjust import BAConfig, BAProblem, bundle_adjust
from vo_tpu_torch.device import resolve_device, to_device
from vo_tpu_torch.estimation.pnp import PnPConfig, pnp_ransac
from vo_tpu_torch.geometry.se3 import pose_inverse
from vo_tpu_torch.ops.match import ratio_match_fused, ratio_mutual_nn_match_fused

_PAIR_PNP = PnPConfig(n_hypotheses=256, min_inliers=10)


@dataclass(frozen=True)
class RefineConfig:
    """The JAX package's RefineConfig: same fields, same defaults (the reasons for
    each trust gate are in ``vo_tpu/engine/refine.py``)."""

    window: int = 8             # keyframes per BA window
    obs_per_pose: int = 256     # observation slots per keyframe
    matcher_ratio: float = 0.9
    binary_desc: bool = True
    ba: BAConfig = BAConfig(iterations=10)
    min_obs_per_landmark: int = 2
    # Trust gates on a window's correction before it re-anchors the tail.
    max_correction_rot_deg: float = 3.0
    max_correction_t: float = 1.0
    max_cost_per_obs: float = 6.0
    # Damping of the translation of each window correction (0: rotation-only).
    trans_damp: float = 1.0
    # True: each window's corrections re-anchor the rest of the trajectory; False:
    # only the window's own span (local polish).
    anchor_tail: bool = True


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fetch(*tensors) -> list[np.ndarray]:
    """Read several device tensors back in one copy, as fp32 numpy arrays."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, s = [], 0
    for t in tensors:
        out.append(flat[s:s + t.numel()].reshape(t.shape))
        s += t.numel()
    return out


def _select_keyframes(diag_promoted: np.ndarray, n_frames: int,
                      max_gap: int = 4, allowed: np.ndarray | None = None) -> np.ndarray:
    """Keyframe indices: frame 0, every promoted frame, the last frame, with gaps
    capped at ``max_gap`` so every adjacent pair stays matchable.

    ``allowed``: optional sorted frame ids that have retained features (sparse
    retention mode); every selected keyframe (gap fillers included) snaps to it.
    """
    kfs = [0]
    promoted = np.nonzero(np.asarray(diag_promoted))[0] + 1  # diag row i = frame i+1
    for f in promoted:
        if f - kfs[-1] >= 1:
            kfs.append(int(f))
    if kfs[-1] != n_frames - 1:
        kfs.append(n_frames - 1)
    allowed_set = None if allowed is None else set(int(a) for a in allowed)

    def snap(f: int) -> int | None:
        """Largest allowed frame <= f (features exist for it)."""
        if allowed_set is None or f in allowed_set:
            return f
        i = np.searchsorted(allowed, f, side="right") - 1
        return int(allowed[i]) if i >= 0 else None

    out = [kfs[0]]
    for f in kfs[1:]:
        while f - out[-1] > max_gap:
            filler = snap(out[-1] + max_gap)
            if filler is None or filler <= out[-1]:
                break      # no retained frame in the gap: let the pair stretch
            out.append(filler)
        s = snap(f)
        if s is not None and s > out[-1]:
            out.append(s)
    return np.unique(np.asarray(out))


def _match(desc_a, desc_b, valid_a, valid_b, cfg: RefineConfig):
    """The pair matcher: ``ratio_match`` with the hamming formula through the fused
    wrapper (bf16 operands: the wgmma kernel on the card), or the float
    ``ratio_mutual_nn`` (fp32 operands: the SIMT kernel)."""
    if cfg.binary_desc:
        return ratio_match_fused(desc_a, desc_b, valid_a, valid_b,
                                 ratio=cfg.matcher_ratio, binary_dim=desc_a.shape[-1])
    return ratio_mutual_nn_match_fused(desc_a, desc_b, valid_a, valid_b,
                                       ratio=cfg.matcher_ratio)


def verify_row_pairs(rows_a, rows_b, kp, desc, valid, kp3d, kp3d_valid, K,
                     cfg: RefineConfig, device: str | torch.device | None = None):
    """Verification of arbitrary (row_a, row_b) feature pairs: match + PnP-RANSAC.

    Returns (idx (N, Kp), mask (N, Kp), poses (N, 4, 4) a-cam->b-cam, n_inliers (N,))
    as numpy. Shared by BA problem building and loop-closure detection. The pairs are
    issued one after another on ``device`` (default cuda) and read back together;
    ``verify_row_pairs.pairs`` counts the pairs verified, so that a run can hold its
    match-kernel launches against them.
    """
    dev = resolve_device(device)
    rows_a = np.asarray(rows_a, np.int64).reshape(-1)
    rows_b = np.asarray(rows_b, np.int64).reshape(-1)
    kp, desc, valid, kp3d, kp3d_valid = (to_device(x, dev) for x in
                                         (kp, desc, valid, kp3d, kp3d_valid))
    K = to_device(K, dev, torch.float32)
    keys = prng.fold_in(prng.key(8214, device=dev),
                        to_device(rows_a * 10007 + rows_b, dev))
    out = []
    for i, (ra, rb) in enumerate(zip(rows_a.tolist(), rows_b.tolist())):
        m = _match(desc[ra], desc[rb], valid[ra], valid[rb], cfg)
        mask = m.mask & kp3d_valid[ra]
        pnp = pnp_ransac(keys[i], kp3d[ra], kp[rb][m.idx], mask, K, _PAIR_PNP,
                         points_3d_cur=kp3d[rb][m.idx], valid_cur=kp3d_valid[rb][m.idx])
        out.append((m.idx, mask & pnp.inliers, pnp.pose, pnp.n_inliers))
    verify_row_pairs.pairs += len(out)
    idx, mask, pose, n_in = (torch.stack(x).cpu().numpy() for x in zip(*out))
    return idx, mask, pose, n_in


verify_row_pairs.pairs = 0


def _pair_match(ia, ib, kp, desc, valid, kp3d, kp3d_valid, K, cfg: RefineConfig,
                device: str | torch.device | None = None):
    """RANSAC-verified matches of feature row ia -> ib: (idx (Kp,), mask (Kp,)).

    Descriptor matches carry gross outliers that Huber alone cannot absorb, so every
    pair is gated through the PnP solver's inlier set before it feeds BA.
    """
    idx, mask, _, _ = verify_row_pairs([ia], [ib], kp, desc, valid, kp3d, kp3d_valid,
                                       K, cfg, device)
    return idx[0], mask[0]


def _all_adjacent_pair_matches(rows, kp, desc, valid, kp3d, kp3d_valid, K,
                               cfg: RefineConfig,
                               device: str | torch.device | None = None):
    """RANSAC-verified matches for every adjacent keyframe pair, read back together:
    [(idx (Kp,), mask (Kp,)) for each (rows[i], rows[i+1])]. Matches depend only on
    the features, never on the poses, so computing them once for the whole chain is
    exact."""
    rows = np.asarray(rows)
    if len(rows) <= 1:
        return []
    idx, mask, _, _ = verify_row_pairs(rows[:-1], rows[1:], kp, desc, valid, kp3d,
                                       kp3d_valid, K, cfg, device)
    return [(idx[i], mask[i]) for i in range(len(rows) - 1)]


def _problem_on_device(T_wc, points, obs_lm, obs_uv, obs_valid, obs_z, K, dev):
    """The host arrays as a BAProblem on ``dev``, the poses inverted to
    world-to-camera there."""
    return BAProblem(
        poses=pose_inverse(to_device(T_wc, dev, torch.float32)),
        points=to_device(points, dev), obs_lm=to_device(obs_lm, dev),
        obs_uv=to_device(obs_uv, dev), obs_valid=to_device(obs_valid, dev),
        K=to_device(K, dev, torch.float32), obs_z=to_device(obs_z, dev))


def _build_window_problem(kf_ids, poses, kp, desc, valid, kp3d, kp3d_valid, K,
                          cfg: RefineConfig, rows=None, pairs=None,
                          device: str | torch.device | None = None):
    """One fixed-shape BAProblem with 2-3 view landmark tracks.

    Each landmark anchors at keyframe a and is observed in a, a+1 and (when the
    composed match survives) a+2.

    ``rows``: feature-array row of each keyframe (sparse retention); defaults to the
    frame ids themselves.
    ``pairs``: precomputed (idx, mask) per adjacent pair (window-local index a ->
    global adjacent pair); verified here when absent.
    """
    dev = resolve_device(device)
    P = len(kf_ids)
    rows = np.asarray(kf_ids) if rows is None else np.asarray(rows)
    M = cfg.obs_per_pose
    per_anchor = M // 3
    L = max((P - 1) * per_anchor, 1)

    if pairs is None:
        pair = {a: _pair_match(rows[a], rows[a + 1], kp, desc, valid, kp3d,
                               kp3d_valid, K, cfg, dev)
                for a in range(P - 1)}
    else:
        pair = pairs

    obs_lm = np.zeros((P, M), np.int32)
    obs_uv = np.zeros((P, M, 2), np.float32)
    obs_z = np.zeros((P, M), np.float32)
    obs_valid = np.zeros((P, M), bool)
    points = np.zeros((L, 3), np.float32)
    obs_fill = np.zeros(P, np.int32)
    lm_ctr = 0

    kp_np = _host(kp)
    kp3d_np = _host(kp3d)
    z_all = kp3d_np[..., 2]
    zv_all = _host(kp3d_valid)

    def add_obs(p, frame, kp_rows, lm_ids):
        s = obs_fill[p]
        n = len(lm_ids)
        obs_lm[p, s:s + n] = lm_ids
        obs_uv[p, s:s + n] = kp_np[frame][kp_rows]
        # metric depth measurement where the frame's depth is valid at that keypoint
        obs_z[p, s:s + n] = np.where(zv_all[frame][kp_rows], z_all[frame][kp_rows], 0.0)
        obs_valid[p, s:s + n] = True
        obs_fill[p] += n

    for a in range(P - 1):
        ia, ra, rb = kf_ids[a], rows[a], rows[a + 1]
        idx1, mask1 = pair[a]
        sel = np.nonzero(mask1)[0][:per_anchor]
        n = len(sel)
        if n == 0:
            continue

        Xc = kp3d_np[ra][sel]
        T = np.asarray(poses[ia])
        Xw = Xc @ T[:3, :3].T + T[:3, 3]
        lm_ids = np.arange(lm_ctr, lm_ctr + n)
        points[lm_ids] = Xw
        lm_ctr += n

        add_obs(a, ra, sel, lm_ids)
        add_obs(a + 1, rb, idx1[sel], lm_ids)

        # Third view via match composition a -> a+1 -> a+2.
        if a + 2 < P:
            idx2, mask2 = pair[a + 1]
            hop = idx1[sel]
            ok3 = mask2[hop]
            if ok3.any() and obs_fill[a + 2] + ok3.sum() <= M:
                add_obs(a + 2, rows[a + 2], idx2[hop[ok3]], lm_ids[ok3])

    return _problem_on_device(np.asarray(poses)[kf_ids], points, obs_lm, obs_uv,
                              obs_valid, obs_z, _host(K), dev)


def _build_global_problem(kf_ids, poses, kp, desc, valid, kp3d, kp3d_valid, K,
                          cfg: RefineConfig, rows, pairs, loop_pairs,
                          loop_matches, pose_bucket: int = 32,
                          lm_bucket: int = 2048,
                          device: str | torch.device | None = None):
    """ONE BAProblem over the whole keyframe chain + loop-closure observations.

    The window builder's 2-3 view adjacent-pair tracks, plus for every verified loop
    pair (a, b) a bank of wide-baseline 2-view landmarks anchored at a and
    re-observed at b. Poses and landmarks are padded to buckets (identity poses with
    no valid observations), as in JAX.
    """
    dev = resolve_device(device)
    P = len(kf_ids)
    M = cfg.obs_per_pose
    per_anchor = M // 3
    per_loop = min(per_anchor, 64)

    P_pad = -(-max(P, 2) // pose_bucket) * pose_bucket
    L_raw = (P - 1) * per_anchor + len(loop_pairs) * per_loop
    L_pad = -(-max(L_raw, 1) // lm_bucket) * lm_bucket

    obs_lm = np.zeros((P_pad, M), np.int32)
    obs_uv = np.zeros((P_pad, M, 2), np.float32)
    obs_z = np.zeros((P_pad, M), np.float32)
    obs_valid = np.zeros((P_pad, M), bool)
    points = np.zeros((L_pad, 3), np.float32)
    obs_fill = np.zeros(P_pad, np.int32)
    lm_ctr = 0

    kp_np = _host(kp)
    kp3d_np = _host(kp3d)
    z_all = kp3d_np[..., 2]
    zv_all = _host(kp3d_valid)

    def add_obs(p, frame_row, kp_rows, lm_ids):
        s = obs_fill[p]
        n = len(lm_ids)
        obs_lm[p, s:s + n] = lm_ids
        obs_uv[p, s:s + n] = kp_np[frame_row][kp_rows]
        obs_z[p, s:s + n] = np.where(zv_all[frame_row][kp_rows],
                                     z_all[frame_row][kp_rows], 0.0)
        obs_valid[p, s:s + n] = True
        obs_fill[p] += n

    def add_anchor(a, b, idx, mask, budget, third=None):
        """Landmarks anchored at keyframe index a, observed at a and b."""
        nonlocal lm_ctr
        sel = np.nonzero(mask)[0]
        cap = min(budget, M - obs_fill[a], M - obs_fill[b])
        sel = sel[:max(cap, 0)]
        n = len(sel)
        if n == 0:
            return
        Xc = kp3d_np[rows[a]][sel]
        T = np.asarray(poses[kf_ids[a]])
        Xw = Xc @ T[:3, :3].T + T[:3, 3]
        lm_ids = np.arange(lm_ctr, lm_ctr + n)
        points[lm_ids] = Xw
        lm_ctr += n
        add_obs(a, rows[a], sel, lm_ids)
        add_obs(b, rows[b], idx[sel], lm_ids)
        if third is not None:
            c, idx2, mask2 = third
            hop = idx[sel]
            ok3 = mask2[hop]
            n3 = int(ok3.sum())
            if n3 and obs_fill[c] + n3 <= M:
                add_obs(c, rows[c], idx2[hop[ok3]], lm_ids[ok3])

    for a in range(P - 1):
        idx1, mask1 = pairs[a]
        third = (a + 2, *pairs[a + 1]) if a + 2 < P else None
        add_anchor(a, a + 1, idx1, mask1, per_anchor, third)
    for (a, b), (idx, mask) in zip(loop_pairs, loop_matches):
        add_anchor(a, b, idx, mask, per_loop)

    T_wc = np.broadcast_to(np.eye(4, dtype=np.float32), (P_pad, 4, 4)).copy()
    T_wc[:P] = np.asarray(poses)[kf_ids]
    return _problem_on_device(T_wc, points, obs_lm, obs_uv, obs_valid, obs_z,
                              _host(K), dev)


def _host_features(poses, kp, valid, kp3d):
    """Host copies of what the problem builders index, and the keypoints' depth
    validity (0.1 m < z < 80 m)."""
    poses = np.asarray(poses)
    kp, valid, kp3d = _host(kp), _host(valid), _host(kp3d)
    z = kp3d[..., 2]
    return poses, kp, valid, kp3d, valid & (z > 0.1) & (z < 80.0)


def _rows_of(n_frames, feat_rows):
    """Feature row of each frame (-1 where none is retained)."""
    if feat_rows is None:
        return np.arange(n_frames)
    row_of = np.full(n_frames, -1, np.int64)
    row_of[np.asarray(feat_rows)] = np.arange(len(feat_rows))
    return row_of


def refine_trajectory_global(poses, kp, desc, valid, kp3d, K,
                             diag_promoted=None,
                             cfg: RefineConfig = RefineConfig(),
                             feat_rows=None, loop_edges=None,
                             all_pairs=None, kfs=None, row_of=None,
                             device: str | torch.device | None = None):
    """Polish a (loop-closed) trajectory with ONE global bundle adjustment on
    ``device`` (default cuda).

    ``loop_edges``: verified loop closures [(a, b, Z, n_inliers), ...] with a, b
    indices into the keyframe list (``detect_loop_closures``); their pair matches
    become wide-baseline observations in the global problem.

    Returns (refined (F, 4, 4), info); info["timing"] holds ``match_s``, ``build_s``
    and ``ba_s``.
    """
    dev = resolve_device(device)
    poses, kp, valid, kp3d, kp3d_valid = _host_features(poses, kp, valid, kp3d)
    F = poses.shape[0]

    if diag_promoted is None:
        diag_promoted = np.zeros(F - 1, bool)
    if row_of is None:
        row_of = _rows_of(F, feat_rows)
        if kfs is None:
            kfs = _select_keyframes(diag_promoted, F, allowed=None if feat_rows is None
                                    else np.asarray(feat_rows))
    rows = row_of[kfs]

    timing = {}
    t0 = time.perf_counter()
    if all_pairs is None:
        all_pairs = _all_adjacent_pair_matches(rows, kp, desc, valid, kp3d,
                                               kp3d_valid, K, cfg, dev)
    loop_edges = loop_edges or []
    loop_pairs = [(a, b) for a, b, _, _ in loop_edges]
    if loop_pairs:
        la = rows[np.asarray([a for a, _ in loop_pairs])]
        lb = rows[np.asarray([b for _, b in loop_pairs])]
        loop_matches = _loop_pair_matches(la, lb, kp, desc, valid, kp3d,
                                          kp3d_valid, K, cfg, dev)
    else:
        loop_matches = []
    timing["match_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    prob = _build_global_problem(kfs, poses, kp, desc, valid, kp3d, kp3d_valid,
                                 K, cfg, rows, all_pairs, loop_pairs,
                                 loop_matches, device=dev)
    timing["build_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    T_cw_opt, _, info = bundle_adjust(prob, cfg.ba, device=dev)
    P = len(kfs)
    T_wc_opt, final_cost, n_obs = _fetch(pose_inverse(T_cw_opt)[:P], info["final_cost"],
                                         prob.obs_valid.sum())
    timing["ba_s"] = time.perf_counter() - t0

    out_info = {"keyframes": kfs, "timing": timing, "n_obs": int(n_obs),
                "n_loop_pairs": len(loop_pairs), "final_cost": float(final_cost)}
    if not np.isfinite(T_wc_opt).all():
        out_info["skipped"] = True
        return poses.copy(), out_info

    corr = T_wc_opt @ np.linalg.inv(poses[kfs])
    tr = np.clip(0.5 * (np.einsum("pii->p", corr[:, :3, :3]) - 1.0), -1.0, 1.0)
    out_info["max_corr_rot_deg"] = float(np.degrees(np.arccos(tr)).max())
    out_info["max_corr_t_m"] = float(np.linalg.norm(corr[:, :3, 3], axis=1).max())
    if (out_info["max_corr_rot_deg"] > cfg.max_correction_rot_deg
            or out_info["max_corr_t_m"] > cfg.max_correction_t):
        out_info["skipped"] = True
        return poses.copy(), out_info

    j_of = np.clip(np.searchsorted(kfs, np.arange(F), side="right") - 1, 0, P - 1)
    refined = np.einsum("fij,fjk->fik", corr[j_of], poses)
    return refined, out_info


def _loop_pair_matches(rows_a, rows_b, kp, desc, valid, kp3d, kp3d_valid, K,
                       cfg: RefineConfig, device: str | torch.device | None = None):
    """Verified matches for arbitrary (a, b) row pairs."""
    idx, mask, _, _ = verify_row_pairs(rows_a, rows_b, kp, desc, valid, kp3d,
                                       kp3d_valid, K, cfg, device)
    return [(idx[i], mask[i]) for i in range(len(rows_a))]


def loop_rotation_discrepancy_deg(poses, kf_ids, loop_edges) -> float:
    """Median rotation angle (deg) between each verified loop edge's measured
    relative transform and the trajectory's current estimate: a GT-free probe of
    accumulated heading drift (0 when there are no edges)."""
    if not loop_edges:
        return 0.0
    kf_ids = np.asarray(kf_ids)
    angs = []
    for a, b, Z, _ in loop_edges:
        rel = np.linalg.inv(poses[kf_ids[a]]) @ poses[kf_ids[b]]
        D = np.linalg.inv(Z) @ rel
        tr = np.clip(0.5 * (np.trace(D[:3, :3]) - 1.0), -1.0, 1.0)
        angs.append(np.degrees(np.arccos(tr)))
    return float(np.median(angs))


def refine_full(poses, kp, desc, valid, kp3d, K, diag_promoted=None,
                cfg: RefineConfig | None = None, feat_rows=None, loop_cfg=None,
                ba_rot_threshold_deg: float = 1.0,
                device: str | torch.device | None = None):
    """The product refinement pipeline, adaptive as in JAX, on ``device`` (default
    cuda; raises if there is no GPU):

    1. Detect and verify loop closures on the raw odometry; the median rotation
       residual of the loop edges measures the odometry's heading drift.
    2. Below ``ba_rot_threshold_deg`` (healthy odometry): no windowed BA, a modest
       isotropic pose graph (loop_weight 1).
    3. Above it: rotation-only windowed BA (``trans_damp=0``), loops detected again
       on its output, then a rotation-stiff closure (odo_rot_info=1000).

    With no loop edge and no explicit ``cfg`` the odometry is returned unchanged.
    The pre-closure trajectory (raw odometry or its BA polish) is in
    ``info["refined_odometry"]``. Returns (closed (F, 4, 4), info dict).
    """
    from vo_tpu_torch.engine.loop_closure import (LoopClosureConfig,
                                                  detect_loop_closures,
                                                  optimize_with_loops)

    dev = resolve_device(device)
    poses = np.asarray(poses)
    F = poses.shape[0]
    if diag_promoted is None:
        diag_promoted = np.zeros(F - 1, bool)
    kfs = _select_keyframes(diag_promoted, F, allowed=None if feat_rows is None
                            else np.asarray(feat_rows))

    probe_cfg = loop_cfg if loop_cfg is not None else LoopClosureConfig()
    edges = detect_loop_closures(kfs, poses, kp, desc, valid, kp3d, K,
                                 probe_cfg, feat_rows=feat_rows, device=dev)
    rot_disc_deg = loop_rotation_discrepancy_deg(poses, kfs, edges)

    if not edges and cfg is None:
        # No loop evidence and no explicit request: nothing can verify a correction,
        # so the odometry is returned unchanged.
        return poses.copy(), {"loop_edges": 0, "pgo": {"n_loop_edges": 0,
                                                       "pgo_cost": [0.0]},
                              "ba": {"windows": [], "keyframes": kfs,
                                     "timing": {}},
                              "ran_ba": False, "loop_rot_disc_deg": 0.0,
                              "keyframes": kfs, "refined_odometry": poses.copy()}

    run_ba = (cfg is not None) or rot_disc_deg > ba_rot_threshold_deg
    if run_ba:
        if cfg is None:
            cfg = RefineConfig(trans_damp=0.0)
        refined, rinfo = refine_trajectory(poses, kp, desc, valid, kp3d, K,
                                           diag_promoted=diag_promoted, cfg=cfg,
                                           feat_rows=feat_rows, device=dev)
        if loop_cfg is None:
            loop_cfg = LoopClosureConfig(odo_rot_info=1000.0)
        edges = detect_loop_closures(kfs, refined, kp, desc, valid, kp3d, K,
                                     loop_cfg, feat_rows=feat_rows, device=dev)
    else:
        refined, rinfo = poses.copy(), {"windows": [], "keyframes": kfs,
                                        "timing": {}}
        if loop_cfg is None:
            loop_cfg = LoopClosureConfig(loop_weight=1.0)

    closed, pinfo = optimize_with_loops(refined, kfs, edges, loop_cfg, device=dev)
    return closed, {"loop_edges": len(edges), "pgo": pinfo, "ba": rinfo,
                    "ran_ba": run_ba, "loop_rot_disc_deg": rot_disc_deg,
                    "keyframes": kfs, "refined_odometry": refined}


def refine_trajectory(poses, kp, desc, valid, kp3d, K, diag_promoted=None,
                      cfg: RefineConfig = RefineConfig(), feat_rows=None,
                      device: str | torch.device | None = None):
    """BA-refine a VO trajectory in overlapping keyframe windows on ``device``
    (default cuda). Returns (refined (F, 4, 4) np, info dict).

    Args:
      poses: (F, 4, 4) camera-to-world VO estimates.
      kp/desc/valid/kp3d: fixed-budget features (tensors or arrays). Row i holds frame
          i unless ``feat_rows`` gives the frame id per row (sparse retention).
      diag_promoted: (F-1,) keyframe-promotion flags from the engine diagnostics.
    info["timing"] holds ``match_s`` (pair verification), ``ba_s`` (the solves and
    their readbacks) and ``host_s`` (the rest: problem building, gates, re-anchoring).
    """
    dev = resolve_device(device)
    poses, kp, valid, kp3d, kp3d_valid = _host_features(poses, kp, valid, kp3d)
    F = poses.shape[0]
    if diag_promoted is None:
        diag_promoted = np.zeros(F - 1, bool)
    row_of = _rows_of(F, feat_rows)
    kfs = _select_keyframes(diag_promoted, F, allowed=None if feat_rows is None
                            else np.asarray(feat_rows))

    refined = poses.copy()
    infos = []
    timing = {"match_s": 0.0, "ba_s": 0.0, "host_s": 0.0}
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    all_pairs = _all_adjacent_pair_matches(row_of[kfs], kp, desc, valid, kp3d,
                                           kp3d_valid, K, cfg, dev)
    timing["match_s"] = time.perf_counter() - t0
    step = max(cfg.window // 2, 1)
    for start in range(0, max(len(kfs) - 1, 1), step):
        ids = kfs[start:start + cfg.window]
        if len(ids) < 3:
            break
        prob = _build_window_problem(ids, refined, kp, desc, valid, kp3d,
                                     kp3d_valid, K, cfg, rows=row_of[ids],
                                     pairs={a: all_pairs[start + a]
                                            for a in range(len(ids) - 1)},
                                     device=dev)
        t0 = time.perf_counter()
        T_cw_opt, _, info = bundle_adjust(prob, cfg.ba, device=dev)
        T_wc_opt, final_cost, mean_reproj, n_obs = _fetch(
            pose_inverse(T_cw_opt), info["final_cost"], info["mean_reproj"],
            prob.obs_valid.sum())
        timing["ba_s"] += time.perf_counter() - t0
        window_info = {"final_cost": float(final_cost),
                       "mean_reproj": float(mean_reproj), "n_obs": float(n_obs)}
        window_info["cost_per_obs"] = window_info["final_cost"] / max(int(n_obs), 1)
        if not np.isfinite(T_wc_opt).all():
            # A window that diverged (too few verified observations through an
            # aggressive turn) is skipped instead of poisoning every later frame.
            window_info["skipped"] = 1.0
            infos.append(window_info)
            continue

        # Trust gates (see RefineConfig).
        corr = T_wc_opt @ np.linalg.inv(refined[ids])       # (P, 4, 4)
        if cfg.trans_damp != 1.0:
            corr = corr.copy()
            corr[:, :3, 3] *= cfg.trans_damp
        tr = np.clip(0.5 * (np.einsum("pii->p", corr[:, :3, :3]) - 1.0), -1.0, 1.0)
        max_rot = float(np.degrees(np.arccos(tr)).max())
        max_t = float(np.linalg.norm(corr[:, :3, 3], axis=1).max())
        window_info["max_corr_rot_deg"] = max_rot
        window_info["max_corr_t_m"] = max_t
        if (max_rot > cfg.max_correction_rot_deg or max_t > cfg.max_correction_t
                or window_info["cost_per_obs"] > cfg.max_cost_per_obs):
            window_info["skipped"] = 1.0
            infos.append(window_info)
            continue
        infos.append(window_info)

        # Re-anchor: each frame from ids[0] on follows its window keyframe's
        # correction (to the window's last keyframe only when not anchor_tail).
        f0 = int(ids[0])
        f1 = F if cfg.anchor_tail else int(ids[-1]) + 1
        j_of = np.searchsorted(ids, np.arange(f0, f1), side="right") - 1
        refined[f0:f1] = np.einsum("fij,fjk->fik", corr[j_of], refined[f0:f1])
    timing["host_s"] = (time.perf_counter() - t_start
                        - timing["match_s"] - timing["ba_s"])
    return refined, {"windows": infos, "keyframes": kfs, "timing": timing}
