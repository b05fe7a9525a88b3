"""The KITTI odometry segment errors and the trajectory gate of the repository's bench.

A frozen copy of the repository's evaluator's segment metric (itself the reference
``KittiEvalOdom``'s definitions: both trajectories aligned to their first frame,
segments of 100-800 m started every 10 frames, translation error with dy forced to 0)
and of the bench's ``_score``: seg-trans < 1.5 %, seg-rot < 2 deg / 100 m, accept
rate > 0.8.
"""

from __future__ import annotations

import numpy as np

LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)
STEP_FRAMES = 10


def _rotation_error(E: np.ndarray) -> float:
    d = 0.5 * (E[0, 0] + E[1, 1] + E[2, 2] - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))


def _translation_error(E: np.ndarray) -> float:
    return float(np.sqrt(E[0, 3] ** 2 + E[2, 3] ** 2))


def segment_errors(gt: np.ndarray, pred: np.ndarray) -> tuple[float, float]:
    """(seg-trans %, seg-rot deg / 100 m) of (F, 4, 4) camera-to-world ``pred``
    against ``gt``; (0, 0) when the drive is shorter than 100 m."""
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    gt = np.linalg.inv(gt[0]) @ gt
    pred = np.linalg.inv(pred[0]) @ pred
    step = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)
    dist = np.concatenate([[0.0], np.cumsum(step)])
    errs = []
    for first in range(0, len(gt), STEP_FRAMES):
        for length in LENGTHS:
            beyond = np.nonzero(dist[first:] > dist[first] + length)[0]
            if not beyond.size:
                continue
            last = int(beyond[0]) + first
            d_gt = np.linalg.inv(gt[first]) @ gt[last]
            d_pred = np.linalg.inv(pred[first]) @ pred[last]
            E = np.linalg.inv(d_pred) @ d_gt
            errs.append((_rotation_error(E) / length, _translation_error(E) / length))
    if not errs:
        return 0.0, 0.0
    r = float(np.mean([e[0] for e in errs]))
    t = float(np.mean([e[1] for e in errs]))
    return t * 100.0, r / np.pi * 180.0 * 100.0


def gate(gt: np.ndarray, pred: np.ndarray, accepted: np.ndarray) -> dict:
    """The bench's trajectory gate: {"seg_trans_pct", "seg_rot_deg_100m",
    "reject_rate"}."""
    t, r = segment_errors(gt, pred)
    return {"seg_trans_pct": t, "seg_rot_deg_100m": r,
            "reject_rate": 1.0 - float(np.mean(np.asarray(accepted, bool)))}
