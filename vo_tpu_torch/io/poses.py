"""Pose file interop with the reference formats. A copy of ``vo_tpu/io/poses.py``.

Round-trips the exact on-disk formats of the reference so a user can mix tools:
- ``global_poses.npy``: stacked (N, 4, 4) float poses (vo_stereo_runner.py:60).
- KITTI txt: 12 numbers per line, row-major 3x4 (plot_utils/prepare_data.py:8-27 writes a
  16-number variant including the homogeneous row; the evaluator accepts 12 or 13 columns,
  kittievalodom.py:104-115 — we write the standard 12).
- ``*_modified.txt``: GT 3x4 rows padded with the homogeneous row (prepare_data.py:18-27).
"""

from __future__ import annotations

import numpy as np


def save_poses_npy(path: str, poses: np.ndarray) -> None:
    """Write stacked (N, 4, 4) poses, same layout the reference saves."""
    np.save(path, np.asarray(poses))


def load_poses_npy(path: str) -> np.ndarray:
    return np.load(path)


def write_kitti_txt(path: str, poses: np.ndarray, n_cols: int = 12) -> None:
    """Write poses as KITTI-format txt (12 numbers/line; 16 to mimic prepare_data.py:8-15)."""
    poses = np.asarray(poses)
    with open(path, "w") as f:
        for P in poses:
            flat = P.reshape(16) if n_cols == 16 else P[:3, :4].reshape(12)
            f.write(" ".join(f"{v:.12g}" for v in flat) + "\n")


def poses_npy_to_kitti_txt(npy_path: str, txt_path: str, n_cols: int = 16) -> None:
    """npy -> txt conversion, matching prepare_data.py:8-15 (which writes all 16 numbers)."""
    write_kitti_txt(txt_path, load_poses_npy(npy_path), n_cols=n_cols)


def kitti_gt_to_modified_txt(gt_txt_path: str, out_path: str | None = None) -> str:
    """Pad 3x4 GT rows to 4x4 rows, matching prepare_data.py:18-27 (_modified.txt)."""
    if out_path is None:
        out_path = gt_txt_path.rsplit(".txt", 1)[0] + "_modified.txt"
    rows = np.loadtxt(gt_txt_path)
    with open(out_path, "w") as f:
        for r in rows:
            vals = list(r) + [0.0, 0.0, 0.0, 1.0]
            f.write(" ".join(str(v) for v in vals) + "\n")
    return out_path
