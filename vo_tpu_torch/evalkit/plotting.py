"""Trajectory plotting, the counterpart of plot_utils/plot_traj.py. Port of
``vo_tpu/evalkit/plotting.py``.

Plots x-z (bird's-eye) ground-truth vs predicted trajectories and per-length error
curves with matplotlib, imported at call time (headless Agg backend); without it the
plots raise ``ImportError`` naming what is missing. The match and keypoint overlays
need only PIL.
"""

from __future__ import annotations

import numpy as np


def pyplot():
    """matplotlib's pyplot on the headless Agg backend. Raises ImportError when
    matplotlib is not installed: the trajectory plots need it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the trajectory plots (visualize_results) need matplotlib, "
                          "which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _poses_to_xz(poses) -> np.ndarray:
    if isinstance(poses, dict):
        idx = sorted(poses)
        arr = np.stack([poses[i] for i in idx])
    else:
        arr = np.asarray(poses)
    return arr[:, [0, 2], 3]


def plot_trajectories(out_path: str, pred, gt=None, title: str = "trajectory") -> str:
    """Save an x-z trajectory plot (reference: plot_traj.py:48-58 layout)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 8))
    if gt is not None:
        g = _poses_to_xz(gt)
        ax.plot(g[:, 0], g[:, 1], "k-", label="Ground Truth")
    p = _poses_to_xz(pred)
    ax.plot(p[:, 0], p[:, 1], "b-", label="Ours")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_aspect("equal")
    ax.legend(loc="upper right")
    ax.set_title(title)
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path


def plot_segment_errors(out_path: str, per_length_errors: dict,
                        title: str = "segment errors") -> str:
    """Per-length translation/rotation error curves (kittievalodom.py:311-355 style)."""
    plt = pyplot()
    lengths = sorted(per_length_errors)
    t = [per_length_errors[l][0] * 100 for l in lengths]
    r = [per_length_errors[l][1] / np.pi * 180 * 100 for l in lengths]
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 4))
    a1.plot(lengths, t, "bs-")
    a1.set_xlabel("Path Length (m)")
    a1.set_ylabel("Translation Error (%)")
    a2.plot(lengths, r, "rs-")
    a2.set_xlabel("Path Length (m)")
    a2.set_ylabel("Rotation Error (deg/100m)")
    fig.suptitle(title)
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path


def draw_matches(out_path: str, img1, img2, kp1, kp2, stride: int = 10) -> str:
    """Side-by-side match visualization (reference: vizualize_custom_matches,
    VisualOdometry_Stereo.py:162-171) — PIL-based, no OpenCV."""
    from PIL import Image, ImageDraw

    def to_rgb(im):
        im = np.asarray(im)
        if im.ndim == 2:
            im = np.stack([im] * 3, -1)
        return np.clip(im, 0, 255).astype(np.uint8)

    a, b = to_rgb(img1), to_rgb(img2)
    H = max(a.shape[0], b.shape[0])
    canvas = np.zeros((H, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    img = Image.fromarray(canvas)
    dr = ImageDraw.Draw(img)
    off = a.shape[1]
    kp1 = np.asarray(kp1)
    kp2 = np.asarray(kp2)
    for i in range(0, len(kp1), stride):
        x1, y1 = kp1[i]
        x2, y2 = kp2[i]
        dr.line([(x1, y1), (x2 + off, y2)], fill=(255, 255, 0), width=1)
        dr.ellipse([x1 - 2, y1 - 2, x1 + 2, y1 + 2], outline=(0, 255, 0))
        dr.ellipse([x2 + off - 2, y2 - 2, x2 + off + 2, y2 + 2], outline=(0, 255, 0))
    img.save(out_path)
    return out_path


def draw_keypoints(out_path: str, image, kp, valid=None) -> str:
    """Keypoint overlay (reference: vizualize_kps, VisualOdometry_Stereo.py:174-178)."""
    from PIL import Image, ImageDraw

    im = np.asarray(image)
    if im.ndim == 2:
        im = np.stack([im] * 3, -1)
    img = Image.fromarray(np.clip(im, 0, 255).astype(np.uint8))
    dr = ImageDraw.Draw(img)
    kp = np.asarray(kp)
    v = np.ones(len(kp), bool) if valid is None else np.asarray(valid)
    for (x, y), ok in zip(kp, v):
        if ok:
            dr.ellipse([x - 2, y - 2, x + 2, y + 2], outline=(0, 255, 255))
    img.save(out_path)
    return out_path
