"""Optical-flow and heatmap visualization. Port of ``vo_tpu/utils/viz.py``.

Counterpart of the reference's R2D2 viz tools:
  * ``make_color_wheel`` / ``flow_to_color``  <- tools/viz.py:10-138 (Middlebury flow
    color wheel: RY/YG/GC/CB/BM/MR sectors, angle -> hue, magnitude -> saturation)
  * ``heatmap_overlay`` / ``save_heatmaps``   <- viz_heatmaps.py (reliability /
    repeatability maps blended over the input image)

Pure numpy + PIL at call time; tensors are taken to the host first
(``heatmap_overlay(img, rel.cpu().numpy())``).
"""

from __future__ import annotations

import numpy as np


def make_color_wheel() -> np.ndarray:
    """(55, 3) uint8 Middlebury color wheel (tools/viz.py:10-50 layout): six sectors
    RY=15, YG=6, GC=4, CB=11, BM=13, MR=6 with linear ramps between primaries."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    n = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((n, 3), np.float64)
    col = 0
    # RY: red -> yellow
    wheel[col:col + RY, 0] = 255
    wheel[col:col + RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    # YG: yellow -> green
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    # GC: green -> cyan
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    # CB: cyan -> blue
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    # BM: blue -> magenta
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    # MR: magenta -> red
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel.astype(np.uint8)


_WHEEL = make_color_wheel()


def flow_to_color(flow: np.ndarray, max_mag: float | None = None,
                  unknown_thr: float = 1e7) -> np.ndarray:
    """(H, W, 2) flow [dx, dy] -> (H, W, 3) uint8 color coding (tools/viz.py:53-138).

    Direction maps to hue around the wheel; magnitude (normalized by ``max_mag`` or the
    image max) maps to saturation. Unknown flow (|component| > unknown_thr or NaN)
    renders black.
    """
    flow = np.asarray(flow, np.float64)
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    bad = (~np.isfinite(u)) | (~np.isfinite(v)) | (np.abs(u) > unknown_thr) \
        | (np.abs(v) > unknown_thr)
    u[bad] = 0.0
    v[bad] = 0.0

    mag = np.sqrt(u ** 2 + v ** 2)
    scale = float(max_mag) if max_mag else max(float(mag.max()), 1e-9)
    u, v, mag = u / scale, v / scale, np.minimum(mag / scale, 1.0)

    n = len(_WHEEL)
    ang = np.arctan2(-v, -u) / np.pi                    # [-1, 1]
    fk = (ang + 1.0) / 2.0 * (n - 1)                    # [0, n-1]
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % n
    f = (fk - k0)[..., None]
    col = (1 - f) * _WHEEL[k0] / 255.0 + f * _WHEEL[k1] / 255.0
    # Desaturate toward white with decreasing magnitude (Middlebury convention).
    col = 1.0 - mag[..., None] * (1.0 - col)
    col[bad] = 0.0
    return np.clip(col * 255.0, 0, 255).astype(np.uint8)


def _colormap_jet(x: np.ndarray) -> np.ndarray:
    """Minimal jet colormap for (H, W) values in [0, 1] -> (H, W, 3) float [0, 1]."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    return np.stack([r, g, b], -1)


def heatmap_overlay(image: np.ndarray, heat: np.ndarray,
                    alpha: float = 0.5) -> np.ndarray:
    """Blend a confidence map over an image (viz_heatmaps.py behavior).

    Args:
      image: (H, W) or (H, W, 3) in [0, 255].
      heat: (h, w) map, any positive range; min-max normalized, nearest-upsampled to
        the image size if the net ran at reduced resolution.
    Returns (H, W, 3) uint8.
    """
    im = np.asarray(image, np.float64)
    if im.ndim == 2:
        im = np.stack([im] * 3, -1)
    H, W = im.shape[:2]
    h = np.asarray(heat, np.float64)
    h = (h - h.min()) / max(h.max() - h.min(), 1e-9)
    if h.shape != (H, W):
        yi = np.minimum((np.arange(H) * h.shape[0] // H), h.shape[0] - 1)
        xi = np.minimum((np.arange(W) * h.shape[1] // W), h.shape[1] - 1)
        h = h[yi[:, None], xi[None, :]]
    color = _colormap_jet(h) * 255.0
    out = (1 - alpha) * im + alpha * color
    return np.clip(out, 0, 255).astype(np.uint8)


def save_heatmaps(out_prefix: str, image, reliability, repeatability,
                  alpha: float = 0.5) -> list[str]:
    """Write ``<prefix>_reliability.png`` / ``<prefix>_repeatability.png`` overlays —
    the reference's viz_heatmaps.py CLI output, minus matplotlib."""
    from PIL import Image

    paths = []
    for name, heat in (("reliability", reliability), ("repeatability", repeatability)):
        arr = heatmap_overlay(np.asarray(image), np.asarray(heat), alpha)
        p = f"{out_prefix}_{name}.png"
        Image.fromarray(arr).save(p)
        paths.append(p)
    return paths


def save_flow_png(out_path: str, flow, max_mag: float | None = None) -> str:
    """Write a flow color-coding PNG (tools/viz.py ``show_flow`` file-output analog)."""
    from PIL import Image

    Image.fromarray(flow_to_color(np.asarray(flow), max_mag)).save(out_path)
    return out_path
