"""Umeyama Sim(m) alignment. Port of ``vo_tpu/geometry/umeyama.py``."""

from __future__ import annotations

import torch

from vo_tpu_torch.device import device_for, to_device


def umeyama_alignment(x, y, with_scale: bool = True,
                      device: str | torch.device | None = None):
    """Least-squares Sim(m) fit aligning x onto y (Umeyama, IEEE PAMI 1991), on
    ``device`` (default: where ``x`` lies if it is a tensor, else cuda).

    x, y: (m, n) points, one column per point. Returns (R, t, c) with
    y ~= c * R @ x + t (c = 1 without ``with_scale``).
    """
    dev = device_for(x, device)
    x, y = to_device(x, dev, torch.float32), to_device(y, dev, torch.float32)
    m, n = x.shape
    mean_x = x.mean(dim=1)
    mean_y = y.mean(dim=1)
    xc = x - mean_x[:, None]
    yc = y - mean_y[:, None]

    sigma_x = torch.sum(xc * xc) / n
    cov_xy = (yc @ xc.T) / n

    u, d, vt = torch.linalg.svd(cov_xy)
    # Kabsch sign correction for a right-handed rotation (sign(0) = 0, as in JAX).
    det_sign = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    s = torch.ones(m, dtype=x.dtype, device=dev)
    s[-1] = det_sign
    R = (u * s[None, :]) @ vt

    c = torch.sum(d * s) / sigma_x if with_scale else torch.ones((), device=dev)
    t = mean_y - c * (R @ mean_x)
    return R, t, c
