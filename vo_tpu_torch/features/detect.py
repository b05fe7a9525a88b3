"""Corner and blob responses, NMS and fixed-budget keypoint selection over (B, H, W)
tensors.

Port of ``vo_tpu/features/detect.py``. Selection is index-exact with the JAX package:
- the tile-median floor averages the two middle values of an even count, as
  ``jnp.median`` does (``torch.median`` returns the lower one);
- top-k is a stable descending sort, so equal scores go to the lower flat index, as
  ``lax.top_k`` orders them (``torch.topk`` promises no tie order);
- the 2x2 sub-position argmax takes the first of equal values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vo_tpu_torch.ops.image import gaussian_blur, maxpool2d_same, sobel_gradients


def _structure_tensor(gray: torch.Tensor, sigma_d: float, sigma_i: float):
    g = gaussian_blur(gray, sigma_d)
    gx, gy = sobel_gradients(g)
    ixx = gaussian_blur(gx * gx, sigma_i)
    iyy = gaussian_blur(gy * gy, sigma_i)
    ixy = gaussian_blur(gx * gy, sigma_i)
    return ixx, iyy, ixy


def harris_response(gray: torch.Tensor, k: float = 0.04,
                    sigma_d: float = 1.0, sigma_i: float = 1.5) -> torch.Tensor:
    """Harris corner response det(M) - k tr(M)^2 over (B, H, W) grayscale."""
    ixx, iyy, ixy = _structure_tensor(gray, sigma_d, sigma_i)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def shi_tomasi_response(gray: torch.Tensor, sigma_d: float = 1.0,
                        sigma_i: float = 1.5) -> torch.Tensor:
    """Min-eigenvalue (Shi-Tomasi) response over (B, H, W)."""
    ixx, iyy, ixy = _structure_tensor(gray, sigma_d, sigma_i)
    half_tr = 0.5 * (ixx + iyy)
    disc = torch.sqrt(torch.clamp(half_tr * half_tr - (ixx * iyy - ixy * ixy), min=0.0))
    return half_tr - disc


def dog_response(gray: torch.Tensor, sigma: float = 1.0, k: float = 1.6) -> torch.Tensor:
    """|Difference of Gaussians| blob response over (B, H, W): SIFT's within-level
    detector (the pyramid supplies the octaves); bright and dark blobs both count."""
    return torch.abs(gaussian_blur(gray, k * sigma) - gaussian_blur(gray, sigma))


def _gather_hw(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img (B, H, W) at integer (B, K) rows y and columns x."""
    W = img.shape[-1]
    return torch.gather(img.reshape(img.shape[0], -1), 1, y * W + x)


def refine_subpixel(response: torch.Tensor, kp: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Parabola peak interpolation, offsets clamped to (-0.5, 0.5); invalid rows pass."""
    B, H, W = response.shape
    xi = kp[..., 0].to(torch.int64).clamp(1, W - 2)
    yi = kp[..., 1].to(torch.int64).clamp(1, H - 2)
    c = _gather_hw(response, yi, xi)
    xm = _gather_hw(response, yi, xi - 1)
    xp = _gather_hw(response, yi, xi + 1)
    ym = _gather_hw(response, yi - 1, xi)
    yp = _gather_hw(response, yi + 1, xi)

    def off(m, p):
        denom = m - 2.0 * c + p
        d = torch.where(denom.abs() > 1e-12, 0.5 * (m - p) / denom, 0.0)
        return d.clamp(-0.5, 0.5)

    dx = torch.where(valid, off(xm, xp), 0.0)
    dy = torch.where(valid, off(ym, yp), 0.0)
    return kp + torch.stack([dx, dy], dim=-1)


def _median_rows(x: torch.Tensor) -> torch.Tensor:
    """Row median of (B, n), averaging the two middle values like ``jnp.median``."""
    s, _ = torch.sort(x, dim=1)
    n = x.shape[1]
    return (s[:, (n - 1) // 2] + s[:, n // 2]) * 0.5


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row top-k of (B, n) with ties to the lower index (``lax.top_k`` order)."""
    score, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return score[:, :k], idx[:, :k]


def detect_keypoints(
    response: torch.Tensor,
    max_kp: int = 2048,
    nms_size: int = 5,
    rel_threshold: float = 1e-4,
    border: int = 16,
    subpixel: bool = False,
):
    """Top ``max_kp`` NMS-surviving peaks per image above a robust floor.

    The floor is ``rel_threshold`` times 10x the median of 32-px tile maxima.
    Returns kp (B, max_kp, 2) fp32 [x, y] (0 where invalid), score (B, max_kp),
    valid (B, max_kp) bool.
    """
    B, H, W = response.shape
    dev = response.device
    is_peak = response >= maxpool2d_same(response, nms_size)

    col = torch.arange(W, device=dev)[None, None, :]
    row = torch.arange(H, device=dev)[None, :, None]
    in_border = ((col >= border) & (col < W - border)
                 & (row >= border) & (row < H - border))

    t = 32
    Hp, Wp = -(-H // t) * t, -(-W // t) * t
    rp = F.pad(response, (0, Wp - W, 0, Hp - H), value=0.0)
    tiles = rp.reshape(B, Hp // t, t, Wp // t, t).amax(dim=(2, 4))
    scale = 10.0 * _median_rows(torch.clamp(tiles.reshape(B, -1), min=0.0))
    scale = torch.clamp(scale, min=1e-20)[:, None, None]
    strong = response > rel_threshold * scale

    masked = torch.where(is_peak & in_border & strong, response, float("-inf"))

    Hp, Wp = H + (H % 2), W + (W % 2)
    if max_kp > (Hp // 2) * (Wp // 2):
        # Tiny image / large budget: flat top-k over all pixels.
        score, idx = _top_k(masked.reshape(B, -1), min(max_kp, H * W))
        pad_k = max_kp - score.shape[1]
        if pad_k:
            score = F.pad(score, (0, pad_k), value=float("-inf"))
            idx = F.pad(idx, (0, pad_k))
        y = (idx // W).to(torch.float32)
        x = (idx % W).to(torch.float32)
        valid = torch.isfinite(score)
        kp = torch.stack([torch.where(valid, x, 0.0), torch.where(valid, y, 0.0)], dim=-1)
        if subpixel:
            kp = refine_subpixel(response, kp, valid)
        return kp, torch.where(valid, score, 0.0), valid
    if (Hp, Wp) != (H, W):
        masked = F.pad(masked, (0, Wp - W, 0, Hp - H), value=float("-inf"))
    cmax = masked.reshape(B, Hp // 2, 2, Wp // 2, 2).amax(dim=(2, 4))

    score, idx = _top_k(cmax.reshape(B, -1), max_kp)
    cy = idx // (Wp // 2)
    cx = idx % (Wp // 2)
    subs = torch.stack([_gather_hw(masked, 2 * cy, 2 * cx),
                        _gather_hw(masked, 2 * cy, 2 * cx + 1),
                        _gather_hw(masked, 2 * cy + 1, 2 * cx),
                        _gather_hw(masked, 2 * cy + 1, 2 * cx + 1)], dim=-1)
    sel = torch.argmax(subs, dim=-1)          # 2*dy + dx, first of equal values
    y = (2 * cy + sel // 2).to(torch.float32)
    x = (2 * cx + sel % 2).to(torch.float32)
    valid = torch.isfinite(score)
    kp = torch.stack([torch.where(valid, x, 0.0), torch.where(valid, y, 0.0)], dim=-1)
    if subpixel:
        kp = refine_subpixel(response, kp, valid)
    score = torch.where(valid, score, 0.0)
    return kp, score, valid
