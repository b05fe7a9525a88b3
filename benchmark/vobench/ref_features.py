"""The plain reference of the front-ends: image filters, the Harris detector with
fixed-budget selection, upright dense BRIEF, back-projection, and the bilinear resize
that the R2D2 pyramid uses.

A frozen copy of the port's plain versions (its ``ops/image``, ``features/detect``,
``features/dense_brief`` and ``geometry/camera``), kept here so that the yardstick
does not move when the program does. It imports nothing of the program. The filters
run in the dtype of the image they are given: fp32 is the configuration's precision,
bf16 the control's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

def _conv1d(img: torch.Tensor, kernel: list[float], axis: int) -> torch.Tensor:
    """Depthwise 1-D SAME convolution along H (axis=1) or W (axis=2) of (B, H, W)."""
    k = len(kernel)
    pad = (k - 1) // 2
    xp = F.pad(img, (0, 0, pad, pad) if axis == 1 else (pad, pad))
    n = img.shape[axis]
    out = torch.zeros_like(img)
    for i, w in enumerate(kernel):
        out = out + w * xp.narrow(axis, i, n)
    return out


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> list[float]:
    """Normalised Gaussian taps as the fp32 values the JAX package computes."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    total = torch.zeros((), dtype=torch.float32)
    for v in k:           # sequential, as XLA reduces this short vector
        total = total + v
    return (k / total).tolist()


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur over (B, H, W)."""
    k = gaussian_kernel1d(sigma, radius)
    return _conv1d(_conv1d(img, k, axis=1), k, axis=2)


def sobel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel dx, dy over (B, H, W) via separable [1 2 1] x [-1 0 1] kernels."""
    smooth = [1.0, 2.0, 1.0]
    diff = [-1.0, 0.0, 1.0]
    gx = _conv1d(_conv1d(img, smooth, axis=1), diff, axis=2)
    gy = _conv1d(_conv1d(img, diff, axis=1), smooth, axis=2)
    return gx, gy


def maxpool2d_same(img: torch.Tensor, size: int) -> torch.Tensor:
    """size x size max pool, stride 1, SAME, padded with -inf (the NMS block)."""
    pad = (size - 1) // 2
    return F.max_pool2d(img[:, None], size, stride=1, padding=pad)[:, 0]


def _resize_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) fp32 triangle-kernel interpolation matrix: half-pixel centres,
    the kernel widened by the downscale factor (antialiased, as ``jax.image.resize``'s
    'bilinear')."""
    scale = n_in / n_out
    width = max(scale, 1.0)
    centers = (torch.arange(n_out, device=device) + 0.5) * scale - 0.5
    src = torch.arange(n_in, device=device)
    d = torch.abs(src[None, :] - centers[:, None]) / width
    m = torch.clamp(1.0 - d, min=0.0)
    return m / torch.sum(m, dim=1, keepdim=True)


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, H, W) or (B, H, W, C) as two dense fp32 products."""
    Ho, Wo = out_hw
    H, W = img.shape[1:3]
    if (H, W) == (Ho, Wo):
        return img
    mh = _resize_matrix(H, Ho, img.device).to(img.dtype)
    mw = _resize_matrix(W, Wo, img.device).to(img.dtype)
    if img.ndim == 3:
        return torch.einsum("oh,bhw,wp->bop", mh, img, mw.T)
    return torch.einsum("oh,bhwc,wp->bopc", mh, img, mw.T)


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


def _gather_hw(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img (B, H, W) at integer rows y and columns x, each (B, ...) and broadcast
    together -> (B, ...)."""
    B, W = img.shape[0], img.shape[-1]
    idx = y * W + x
    return torch.gather(img.reshape(B, -1), 1, idx.reshape(B, -1)).reshape(idx.shape)


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


BRIEF_BITS = 256


_PATTERN_RADIUS = 13


def dense_brief_offsets(bits: int = BRIEF_BITS, seed: int = 8214) -> np.ndarray:
    """(bits, 2, 2) integer [pair, point, (dx, dy)] offsets; the JAX package's table."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, _PATTERN_RADIUS / 2.0, size=(bits, 2, 2))
    return np.clip(np.round(pts), -_PATTERN_RADIUS, _PATTERN_RADIUS).astype(np.int32)


def dense_packed_brief(gray: torch.Tensor, bits: int = BRIEF_BITS,
                       blur_sigma: float = 2.0) -> torch.Tensor:
    """(B, H, W) gray -> (B, H, W, bits // 32) int32 words (uint32 bit patterns)."""
    offsets = dense_brief_offsets(bits)
    smoothed = gaussian_blur(gray, blur_sigma)
    pad = _PATTERN_RADIUS
    B, H, W = gray.shape
    xp = F.pad(smoothed.to(torch.bfloat16), (pad, pad, pad, pad))

    words = []
    acc = torch.zeros((B, H, W), dtype=torch.int32, device=gray.device)
    for b in range(bits):
        (ax, ay), (bx, by) = offsets[b]
        va = xp[:, ay + pad: ay + pad + H, ax + pad: ax + pad + W]
        vb = xp[:, by + pad: by + pad + H, bx + pad: bx + pad + W]
        acc = acc | ((va < vb).to(torch.int32) << (b % 32))
        if b % 32 == 31:
            words.append(acc)
            acc = torch.zeros((B, H, W), dtype=torch.int32, device=gray.device)
    return torch.stack(words, dim=-1)


def gather_brief_descriptors(packed: torch.Tensor, kp: torch.Tensor,
                             valid: torch.Tensor, bits: int = BRIEF_BITS) -> torch.Tensor:
    """Gather packed words at (B, K, 2) keypoints -> (B, K, bits) +-1 bf16, 0 if invalid."""
    B, H, W, nw = packed.shape
    xi = kp[..., 0].to(torch.int64).clamp(0, W - 1)
    yi = kp[..., 1].to(torch.int64).clamp(0, H - 1)
    flat = (yi * W + xi)[..., None].expand(B, kp.shape[1], nw)
    words = torch.gather(packed.reshape(B, H * W, nw), 1, flat)          # (B, K, nw)
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bitvals = (words[..., None] >> shifts) & 1                          # (B, K, nw, 32)
    desc = bitvals.reshape(B, kp.shape[1], nw * 32).to(torch.bfloat16) * 2.0 - 1.0
    return torch.where(valid[..., None], desc, 0.0)


def unproject(kp: torch.Tensor, depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + depth (...) -> camera-frame points (..., 3): d K^-1 [u, v, 1]."""
    x = (kp[..., 0] - K[0, 2]) / K[0, 0]
    y = (kp[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x * depth, y * depth, depth], dim=-1)
