"""Batched image primitives over (B, H, W) tensors. Port of ``vo_tpu/ops/image.py``.

Keypoint ranking downstream depends on the last bits of the corner response, so the
filters repeat the JAX package's arithmetic exactly: zero-padded shift-and-add summed
tap by tap in order (no ``F.conv2d``), and Gaussian taps computed on the CPU in fp32
with a sequential sum, then applied as fp32 scalars on whatever device holds the image.
The pyramid's resize is two dense fp32 products, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8/float RGB -> (..., H, W) fp32 gray, BT.601 weights."""
    img = img.to(torch.float32)
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


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
