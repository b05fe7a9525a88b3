"""Self-supervised training pairs: random-homography warps with exact ground-truth flow.
Port of ``vo_tpu/train/pairs.py``.

One call makes a batch of (img1, img2, flow, mask) on the device of its key, with no
host data loader in the loop and no host sync: procedural textures (random Fourier
features) or given images, one random homography per image, the warp with its exact
flow, and optional photometric jitter on the warped view. The draws are the JAX
package's (``prng`` is ``jax.random``'s threefry), so the same key gives the same
pairs up to fp32 rounding. What ``jax.vmap`` maps over images is batched tensor code
here.
"""

from __future__ import annotations

import math

import torch

from vo_tpu_torch import prng
from vo_tpu_torch.ops.smalllinalg import adjugate3x3


def procedural_texture(key: torch.Tensor, batch: int, H: int, W: int,
                       n_waves: int = 48) -> torch.Tensor:
    """(B, H, W) smooth band-limited textures in [0, 255], corner-rich and seeded."""
    k1, k2, k3 = prng.split(key, 3).unbind(-2)
    freq = prng.uniform(k1, (batch, n_waves, 2), 0.02, 0.35)
    phase = prng.uniform(k2, (batch, n_waves), 0.0, 2 * math.pi)
    amp = prng.uniform(k3, (batch, n_waves), 0.3, 1.0)
    ys = torch.arange(H, dtype=torch.float32, device=key.device)
    xs = torch.arange(W, dtype=torch.float32, device=key.device)
    arg = (freq[..., 0, None, None] * ys[None, None, :, None]
           + freq[..., 1, None, None] * xs[None, None, None, :]
           + phase[..., None, None])
    img = (amp[..., None, None] * torch.sin(arg)).sum(dim=1)
    img = img / (torch.abs(img).amax(dim=(1, 2), keepdim=True) + 1e-6)
    return torch.clamp(img * 100.0 + 128.0, 0.0, 255.0)


def random_homography(key: torch.Tensor, H: int, W: int, max_rot: float = 0.35,
                      max_scale: float = 0.25, max_persp: float = 3e-4,
                      max_shift: float = 0.08) -> torch.Tensor:
    """Random 3x3 homography about the image centre (rotation, scale, shear,
    perspective, shift) per key: keys (..., 2) -> (..., 3, 3)."""
    kr, ks, kp, kt, ksh = prng.split(key, 5).unbind(-2)
    ang = prng.uniform(kr, (), -max_rot, max_rot)
    sc = torch.exp(prng.uniform(ks, (2,), -max_scale, max_scale))
    sh = prng.uniform(ksh, (), -0.15, 0.15)
    persp = prng.uniform(kp, (2,), -max_persp, max_persp)
    shift = prng.uniform(kt, (2,), -max_shift, max_shift)
    c, s = torch.cos(ang), torch.sin(ang)
    zero, one = torch.zeros_like(ang), torch.ones_like(ang)
    A = torch.stack([torch.stack([c * sc[..., 0], -s * sc[..., 1] + sh, shift[..., 0] * W], -1),
                     torch.stack([s * sc[..., 0], c * sc[..., 1], shift[..., 1] * H], -1),
                     torch.stack([persp[..., 0], persp[..., 1], one], -1)], -2)
    # Conjugate by the centre translation so the transform pivots on the image centre.
    C = torch.stack([torch.stack([one, zero, zero - W / 2], -1),
                     torch.stack([zero, one, zero - H / 2], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    Cinv = torch.stack([torch.stack([one, zero, zero + W / 2], -1),
                        torch.stack([zero, one, zero + H / 2], -1),
                        torch.stack([zero, zero, one], -1)], -2)
    return Cinv @ A @ C


def _apply_h(Hmat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) homographies applied to (..., N, 2) points."""
    p = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1) @ Hmat.transpose(-1, -2)
    return p[..., :2] / torch.clamp(p[..., 2:], min=1e-8)


def bilinear_at(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W[, C]) at (B, N, 2) float [x, y] -> (B, N[, C]): the coordinates
    clamped into the image, the 2 x 2 cell's corner clamped to (W - 2, H - 2)."""
    B, H, W = img.shape[:3]
    x = torch.clamp(xy[..., 0], 0.0, W - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    fx, fy = x - x0, y - y0
    if img.ndim == 4:
        fx, fy = fx[..., None], fy[..., None]
    b = torch.arange(B, device=img.device)[:, None]
    return ((1 - fy) * ((1 - fx) * img[b, y0, x0] + fx * img[b, y0, x0 + 1])
            + fy * ((1 - fx) * img[b, y0 + 1, x0] + fx * img[b, y0 + 1, x0 + 1]))


def warp_pair(img: torch.Tensor, Hmat: torch.Tensor):
    """Warp (..., H, W) images by (..., 3, 3) homographies.

    Returns (img2, flow (..., H, W, 2), mask): img2[p] = img[H^-1 p]; flow maps img
    coordinates to img2 coordinates (flow[y, x] = H [x, y]); mask marks pixels whose
    correspondence lands inside img2.
    """
    lead = img.shape[:-2]
    Hh, Ww = img.shape[-2:]
    img = img.reshape(-1, Hh, Ww)
    Hmat = Hmat.reshape(-1, 3, 3)
    ys = torch.arange(Hh, dtype=torch.float32, device=img.device)
    xs = torch.arange(Ww, dtype=torch.float32, device=img.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).reshape(1, Hh * Ww, 2)

    # Where img2 samples img: H^-1 by its adjugate (no LU, no host sync).
    adj = adjugate3x3(Hmat)
    det = (Hmat[:, 0, 0] * adj[:, 0, 0] + Hmat[:, 0, 1] * adj[:, 1, 0]
           + Hmat[:, 0, 2] * adj[:, 2, 0])
    src = _apply_h(adj / det[:, None, None], grid).reshape(-1, Hh, Ww, 2)
    img2 = bilinear_at(img, src.reshape(src.shape[0], -1, 2)).reshape(src.shape[:3])
    in_src = ((src[..., 0] >= 0) & (src[..., 0] <= Ww - 1)
              & (src[..., 1] >= 0) & (src[..., 1] <= Hh - 1))
    img2 = torch.where(in_src, img2, 0.0)

    flow = _apply_h(Hmat, grid).reshape(-1, Hh, Ww, 2)         # img -> img2 coordinates
    mask = ((flow[..., 0] >= 0) & (flow[..., 0] <= Ww - 1)
            & (flow[..., 1] >= 0) & (flow[..., 1] <= Hh - 1))
    return (img2.reshape(*lead, Hh, Ww), flow.reshape(*lead, Hh, Ww, 2),
            mask.reshape(*lead, Hh, Ww))


def synthetic_pair_batch(key: torch.Tensor, batch: int, H: int, W: int,
                         photometric: bool = False):
    """A batch on the key's device: (img1, img2 (B, H, W), flow (B, H, W, 2), mask
    (B, H, W)). ``photometric=True`` adds gain/bias/gamma/noise jitter to the warped
    view."""
    k_tex, k_h, k_p = prng.split(key, 3).unbind(-2)
    img1 = procedural_texture(k_tex, batch, H, W)
    img2, flow, mask = warp_pair(img1, random_homography(prng.split(k_h, batch), H, W))
    if photometric:
        img2 = photometric_augment(prng.split(k_p, batch), img2)
    return img1, img2, flow, mask


def photometric_augment(key: torch.Tensor, img: torch.Tensor, max_gain: float = 0.25,
                        max_bias: float = 20.0, max_gamma: float = 0.25,
                        noise_std: float = 5.0) -> torch.Tensor:
    """Correspondence-preserving photometric jitter of (..., H, W) images in [0, 255],
    one key (..., 2) per image: gain/bias, gamma and i.i.d. pixel noise. The geometry
    is untouched, so flow and mask stay exact."""
    kg, kb, kgam, kn = prng.split(key, 4).unbind(-2)
    gain = torch.exp(prng.uniform(kg, (), -max_gain, max_gain))[..., None, None]
    bias = prng.uniform(kb, (), -max_bias, max_bias)[..., None, None]
    gamma = torch.exp(prng.uniform(kgam, (), -max_gamma, max_gamma))[..., None, None]
    noise = noise_std * prng.normal(kn, tuple(img.shape[-2:]))
    x = torch.clamp(img / 255.0, 0.0, 1.0) ** gamma
    return torch.clamp(255.0 * gain * x + bias + noise, 0.0, 255.0)


def pair_batch_from_images(key: torch.Tensor, images, photometric: bool = True):
    """Training pairs from given (B, H, W) images (on the key's device): a random
    homography warp with exact flow, and photometric jitter on the warped view.
    Returns (img1, img2, flow, mask) like ``synthetic_pair_batch``."""
    images = torch.as_tensor(images, dtype=torch.float32, device=key.device)
    B, H, W = images.shape
    k_h, k_p = prng.split(key).unbind(-2)
    img2, flow, mask = warp_pair(images, random_homography(prng.split(k_h, B), H, W))
    if photometric:
        img2 = photometric_augment(prng.split(k_p, B), img2)
    return images, img2, flow, mask


def photometric_augment_batch(key: torch.Tensor, imgs: torch.Tensor) -> torch.Tensor:
    """Photometric jitter of a (B, H, W) batch, one key per image split from ``key``."""
    return photometric_augment(prng.split(key, imgs.shape[0]), imgs)


def warp_eval_batch(key: torch.Tensor, images, photometric: bool = True):
    """The MMA harness's pairs: per-image random homographies, the warp and (optional)
    photometric jitter. Returns (Hmats (B, 3, 3), img2 (B, H, W))."""
    images = torch.as_tensor(images, dtype=torch.float32, device=key.device)
    B, H, W = images.shape
    k_h, k_p = prng.split(key).unbind(-2)
    Hmats = random_homography(prng.split(k_h, B), H, W)
    img2, _, _ = warp_pair(images, Hmats)
    if photometric:
        img2 = photometric_augment(prng.split(k_p, B), img2)
    return Hmats, img2
