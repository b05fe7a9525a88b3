"""SIFT-style 128-d gradient-orientation-histogram descriptors, dense-first.

Port of ``vo_tpu/features/gradhist.py``:

1. dense gradients -> magnitude and orientation, soft-assigned to 8 orientation
   planes;
2. each plane blurred once, which is the weighted in-cell accumulation for every
   pixel at once;
3. a keypoint's descriptor is 16 gathers (a 4 x 4 cell grid) from the 8 planes ->
   128 values, then SIFT's normalise -> clamp 0.2 -> renormalise, as bf16.

The oriented variant turns the cell grid by the keypoint's dominant orientation and
shifts the 8 bins back by it (linear interpolation between the two nearest bins).
"""

from __future__ import annotations

import math

import torch

from vo_tpu_torch.ops.image import gaussian_blur, sobel_gradients

N_ORI = 8
N_CELLS = 4          # 4x4 spatial grid
CELL_SIZE = 4        # px per cell => 16x16 px support


def _bin_centers(device) -> torch.Tensor:
    return (torch.arange(N_ORI, device=device) + 0.5) * (2 * math.pi / N_ORI) - math.pi


def _cell_offsets(device) -> torch.Tensor:
    """(16, 2) [x, y] cell-centre offsets, row-major over the 4 x 4 grid."""
    c = (torch.arange(N_CELLS, device=device) - (N_CELLS - 1) / 2.0) * CELL_SIZE
    oy, ox = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)


def dense_orientation_planes(gray: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H, W, 8) blurred orientation-magnitude planes."""
    g = gaussian_blur(gray, 1.2)
    gx, gy = sobel_gradients(g)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    theta = torch.atan2(gy, gx)                                    # [-pi, pi]

    # Soft assignment to 8 bins, linear in the angle distance; remainder is the floor
    # modulo of jnp's %, so the wrapped distance lies in [-pi, pi).
    d = theta[..., None] - _bin_centers(gray.device)
    d = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
    bin_width = 2 * math.pi / N_ORI
    w = torch.clamp(1.0 - torch.abs(d) / bin_width, 0.0, 1.0)
    planes = mag[..., None] * w                                    # (B, H, W, 8)

    # Each plane blurred on its own: the planes move into the batch axis and back.
    B, H, W, _ = planes.shape
    flat = planes.permute(0, 3, 1, 2).reshape(B * N_ORI, H, W)
    pooled = gaussian_blur(flat, CELL_SIZE * 0.6)
    return pooled.reshape(B, N_ORI, H, W).permute(0, 2, 3, 1)


def _gather_cells(pooled: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 8) planes at the rounded, clamped (B, K, C, 2) points -> (B, K, C, 8)."""
    B, H, W, _ = pooled.shape
    xi = torch.round(pts[..., 0]).to(torch.int64).clamp(0, W - 1)
    yi = torch.round(pts[..., 1]).to(torch.int64).clamp(0, H - 1)
    flat = (yi * W + xi).reshape(B, -1, 1).expand(-1, -1, N_ORI)
    cells = torch.gather(pooled.reshape(B, H * W, N_ORI), 1, flat)
    return cells.reshape(*pts.shape[:-1], N_ORI)


def _normalize(cells: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, K, 16, 8) cells -> (B, K, 128) SIFT-normalised bf16 (zero where invalid)."""
    desc = cells.reshape(*cells.shape[:2], N_CELLS * N_CELLS * N_ORI)
    desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp(min=1e-8)
    desc = torch.clamp(desc, 0.0, 0.2)
    desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp(min=1e-8)
    desc = torch.where(valid[..., None], desc, 0.0)
    return desc.to(torch.bfloat16)


def gather_gradhist_descriptors(pooled: torch.Tensor, kp: torch.Tensor,
                                valid: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 8) planes + (B, K, 2) kp -> (B, K, 128) L2-normed bf16."""
    pts = kp[:, :, None, :] + _cell_offsets(kp.device)             # (B, K, 16, 2)
    return _normalize(_gather_cells(pooled, pts), valid)


def gradhist_descriptors(gray: torch.Tensor, kp: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    return gather_gradhist_descriptors(dense_orientation_planes(gray), kp, valid)


def dominant_orientations(pooled: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 8) planes + (B, K, 2) kp -> (B, K) dominant angle: the circular mean
    of the local orientation histogram at the keypoint."""
    hist = _gather_cells(pooled, kp[:, :, None, :])[:, :, 0]       # (B, K, 8)
    centers = _bin_centers(pooled.device)
    c = torch.sum(hist * torch.cos(centers), dim=-1)
    s = torch.sum(hist * torch.sin(centers), dim=-1)
    return torch.atan2(s, c)


def gather_oriented_gradhist_descriptors(pooled: torch.Tensor, kp: torch.Tensor,
                                         valid: torch.Tensor) -> torch.Tensor:
    """Rotation-normalised gradhist from the (B, H, W, 8) planes."""
    theta = dominant_orientations(pooled, kp)                      # (B, K)
    offs = _cell_offsets(kp.device)                                # (16, 2)
    ct, st = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    # The grid turned by theta: [[c, -s], [s, c]] @ [ox, oy].
    offs_r = torch.stack([ct * offs[:, 0] - st * offs[:, 1],
                          st * offs[:, 0] + ct * offs[:, 1]], dim=-1)  # (B, K, 16, 2)
    cells = _gather_cells(pooled, kp[:, :, None, :] + offs_r)      # (B, K, 16, 8)

    # Bin o of the result interpolates input bins (o + lo) % 8 and (o + lo + 1) % 8
    # with weights 1 - frac and frac, where lo + frac = theta / bin width.
    shift = theta / (2 * math.pi / N_ORI)
    lo = torch.floor(shift)
    frac = (shift - lo)[..., None, None]                           # (B, K, 1, 1)
    idx0 = torch.remainder(torch.arange(N_ORI, device=kp.device) + lo.to(torch.int64)[..., None],
                           N_ORI)                                  # (B, K, 8)
    idx1 = torch.remainder(idx0 + 1, N_ORI)

    def take(idx):
        return torch.gather(cells, 3, idx[:, :, None, :].expand_as(cells))

    cells = (1.0 - frac) * take(idx0) + frac * take(idx1)
    return _normalize(cells, valid)


def oriented_gradhist_descriptors(gray: torch.Tensor, kp: torch.Tensor,
                                  valid: torch.Tensor) -> torch.Tensor:
    """Rotation-normalised gradhist: invariant to in-plane rotation."""
    return gather_oriented_gradhist_descriptors(dense_orientation_planes(gray), kp, valid)
