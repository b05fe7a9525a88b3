"""Stereo depth at keypoints: ZNCC block matching along the epipolar row of a rectified
pair, parabolic sub-pixel refinement, depth = fx * baseline / disparity.

Port of ``vo_tpu/features/stereo.py``. The JAX version scans ``max_disp`` disparities,
each forming dense box-summed planes of the Gaussian-blurred pair (the window sums of
``left * roll(right, d)``, and of each image and its square) and reading them at the
keypoints: the form a TPU wants, since it pays for gathers. Here each keypoint
gathers its 9 x 9 left window and its 9-row strip of the right image once, and every
window sum is formed from those, for all disparities at once: the same products,
summed in the same order (rows, then columns, one after another from 0), as the dense
planes hold at the keypoints, without a dense plane per disparity. The scan's
reduction (first maximum, its two neighbours, a NaN that is never the best) is then
read off the (D, K) score matrix.
"""

from __future__ import annotations

import torch

from vo_tpu_torch.device import resolve_device, to_device
from vo_tpu_torch.features.detect import _gather_hw
from vo_tpu_torch.ops.image import gaussian_blur


def _sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` one term after another from 0, as the JAX package's
    shift-and-add box sums do (``0 + x0 + x1 + ...`` in fp32)."""
    out = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        out = out + x.select(dim, i)
    return out


def _window_sums(lg, rg, xi, yi, max_disp, patch):
    """The window sums at each keypoint: of the left window and its square (B, K), of
    the right window and its square at each disparity (B, K, D), and of their product
    (B, K, D); the D axis runs over u = D - 1 - d."""
    W = lg.shape[2]
    r, D = patch // 2, max_disp
    rows = yi[..., None] + torch.arange(-r, r + 1, device=lg.device)         # (B, K, P)
    # Left windows (B, K, P, P) and right strips (B, K, P, D - 1 + P): strip column s
    # is image column xi - (D - 1) - r + s, wrapped as jnp.roll wraps.
    cols_l = xi[..., None] + torch.arange(-r, r + 1, device=lg.device)
    cols_r = (xi[..., None] - (D - 1) - r
              + torch.arange(D - 1 + patch, device=lg.device)) % W
    lwin = _gather_hw(lg, rows[..., :, None], cols_l[..., None, :])
    rstrip = _gather_hw(rg, rows[..., :, None], cols_r[..., None, :])
    # Window u of the strip (columns u .. u + P - 1) lies under the left window at
    # disparity d = D - 1 - u.
    rwin = rstrip.unfold(-1, patch, 1)                                      # (B, K, P, D, P)

    # Box sums: rows first, then columns, each in order. A column's sum over the rows
    # is the same in every window that holds it, so the strip's are summed once.
    bl = _sum_in_order(_sum_in_order(lwin, 2), 2)
    blsq = _sum_in_order(_sum_in_order(lwin * lwin, 2), 2)
    br = _sum_in_order(_sum_in_order(rstrip, 2).unfold(-1, patch, 1), -1)
    brsq = _sum_in_order(_sum_in_order(rstrip * rstrip, 2).unfold(-1, patch, 1), -1)
    cross = torch.zeros_like(rwin[:, :, 0])                                 # (B, K, D, P)
    for i in range(patch):
        cross = cross + lwin[:, :, i, None, :] * rwin[:, :, i]
    return bl, blsq, br, brsq, _sum_in_order(cross, -1)


def _scores(lg, rg, xi, yi, max_disp, patch):
    """ZNCC scores (B, K, D) of each keypoint's window against the right image shifted
    by d = 0 .. D-1, as the JAX scan forms them."""
    N = patch * patch
    bl, blsq, br, brsq, cross = _window_sums(lg, rg, xi, yi, max_disp, patch)
    lvar = torch.clamp(blsq - bl * bl / N, min=0.0)
    rvar = torch.clamp(brsq - br * br / N, min=0.0)
    lnorm = torch.sqrt(lvar + 1e-6)[..., None]
    s = (cross - bl[..., None] * br / N) / (lnorm * torch.sqrt(rvar + 1e-6))
    return s.flip(-1)


def _reduce_scan(S: torch.Tensor):
    """The JAX scan's final carry from its (..., D) scores: (best, bestd, s[bestd - 1],
    s[bestd + 1]). The scan keeps the first strict maximum; from the first NaN on its
    running maximum is NaN, so no later score replaces the best. Its neighbours are the
    scores it captured: -inf before d = 0, 0 after the last disparity (the endpoints
    fall back to the integer peak)."""
    D = S.shape[-1]
    after_nan = torch.cummax(torch.isnan(S).to(torch.int8), dim=-1).values.bool()
    bestd = torch.argmax(torch.where(after_nan, float("-inf"), S), dim=-1)
    best = torch.amax(S, dim=-1)
    sm = torch.gather(S, -1, (bestd - 1).clamp(min=0)[..., None])[..., 0]
    sm = torch.where(bestd > 0, sm, float("-inf"))
    sp = torch.gather(S, -1, (bestd + 1).clamp(max=D - 1)[..., None])[..., 0]
    sp = torch.where(bestd < D - 1, sp, 0.0)
    return best, bestd, sm, sp


def stereo_depth_at(left, right, kp, valid, K_mat, baseline: float, max_disp: int = 128,
                    patch: int = 9, min_zncc: float = 0.5,
                    device: str | torch.device | None = None):
    """-> (depth, ok): metric depth at each keypoint and its validity mask.

    left, right (H, W) rectified gray (or a batch (B, H, W)); kp (K, 2) [x, y] left
    keypoints (or (B, K, 2)); valid (K,) (or (B, K)); K_mat (3, 3). Arrays or tensors,
    moved to ``device`` (default cuda; raises if there is no GPU).
    """
    dev = resolve_device(device)
    left, right = to_device(left, dev, torch.float32), to_device(right, dev, torch.float32)
    kp, valid = to_device(kp, dev, torch.float32), to_device(valid, dev, torch.bool)
    K_mat = to_device(K_mat, dev, torch.float32)
    if left.ndim == 2:
        depth, ok = stereo_depth_at(left[None], right[None], kp[None], valid[None], K_mat,
                                    baseline, max_disp, patch, min_zncc, dev)
        return depth[0], ok[0]
    H, W = left.shape[1:]
    r = patch // 2
    lg = gaussian_blur(left, 1.0)
    rg = gaussian_blur(right, 1.0)
    xi = kp[..., 0].to(torch.int32).clamp(r + max_disp, W - 1 - r).long()
    yi = kp[..., 1].to(torch.int32).clamp(r, H - 1 - r).long()
    S = _scores(lg, rg, xi, yi, max_disp, patch)                            # (B, K, D)

    best, bestd, sm, sp = _reduce_scan(S)

    denom = sm - 2.0 * best + sp
    interior = (bestd > 0) & (bestd < max_disp - 1)
    delta = torch.where(interior & (torch.abs(denom) > 1e-6), 0.5 * (sm - sp) / denom, 0.0)
    disp = bestd.to(torch.float32) + torch.clamp(delta, -1.0, 1.0)

    depth = K_mat[0, 0] * baseline / torch.clamp(disp, min=0.5)
    ok = (valid & (best > min_zncc) & (bestd > 0)
          & (kp[..., 0] >= r + max_disp) & (kp[..., 0] < W - r)
          & (kp[..., 1] >= r) & (kp[..., 1] < H - r))
    return depth, ok
