"""Multiscale R2D2 extraction: a fixed image pyramid, per-scale NMS, one global top-k.
Port of ``vo_tpu/models/multiscale.py``.

Scales walk down from 1.0 by ``scale_f`` (default 2^0.25) while ``max(min_scale,
min_size/max(H,W)) <= s <= min(max_scale, max_size/max(H,W))``. Each level is resized
from the original image, keeps its own ``k = min(per_scale_k, nh*nw)`` candidates, and
maps its keypoints back to full-resolution pixels with the patch-size column ``32/s``;
one top-k over all levels selects the result. Batched over frames, with fixed budgets
and validity masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.features.detect import _top_k
from vo_tpu_torch.models.patchnet import PatchNetSpec, apply_patchnet, params_to
from vo_tpu_torch.models.r2d2_extractor import normalize_images
from vo_tpu_torch.ops.image import maxpool2d_same, resize_bilinear
from vo_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class MultiscaleConfig:
    """Pyramid geometry + NMS thresholds (the reference extract.py's defaults)."""

    scale_f: float = 2 ** 0.25
    min_scale: float = 0.0
    max_scale: float = 1.0
    min_size: int = 256
    max_size: int = 1024
    top_k: int = 2048           # global budget across scales
    per_scale_k: int = 2048     # candidate budget at each level
    rel_thr: float = 0.7
    rep_thr: float = 0.7
    nms_size: int = 3
    border: int = 4


class MultiscaleFeatures(NamedTuple):
    kp: torch.Tensor      # (B, K, 3) [x, y, 32/s] in full-res pixels
    desc: torch.Tensor    # (B, K, D) L2-normalised fp32
    score: torch.Tensor   # (B, K) reliability * repeatability
    valid: torch.Tensor   # (B, K) bool


def pyramid_scales(H: int, W: int, cfg: MultiscaleConfig) -> list[float]:
    """The scale factors the reference's loop visits: s from 1.0 stepping /= scale_f,
    kept while within the [min, max] scale/size window."""
    scales = []
    s = 1.0
    lo = max(cfg.min_scale, cfg.min_size / max(H, W))
    hi = min(cfg.max_scale, cfg.max_size / max(H, W))
    while s + 0.001 >= lo:
        if s - 0.001 <= hi:
            scales.append(s)
        s /= cfg.scale_f
    return scales


def _level_hw(H: int, W: int, s: float) -> tuple[int, int]:
    # even-rounded so the Fast variant's pool2+upsample2 path needs no padding
    nh, nw = max(round(H * s), 2), max(round(W * s), 2)
    return nh + nh % 2, nw + nw % 2


def _extract_pyramid(params, images, spec: PatchNetSpec, cfg: MultiscaleConfig,
                     H: int, W: int) -> MultiscaleFeatures:
    """images: (B, Hp, Wp, 3) ImageNet-normalised, (H, W) before the even padding."""
    B, dev = images.shape[0], images.device
    bidx = torch.arange(B, device=dev)[:, None]
    all_kp, all_desc, all_score, all_valid = [], [], [], []
    with span("r2d2.extract", rows=B):
        for s in pyramid_scales(H, W, cfg):
            nh, nw = _level_hw(H, W, s)
            with span("r2d2.level", scale=s, h=nh, w=nw):
                with span("r2d2.network", device=True):
                    out = apply_patchnet(params, spec, resize_bilinear(images, (nh, nw)))
                    rel, rep = out["reliability"], out["repeatability"]
                with span("r2d2.select", device=True):
                    keep = ((rep >= maxpool2d_same(rep, cfg.nms_size))
                            & (rep >= cfg.rep_thr) & (rel >= cfg.rel_thr))
                    col = torch.arange(nw, device=dev)
                    row = torch.arange(nh, device=dev)[:, None]
                    b = cfg.border
                    keep &= (col >= b) & (col < nw - b) & (row >= b) & (row < nh - b)

                    score = torch.where(keep, rel * rep, float("-inf"))
                    top, idx = _top_k(score.reshape(B, nh * nw),
                                      min(cfg.per_scale_k, nh * nw))
                    y, x = idx // nw, idx % nw
                    valid = torch.isfinite(top)
                    yf, xf = y.to(torch.float32), x.to(torch.float32)
                    all_kp.append(torch.stack([xf * (W / nw), yf * (H / nh),
                                               torch.full_like(xf, 32.0 / s)], dim=-1))
                    all_desc.append(torch.where(valid[..., None],
                                                out["descriptors"][bidx, y, x], 0.0))
                    all_score.append(top)
                    all_valid.append(valid)

        with span("r2d2.merge", device=True):
            kp, desc = torch.cat(all_kp, dim=1), torch.cat(all_desc, dim=1)
            score, valid = torch.cat(all_score, dim=1), torch.cat(all_valid, dim=1)
            top, idx = _top_k(score, min(cfg.top_k, score.shape[1]))
            fin = torch.isfinite(top)
            return MultiscaleFeatures(kp=kp[bidx, idx], desc=desc[bidx, idx],
                                      score=torch.where(fin, top, 0.0),
                                      valid=valid[bidx, idx] & fin)


def extract_multiscale(params, spec: PatchNetSpec, images,
                       cfg: MultiscaleConfig = MultiscaleConfig(),
                       device: str | torch.device | None = None) -> MultiscaleFeatures:
    """Multiscale R2D2 features for a batch of frames.

    Args:
      params: patchnet parameters (``load_pretrained``, ``init_patchnet_params``).
      images: (B, H, W, 3) or (B, H, W) uint8/float RGB in [0, 255], numpy or tensor.
      device: where it runs (default cuda; raises if there is no GPU).
    """
    dev = resolve_device(device)
    H, W = images.shape[1:3]
    return _extract_pyramid(params_to(params, dev), normalize_images(images, dev), spec,
                            cfg, H, W)


def save_r2d2_npz(path: str, feats: MultiscaleFeatures, imsize: tuple[int, int],
                  frame: int = 0) -> str:
    """Write one frame's features in the reference's ``.r2d2`` npz layout: imsize
    (W, H), keypoints (N, 3), descriptors, scores, in ascending score order, invalid
    slots dropped."""
    v = feats.valid[frame].cpu().numpy()
    sc = feats.score[frame].cpu().numpy()[v]
    order = np.argsort(sc)
    with open(path, "wb") as f:
        np.savez(f, imsize=np.asarray(imsize),
                 keypoints=feats.kp[frame].cpu().numpy()[v][order],
                 descriptors=feats.desc[frame].to(torch.float32).cpu().numpy()[v][order],
                 scores=sc[order])
    return path
