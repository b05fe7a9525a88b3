"""Octave-pyramid front-end for the classic extractors: the SIFT-config path.

Port of ``vo_tpu/features/pyramid.py``: a static list of scales, per-level detection
with its own candidate budget, per-level descriptors (so their support follows the
scale), coordinates mapped to full resolution, and one global score top-k across
levels. Each level is resized from the original image in one pass.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.features.dense_brief import BRIEF_BITS, upright_brief_descriptors
from vo_tpu_torch.features.detect import _top_k, detect_keypoints
from vo_tpu_torch.features.extractor import Features, response_fn
from vo_tpu_torch.features.gradhist import gradhist_descriptors, oriented_gradhist_descriptors
from vo_tpu_torch.features.surf import surf_descriptors
from vo_tpu_torch.ops.image import resize_bilinear, rgb_to_gray


@dataclass(frozen=True)
class MultiScaleClassicExtractor:
    """Scale-covariant Harris / Shi-Tomasi / DoG / Hessian + BRIEF / gradhist / SURF
    extraction; the same fields and defaults as the JAX one, and the same ``Features``
    as ``OrbLikeExtractor``."""

    max_kp: int = 2048
    n_scales: int = 4
    scale_f: float = 2 ** 0.5
    response: str = "harris"      # 'harris' | 'dog' | 'hessian'; any other: Shi-Tomasi
    descriptor: str = "brief"     # 'brief' | 'gradhist' | 'surf'
    oriented: bool = False        # gradhist only: dominant-orientation normalisation
    nms_size: int = 5
    rel_threshold: float = 1e-4
    border: int = 21
    bits: int = BRIEF_BITS
    subpixel: bool = False
    # Per-level candidate budget = max_kp * level_budget_decay**level (floor 128).
    level_budget_decay: float = 1.0

    def __call__(self, images, device: str | torch.device | None = None) -> Features:
        """images: (B, H, W, 3) RGB or (B, H, W) gray, numpy or tensor.

        Runs on ``device`` (default ``cuda``; raises if there is no GPU).
        """
        dev = resolve_device(device)
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        images = images.to(dev)
        gray = rgb_to_gray(images) if images.ndim == 4 else images.to(torch.float32)
        H, W = gray.shape[1:]

        kps, descs, scores, valids = [], [], [], []
        for lvl in range(self.n_scales):
            s = self.scale_f ** (-lvl)
            Hs, Ws = max(int(round(H * s)), 32), max(int(round(W * s)), 32)
            if max(Hs, Ws) <= 2 * self.border + 4:
                break
            g = gray if lvl == 0 else resize_bilinear(gray, (Hs, Ws))
            lvl_kp = max(int(self.max_kp * self.level_budget_decay ** lvl), 128)
            kp, score, valid = detect_keypoints(
                response_fn(self.response)(g), max_kp=lvl_kp, nms_size=self.nms_size,
                rel_threshold=self.rel_threshold, border=self.border,
                subpixel=self.subpixel)
            descs.append(self._describe(g, kp, valid))
            # Level coordinates to full resolution.
            to_full = torch.tensor([(W - 1) / max(Ws - 1, 1), (H - 1) / max(Hs - 1, 1)],
                                   dtype=kp.dtype, device=dev)
            kps.append(kp * to_full)
            scores.append(torch.where(valid, score, float("-inf")))
            valids.append(valid)

        kp = torch.cat(kps, dim=1)
        desc = torch.cat(descs, dim=1)
        score = torch.cat(scores, dim=1)
        valid = torch.cat(valids, dim=1)

        # Global budget: the best max_kp across all levels by detector response.
        top, idx = _top_k(score, min(self.max_kp, score.shape[1]))
        if top.shape[1] < self.max_kp:   # tiny budgets/level counts: pad back up
            pad = self.max_kp - top.shape[1]
            top = F.pad(top, (0, pad), value=float("-inf"))
            idx = F.pad(idx, (0, pad))
        finite = torch.isfinite(top)
        return Features(
            kp=torch.gather(kp, 1, idx[..., None].expand(-1, -1, 2)),
            desc=torch.gather(desc, 1, idx[..., None].expand(-1, -1, desc.shape[-1])),
            score=torch.where(finite, top, 0.0),
            valid=torch.gather(valid, 1, idx) & finite,
        )

    def _describe(self, g, kp, valid):
        if self.descriptor == "gradhist":
            fn = oriented_gradhist_descriptors if self.oriented else gradhist_descriptors
            return fn(g, kp, valid)
        if self.descriptor == "surf":
            return surf_descriptors(g, kp, valid)
        return upright_brief_descriptors(g, kp, valid, bits=self.bits)
