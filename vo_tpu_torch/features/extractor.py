"""Batched feature extraction: images in, fixed-budget (kp, desc, score, valid) out.

Port of ``vo_tpu/features/extractor.py``: Harris, Shi-Tomasi, DoG or box-filter
Hessian response, fixed-budget detection, then upright dense-packed BRIEF, oriented
BRIEF, upright gradhist or upright SURF-64 descriptors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.features.brief import oriented_brief_descriptors
from vo_tpu_torch.features.dense_brief import BRIEF_BITS, upright_brief_descriptors
from vo_tpu_torch.features.detect import (detect_keypoints, dog_response, harris_response,
                                          shi_tomasi_response)
from vo_tpu_torch.features.gradhist import gradhist_descriptors
from vo_tpu_torch.features.surf import hessian_response, surf_descriptors
from vo_tpu_torch.ops.image import rgb_to_gray

_RESPONSES = {"harris": harris_response, "dog": dog_response, "hessian": hessian_response}


def response_fn(name: str):
    """The detector response for ``name``: as in the JAX package, any name other than
    'harris', 'dog' and 'hessian' takes the Shi-Tomasi response."""
    return _RESPONSES.get(name, shi_tomasi_response)


class Features(NamedTuple):
    """Fixed-budget per-frame features. Leading axis = batch of frames."""

    kp: torch.Tensor     # (..., K, 2) fp32 [x, y]
    desc: torch.Tensor   # (..., K, D)
    score: torch.Tensor  # (..., K)
    valid: torch.Tensor  # (..., K) bool


@dataclass(frozen=True)
class OrbLikeExtractor:
    """Single-scale corner or blob extractor; the same fields and defaults as the JAX
    one. As there, ``oriented`` steers BRIEF only: gradhist and SURF are upright here
    (the oriented gradhist runs in ``MultiScaleClassicExtractor``)."""

    max_kp: int = 2048
    nms_size: int = 5
    rel_threshold: float = 1e-4
    border: int = 21  # >= brief patch radius + 1
    subpixel: bool = False
    bits: int = BRIEF_BITS
    response: str = "harris"   # 'harris' | 'dog' | 'hessian'; any other: Shi-Tomasi
    oriented: bool = False     # BRIEF only: rotation-steered patch BRIEF
    descriptor: str = "brief"  # 'brief' (+-1) | 'gradhist' | 'surf' (float, bf16)

    def __call__(self, images, device: str | torch.device | None = None) -> Features:
        """images: (B, H, W, 3) RGB or (B, H, W) gray, numpy or tensor.

        Runs on ``device`` (default ``cuda``; raises if there is no GPU).
        """
        dev = resolve_device(device)
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        images = images.to(dev)
        gray = rgb_to_gray(images) if images.ndim == 4 else images.to(torch.float32)
        kp, score, valid = detect_keypoints(
            response_fn(self.response)(gray), max_kp=self.max_kp, nms_size=self.nms_size,
            rel_threshold=self.rel_threshold, border=self.border,
            subpixel=self.subpixel,
        )
        if self.descriptor == "gradhist":
            desc = gradhist_descriptors(gray, kp, valid)
        elif self.descriptor == "surf":
            desc = surf_descriptors(gray, kp, valid)
        elif self.oriented:
            desc = oriented_brief_descriptors(gray, kp, valid, bits=self.bits)
        else:
            desc = upright_brief_descriptors(gray, kp, valid, bits=self.bits)
        return Features(kp=kp, desc=desc, score=score, valid=valid)
