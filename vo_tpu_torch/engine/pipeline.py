"""End-to-end offline VO: batched extraction + back-projection + the frame loop.

Port of the in-memory part of ``vo_tpu/engine/pipeline.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.engine.vo import VOConfig, VOEngine
from vo_tpu_torch.features.extractor import Features, OrbLikeExtractor
from vo_tpu_torch.features.pyramid import MultiScaleClassicExtractor
from vo_tpu_torch.geometry.camera import depth_to_3d_at

Extractor = OrbLikeExtractor | MultiScaleClassicExtractor


def _to_device(x, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def extract_and_backproject(extractor: Extractor, images, depths, K):
    """Batched features + per-frame keypoint 3D back-projection on ``images.device``,
    with either extractor (single-scale, or the multi-scale SIFT-config one).

    images (F, H, W) gray or (F, H, W, 3) RGB; depths (F, H, W) fp32 metres or uint16
    millimetres (dequantised to metres here, on the device).
    """
    if depths.dtype == torch.uint16:   # torch has few uint16 ops: widen via int16 bits
        depths = (depths.view(torch.int16).to(torch.int32) & 0xFFFF).to(torch.float32) * 1e-3
    feats = extractor(images, device=images.device)
    return feats, depth_to_3d_at(depths, feats.kp, K)


def run_offline_vo(
    images,
    depths,
    K,
    vo_config: VOConfig = VOConfig(),
    extractor: Extractor | None = None,
    extraction_batch: int = 0,
    return_features: bool = False,
    device: str | torch.device | None = None,
):
    """Full pipeline on in-memory arrays -> (poses (F, 4, 4) np, diagnostics np).

    ``extractor`` defaults to ``OrbLikeExtractor()``; ``MultiScaleClassicExtractor``
    with ``matcher="ratio_float"`` is the SIFT config.
    Also returns (feats, kp3d) when ``return_features``. ``extraction_batch`` > 0
    extracts in chunks of that many frames to bound peak memory. Runs on ``device``
    (default cuda; raises if there is no GPU).
    """
    dev = resolve_device(device)
    if extractor is None:
        extractor = OrbLikeExtractor()
    K = _to_device(np.asarray(K, np.float32), dev)
    images = _to_device(images, dev)
    depths = _to_device(depths, dev, torch.float32)

    n = images.shape[0]
    step = extraction_batch if extraction_batch and n > extraction_batch else n
    chunks = [extract_and_backproject(extractor, images[s:s + step], depths[s:s + step], K)
              for s in range(0, n, step)]
    feats = Features(*(torch.cat([c[0][i] for c in chunks]) for i in range(4)))
    kp3d = torch.cat([c[1] for c in chunks])

    engine = VOEngine(vo_config, device=dev)
    poses, diag = engine.run_sequence(feats.kp, feats.desc, feats.valid, kp3d, K)
    out = (poses.cpu().numpy(), type(diag)(*(d.cpu().numpy() for d in diag)))
    return out + ((feats, kp3d),) if return_features else out
