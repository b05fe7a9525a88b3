"""R2D2 learned-feature extractor: batched CNN forward + NMS + fixed-budget top-k.
Port of ``vo_tpu/models/r2d2_extractor.py``.

ImageNet normalisation, a single-scale forward, 3x3 max-pool NMS on repeatability
with reliability/repeatability thresholds 0.7/0.7, and score = reliability *
repeatability with a 0.85 floor folded into the validity mask, batched over frames
with a fixed keypoint budget. The top-k is a stable descending sort, so equal scores
(and the many -inf of suppressed pixels) go to the lower flat index, as ``lax.top_k``
orders them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from vo_tpu_torch.device import resolve_device, to_device
from vo_tpu_torch.features.detect import _top_k
from vo_tpu_torch.features.extractor import Features
from vo_tpu_torch.models.patchnet import PatchNetSpec, apply_patchnet, params_to
from vo_tpu_torch.ops.image import maxpool2d_same

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images, dev: torch.device) -> torch.Tensor:
    """(B, H, W) gray or (B, H, W, 3) RGB in [0, 255] -> (B, Hp, Wp, 3) ImageNet-
    normalised fp32 on ``dev``, edge-padded to even Hp, Wp (the Fast variant's pool
    and upsample need them)."""
    x = to_device(images, dev)
    if x.ndim == 3:
        x = x[..., None].expand(*x.shape, 3)
    x = x.to(torch.float32) / 255.0
    mean = torch.tensor(_IMAGENET_MEAN, device=dev)
    std = torch.tensor(_IMAGENET_STD, device=dev)
    x = (x - mean) / std
    if x.shape[1] % 2:
        x = torch.cat([x, x[:, -1:]], dim=1)
    if x.shape[2] % 2:
        x = torch.cat([x, x[:, :, -1:]], dim=2)
    return x


@dataclass(frozen=True)
class R2D2Extractor:
    """Callable extractor: (B, H, W, 3) RGB or (B, H, W) gray -> Features with 128-d
    L2-normalised descriptors (stored as ``desc_dtype``); the same fields and
    defaults as the JAX one."""

    spec: PatchNetSpec
    params_id: int                      # identity of the parameters (equality, hash)
    max_kp: int = 2048
    rel_thr: float = 0.7
    rep_thr: float = 0.7
    score_thr: float = 0.85
    nms_size: int = 3
    border: int = 8
    desc_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"     # the conv trunk's dtype
    score_mode: str = "rel*rep"         # 'rel*rep' | 'rep' (rank by repeatability alone)

    _params_store: dict = field(default_factory=dict, hash=False, compare=False)

    @classmethod
    def from_pretrained(cls, name: str = "faster2d2_WASF_N16", max_kp: int = 2048,
                        **kw) -> "R2D2Extractor":
        """A published model by name (``port_weights.load_pretrained``: raises when
        the checkpoint is missing)."""
        from vo_tpu_torch.models import port_weights

        spec, params = port_weights.load_pretrained(name)
        return cls.from_params(spec, params, max_kp=max_kp, **kw)

    @classmethod
    def from_params(cls, spec: PatchNetSpec, params: dict, max_kp: int = 2048, **kw):
        ex = cls(spec=spec, params_id=id(params), max_kp=max_kp, **kw)
        ex._params_store["params"] = params
        return ex

    @property
    def params(self) -> dict:
        return self._params_store["params"]

    def __call__(self, images, device: str | torch.device | None = None) -> Features:
        """Runs on ``device``, default cuda (raises if there is no GPU)."""
        dev = resolve_device(device)
        B, H, W = images.shape[:3]
        store = self._params_store
        if str(dev) not in store:               # the parameters on dev, copied once
            store[str(dev)] = params_to(self.params, dev)
        out = apply_patchnet(store[str(dev)], self.spec, normalize_images(images, dev),
                             compute_dtype=self.compute_dtype)
        rel = out["reliability"][:, :H, :W]
        rep = out["repeatability"][:, :H, :W]

        keep = ((rep >= maxpool2d_same(rep, self.nms_size))
                & (rep >= self.rep_thr) & (rel >= self.rel_thr))
        col = torch.arange(W, device=dev)
        row = torch.arange(H, device=dev)[:, None]
        b = self.border
        keep &= (col >= b) & (col < W - b) & (row >= b) & (row < H - b)

        raw = rep if self.score_mode == "rep" else rel * rep
        score = torch.where(keep, raw, float("-inf"))
        top, idx = _top_k(score.reshape(B, H * W), self.max_kp)
        valid = torch.isfinite(top) & (top > self.score_thr)
        y, x_ = idx // W, idx % W
        kp = torch.stack([torch.where(valid, x_.to(torch.float32), 0.0),
                          torch.where(valid, y.to(torch.float32), 0.0)], dim=-1)
        desc = out["descriptors"]
        d = desc[torch.arange(B, device=dev)[:, None], y, x_]
        d = torch.where(valid[..., None], d, 0.0).to(getattr(torch, self.desc_dtype))
        return Features(kp=kp, desc=d, score=torch.where(valid, top, 0.0), valid=valid)

