"""Road segmentation for the parking layer. Port of ``vo_tpu/utils/seg.py``.

A small first-party FCN (a 3-level encoder-decoder: stride-2 convolutions down,
bilinear 2x upsampling, skip additions) that gives ``auto_park_vision`` its road mask,
a zero-weight heuristic mask when there are no weights, and one supervised training
step. Parameters are a dict of {"w" (OIHW), "b"} per layer; ``init_segnet_params``
draws them from a ``prng`` key (the JAX package's weights for the same key), and
``port_state.segnet_params_from_jax`` carries the JAX package's across.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from vo_tpu_torch import prng
from vo_tpu_torch.device import device_for, to_device
from vo_tpu_torch.ops.image import resize_bilinear


class SegNetSpec(NamedTuple):
    """3-level encoder-decoder FCN; ~120k parameters at width 32, sized for a 2-class
    road / not-road task."""

    width: int = 32
    n_classes: int = 2


_LAYERS = ("stem", "down1", "down2", "mid", "up1", "up2", "head")


def _shapes(spec: SegNetSpec) -> dict:
    w = spec.width
    return {"stem": (3, w, 3), "down1": (w, 2 * w, 3), "down2": (2 * w, 4 * w, 3),
            "mid": (4 * w, 4 * w, 3), "up1": (4 * w, 2 * w, 3), "up2": (2 * w, w, 3),
            "head": (w, spec.n_classes, 1)}


def init_segnet_params(key: torch.Tensor, spec: SegNetSpec = SegNetSpec()) -> dict:
    """He-initialised weights N(0, 2 / fan_in) and zero biases, drawn from the ``prng``
    key ``key`` on its device as the JAX package draws them from the same key: the key
    split 7 ways in ``_LAYERS`` order, one ``normal`` per layer in HWIO, transposed to
    OIHW."""
    params = {}
    for k, name in zip(prng.split(key, len(_LAYERS)), _LAYERS):
        cin, cout, ks = _shapes(spec)[name]
        w = prng.normal(k, (ks, ks, cin, cout)) * (2.0 / (ks * ks * cin)) ** 0.5
        params[name] = {"w": w.permute(3, 2, 0, 1).contiguous(),
                        "b": torch.zeros(cout, device=key.device)}
    return params


def _conv(p: dict, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated`` with "SAME" padding on NCHW: for stride 2 (even
    sizes) the one padding row and column go after the image."""
    k = p["w"].shape[-1]
    if stride == 2:
        x = F.pad(x, (0, 1, 0, 1))
        out = F.conv2d(x, p["w"], stride=2)
    else:
        out = F.conv2d(x, p["w"], padding=(k - 1) // 2)
    return out + p["b"][:, None, None]


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling of NCHW (``jax.image.resize``'s half-pixel centres)."""
    B, C, H, W = x.shape
    return resize_bilinear(x.reshape(B * C, H, W), (2 * H, 2 * W)).reshape(B, C, 2 * H, 2 * W)


def apply_segnet(params: dict, images, spec: SegNetSpec = SegNetSpec(),
                 device: str | torch.device | None = None) -> torch.Tensor:
    """(B, H, W, 3) uint8/float RGB in [0, 255] -> (B, H, W, n_classes) logits on
    ``device`` (default: where the images lie, else cuda). H and W must be multiples
    of 4 (two stride-2 levels)."""
    dev = device_for(images, device)
    x = to_device(images, dev, torch.float32).permute(0, 3, 1, 2) / 127.5 - 1.0
    e0 = torch.relu(_conv(params["stem"], x))
    e1 = torch.relu(_conv(params["down1"], e0, stride=2))
    e2 = torch.relu(_conv(params["down2"], e1, stride=2))
    m = torch.relu(_conv(params["mid"], e2)) + e2
    u1 = torch.relu(_conv(params["up1"], _upsample2(m))) + e1
    u2 = torch.relu(_conv(params["up2"], _upsample2(u1))) + e0
    return _conv(params["head"], u2).permute(0, 2, 3, 1)


def auto_park_vision(image, params: dict | None = None, spec: SegNetSpec = SegNetSpec(),
                     road_class: int = 1, device: str | torch.device | None = None
                     ) -> torch.Tensor:
    """(H, W, 3) RGB -> (H, W) bool road mask (the class argmax's road channel). With
    ``params=None`` it falls back to ``heuristic_road_mask``."""
    if params is None:
        return heuristic_road_mask(image, device=device)
    logits = apply_segnet(params, to_device(image, device_for(image, device))[None], spec)[0]
    return torch.argmax(logits, dim=-1) == road_class


def heuristic_road_mask(image, luma_lo: float = 60.0, luma_hi: float = 180.0,
                        sat_max: float = 40.0,
                        device: str | torch.device | None = None) -> torch.Tensor:
    """Zero-parameter road proposal: road surfaces are mid-luminance, low-saturation
    regions."""
    img = to_device(image, device_for(image, device), torch.float32)
    if img.ndim == 2:
        luma, sat = img, torch.zeros_like(img)
    else:
        luma = img.mean(dim=-1)
        sat = img.amax(dim=-1) - img.amin(dim=-1)
    return (luma >= luma_lo) & (luma <= luma_hi) & (sat <= sat_max)


def seg_train_step(params: dict, images, labels, optimizer: torch.optim.Optimizer,
                   spec: SegNetSpec = SegNetSpec()):
    """One supervised step (softmax cross-entropy over every pixel) -> (params, loss).

    ``params``' tensors are the leaves ``optimizer`` (any ``torch.optim`` optimizer)
    was built over, and they require grad; the optimizer keeps its own state, where
    the JAX package's step takes and returns an optax state.
    """
    optimizer.zero_grad()
    logits = apply_segnet(params, images, spec)
    labels = to_device(labels, logits.device, torch.int64)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    loss.backward()
    optimizer.step()
    return params, loss.detach()
