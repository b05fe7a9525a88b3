"""D2-Net (Dusmanu et al., "D2-Net: A Trainable CNN for Joint Description and
Detection of Local Features", CVPR 2019): the describe-and-detect VGG16 extractor,
single- or multiscale, batched over frames with fixed budgets.

The network (mihaidusmanu/d2-net ``lib/model_test.py::DenseFeatureExtractionModule``)
is VGG16 up to conv4_3: ten 3 x 3 convolutions with biases and ReLUs, two 2 x 2
max-pools at stride 2, a 2 x 2 average pool at stride 1, and conv4_1-4_3 at dilation
2, padding 2 (``D2NET_VGG16_CONV4_3``); conv4_3's ReLU is ``use_relu``. No BatchNorm,
no head: the 512-channel map at about 1/4 resolution is both the detector and the
descriptor. Its input is the caffe-preprocessed image (RGB -> BGR, minus the mean
pixel, no scaling). The convolutions go through ``patchnet.conv_bias``, the step R2D2's
trunk runs, each inside a ``d2net.conv`` device span while the recorder is on.

``extract_d2net`` follows ``lib/pyramid.py::process_multiscale`` per frame, with the
upstream's ``extract_features.py`` resize (``max_edge``, ``max_sum_edges``) before it.
The levels are visited in the order of ``scales`` (coarse to fine), each dependent on
the ones before:

- fuse: the level's map (the image resized by ``F.interpolate(bilinear,
  align_corners=True)``) plus the previous level's fused map upsampled the same way;
  the banned mask, nearest-upsampled from the coarser levels;
- detect (``HardDetectionModule``): a cell (c, i, j) is a keypoint when c is the
  channel maximum at (i, j), (c, i, j) is a 3 x 3 spatial maximum of channel c, and the
  edge test ``tr^2 / det <= (t + 1)^2 / t`` with ``det > 0`` holds for the depthwise
  second differences dii, djj, dij; unless a coarser level already detected at that
  pixel. The level keeps its ``level_k`` best by score (the fused value over the level
  index + 1), then the localization (``HandcraftedLocalizationModule``: one Newton
  step -H^-1 grad of central differences) drops a keypoint whose offset reaches 0.5,
  and the corner rule (``interpolate_dense_features``) one whose four neighbouring
  cells are not all inside the map;
- describe: all 512 channels sampled bilinearly at the refined position, then
  L2-normalised;
- positions: the refined cell p mapped back to the image as 4 p + 1.5
  (``upscale_positions``, two steps), times the level's size ratio; the third column
  1/scale.

The arithmetic is the upstream's, in fp32 (TF32 off, ``device.py``), evaluated at the
channel maximum of each pixel and, for the localization and the sampling, at the
selected cells only; each second difference is the sum its filter defines, in the
order of its taps. Departures, each recorded here:

- a fixed budget per level (``level_k``, None: every cell of the level, which drops
  nothing) replaces ``torch.nonzero``; the dropped count is a counter;
- at most one keypoint per pixel: where two channels tie at a pixel's maximum (the
  upstream keeps each), the one ``torch.max`` returns is tested; ties at zero are never
  keypoints (a flat patch has det = 0);
- the ``extract_features.py`` resize (not needed below 1600 pixels a side and 2800
  both sides together, as at 376 x 1232) is an antialiased bilinear resize of the
  float image to the upstream's truncated size, not ``scipy.misc.imresize``.

Counters (``COUNTERS``, per level, summed over frames: detections found, dropped by the
banned mask, by the budget, by the offset test, by the corner rule, and kept) and
``peak`` (the most candidates one frame offered the budget) stay on the device: a
``stats`` dict given to ``extract_d2net`` accumulates them without a host sync, and
``read_counts`` reads them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vo_tpu_torch.device import resolve_device, to_device
from vo_tpu_torch.features.detect import _top_k
from vo_tpu_torch.models.patchnet import conv_bias
from vo_tpu_torch.utils.profiling import span

CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)
COUNTERS = ("found", "banned", "budget", "offset", "corner", "kept")


@dataclass(frozen=True)
class Conv:
    """A 3 x 3 convolution with a bias, stride 1, padding ``dilation``; then a ReLU."""

    cin: int
    cout: int
    k: int = 3
    dilation: int = 1
    relu: bool = True

    @property
    def pad(self) -> int:
        return self.dilation * (self.k - 1) // 2


@dataclass(frozen=True)
class Pool:
    """``kind`` "max" or "avg", a ``k`` x ``k`` window at ``stride``, no padding."""

    kind: str
    k: int = 2
    stride: int = 2


D2NET_VGG16_CONV4_3 = (
    Conv(3, 64), Conv(64, 64), Pool("max"),
    Conv(64, 128), Conv(128, 128), Pool("max"),
    Conv(128, 256), Conv(256, 256), Conv(256, 256), Pool("avg", 2, 1),
    Conv(256, 512, dilation=2), Conv(512, 512, dilation=2),
    Conv(512, 512, dilation=2, relu=False),       # conv4_3: its ReLU is ``use_relu``
)


@dataclass(frozen=True)
class D2NetConfig:
    """``extract_features.py --multiscale`` as published: scales visited in this
    order, the detector's edge threshold, the input resize limits, conv4_3's ReLU;
    ``level_k``: candidates kept per level (None: every cell of the level)."""

    scales: tuple = (0.5, 1.0, 2.0)
    edge_threshold: float = 5.0
    max_edge: int = 1600
    max_sum_edges: int = 2800
    use_relu: bool = True
    level_k: tuple | None = None


class D2NetFeatures(NamedTuple):
    kp: torch.Tensor      # (B, K, 3) [x, y, 1/scale] in image pixels
    desc: torch.Tensor    # (B, K, 512) L2-normalised fp32
    score: torch.Tensor   # (B, K) fused map value / (level index + 1)
    valid: torch.Tensor   # (B, K) bool
    cell: torch.Tensor    # (B, K, 4) int32 [level, channel, i, j] in the level's map


def apply_d2net(params: dict, images: torch.Tensor, use_relu: bool = True,
                compute_dtype=torch.float32) -> torch.Tensor:
    """The dense feature map of (B, 3, H, W) caffe-preprocessed fp32 images: (B, 512,
    h, w) fp32, h = H // 4 - 1 and w = W // 4 - 1. ``params``: {"convs": [{"w" OIHW,
    "b"}, ...]} in the order of ``D2NET_VGG16_CONV4_3``'s convolutions; the trunk runs
    in ``compute_dtype``."""
    dt = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
    x = images.to(dt)
    convs = iter(params["convs"])
    n = 0
    for step in D2NET_VGG16_CONV4_3:
        if isinstance(step, Pool):
            pool = F.max_pool2d if step.kind == "max" else F.avg_pool2d
            x = pool(x, step.k, step.stride)
            continue
        layer = next(convs)
        x = conv_bias(x, layer["w"], layer["b"], step.pad, step.dilation, dt, "d2net.conv", n)
        n += 1
        if step.relu:
            x = torch.relu(x)
    if use_relu:
        x = torch.relu(x)
    return x.to(torch.float32)


def preprocess_caffe(images, device) -> torch.Tensor:
    """(B, H, W, 3) RGB or (B, H, W) gray in [0, 255] -> (B, 3, H, W) fp32 BGR minus
    the mean pixel, computed as the upstream does: fp32 pixels, the subtraction in
    fp64, then fp32."""
    x = to_device(images, device).to(torch.float32)
    if x.ndim == 3:
        x = x[..., None].expand(*x.shape, 3)
    x = x.flip(-1).to(torch.float64)
    return torch.stack([(x[..., c] - m).to(torch.float32)
                        for c, m in enumerate(CAFFE_MEAN_BGR)], dim=1)


def input_size(H: int, W: int, cfg: D2NetConfig) -> tuple[int, int]:
    """The size ``extract_features.py`` resizes an H x W image to: scaled down to
    ``max_edge`` on its longer side (the channel axis, 3, counts as a side there),
    then to ``max_sum_edges`` for both sides together; each step truncates."""
    h, w = H, W
    if max(h, w, 3) > cfg.max_edge:
        f = cfg.max_edge / max(h, w, 3)
        h, w = int(h * f), int(w * f)
    if h + w > cfg.max_sum_edges:
        f = cfg.max_sum_edges / (h + w)
        h, w = int(h * f), int(w * f)
    return h, w


def params_to(params: dict, device) -> dict:
    return {"convs": [{k: v.to(device) for k, v in layer.items()}
                      for layer in params["convs"]]}


def fuse(feat: torch.Tensor, prev: torch.Tensor | None,
         banned: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The level's map plus the previous level's fused map, bilinearly upsampled with
    aligned corners (in place), and the banned mask (B, 1, h', w') nearest-upsampled
    to the map's size."""
    h, w = feat.shape[2:]
    if prev is not None:
        feat += F.interpolate(prev, size=[h, w], mode="bilinear", align_corners=True)
    if banned is not None:
        banned = F.interpolate(banned.float(), size=[h, w]).bool()
    return feat, banned


class Detections(NamedTuple):
    """A level's selected cells, ``k`` a frame, best score first."""

    score: torch.Tensor       # (B, k), -inf where no candidate
    channel: torch.Tensor     # (B, k) int64
    i: torch.Tensor           # (B, k) int64 cell row
    j: torch.Tensor           # (B, k) int64 cell column
    fi: torch.Tensor          # (B, k) refined row
    fj: torch.Tensor          # (B, k) refined column
    valid: torch.Tensor       # (B, k) bool
    banned: torch.Tensor      # (B, 1, h, w) bool: this and every coarser level's pixels
    counts: torch.Tensor      # (len(COUNTERS),) int64
    peak: torch.Tensor        # () int64: the most candidates of one frame


def _neighbours(feat: torch.Tensor, channel: torch.Tensor) -> dict:
    """The 3 x 3 neighbourhood of ``channel`` (B, h, w) at every pixel: {(di, dj):
    (value, inside)}, the value gathered at the clamped cell."""
    B, C, h, w = feat.shape
    dev = feat.device
    flat = feat.reshape(B, C * h * w)
    base = channel * (h * w)
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    out = {}
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            r, c = rows + di, cols + dj
            inside = (r >= 0) & (r < h) & (c >= 0) & (c < w)
            idx = base + (r.clamp(0, h - 1) * w + c.clamp(0, w - 1))
            out[di, dj] = (flat.gather(1, idx.reshape(B, h * w)).reshape(B, h, w), inside)
    return out


def detect(feat: torch.Tensor, banned: torch.Tensor | None, level: int, k: int,
           edge_threshold: float) -> Detections:
    """``HardDetectionModule``, the banned mask, the budget, the localization and the
    corner rule on a level's fused map (B, C, h, w); see the module's docstring."""
    B, _, h, w = feat.shape
    m, channel = feat.max(dim=1)
    nb = _neighbours(feat, channel)
    zero = {d: torch.where(inside, v, 0.0) for d, (v, inside) in nb.items()}
    local = torch.stack([torch.where(inside, v, float("-inf")) for v, inside in nb.values()])
    is_local_max = m == local.amax(dim=0)
    up, down, left, right = zero[-1, 0], zero[1, 0], zero[0, -1], zero[0, 1]
    dii = (up - 2 * m) + down
    djj = (left - 2 * m) + right
    dij = ((0.25 * zero[-1, -1] - 0.25 * zero[-1, 1]) - 0.25 * zero[1, -1]) + 0.25 * zero[1, 1]
    det = dii * djj - dij * dij
    tr = dii + djj
    threshold = (edge_threshold + 1) ** 2 / edge_threshold
    found = is_local_max & (tr * tr / det <= threshold) & (det > 0)
    if banned is None:
        keep, banned = found, found[:, None]
    else:
        keep = found & ~banned[:, 0]
        banned = banned | found[:, None]

    score = torch.where(keep, m / (level + 1), float("-inf"))
    top, sel = _top_k(score.reshape(B, h * w), k)
    at = lambda x: x.reshape(B, h * w).gather(1, sel)
    live = torch.isfinite(top)
    det_k = at(det)
    inv00, inv01, inv11 = at(djj) / det_k, -at(dij) / det_k, at(dii) / det_k
    di, dj = 0.5 * at(down) - 0.5 * at(up), 0.5 * at(right) - 0.5 * at(left)
    step_i = -(inv00 * di + inv01 * dj)
    step_j = -(inv01 * di + inv11 * dj)
    offset_ok = (step_i.abs() < 0.5) & (step_j.abs() < 0.5)
    i, j = sel // w, sel % w
    fi, fj = i.to(torch.float32) + step_i, j.to(torch.float32) + step_j
    corner_ok = ((torch.floor(fi) >= 0) & (torch.floor(fj) >= 0)
                 & (torch.ceil(fi) < h) & (torch.ceil(fj) < w))
    valid = live & offset_ok & corner_ok

    offered = keep.reshape(B, -1).sum(dim=1)
    counts = torch.stack([found.sum(), (found & ~keep).sum(), (offered - k).clamp(min=0).sum(),
                          (live & ~offset_ok).sum(), (live & offset_ok & ~corner_ok).sum(),
                          valid.sum()])
    return Detections(score=top, channel=at(channel), i=i, j=j, fi=fi, fj=fj, valid=valid,
                      banned=banned, counts=counts, peak=offered.max())


def describe(feat: torch.Tensor, d: Detections) -> torch.Tensor:
    """All channels of ``feat`` (B, C, h, w) sampled bilinearly at the refined cells,
    with ``interpolate_dense_features``'s weights and order, then L2-normalised:
    (B, k, C); zero in invalid slots."""
    B, C, h, w = feat.shape
    flat = feat.reshape(B, C, h * w)
    fi = torch.where(d.valid, d.fi, 0.0)
    fj = torch.where(d.valid, d.fj, 0.0)
    i0, j0 = torch.floor(fi), torch.floor(fj)
    i1, j1 = torch.ceil(fi).long(), torch.ceil(fj).long()
    di, dj = (fi - i0)[:, None], (fj - j0)[:, None]
    i0, j0 = i0.long(), j0.long()
    corner = lambda i, j: flat.gather(2, (i * w + j)[:, None, :].expand(B, C, -1))
    raw = ((1 - di) * (1 - dj) * corner(i0, j0) + (1 - di) * dj * corner(i0, j1)
           + di * (1 - dj) * corner(i1, j0) + di * dj * corner(i1, j1))
    desc = F.normalize(raw, dim=1).transpose(1, 2)
    return torch.where(d.valid[..., None], desc, 0.0)


def _level(params: dict, x: torch.Tensor, cfg: D2NetConfig, idx: int, prev, banned,
           H: int, W: int):
    """One level of the pyramid: (fused map, Detections, D2NetFeatures of the level)."""
    B = x.shape[0]
    s = cfg.scales[idx]
    img = F.interpolate(x, scale_factor=s, mode="bilinear", align_corners=True)
    h_level, w_level = img.shape[2:]
    with span("d2net.level", scale=s, h=h_level, w=w_level):
        with span("d2net.network", device=True):
            feat = apply_d2net(params, img, use_relu=cfg.use_relu)
        del img
        h, w = feat.shape[2:]
        k = h * w if cfg.level_k is None else min(cfg.level_k[idx], h * w)
        with span("d2net.fuse", device=True):
            feat, banned = fuse(feat, prev, banned)
        with span("d2net.detect", device=True):
            d = detect(feat, banned, idx, k, cfg.edge_threshold)
        with span("d2net.describe", device=True):
            desc = describe(feat, d)
            y, xx = d.fi, d.fj
            for _ in range(2):                          # upscale_positions
                y, xx = y * 2 + 0.5, xx * 2 + 0.5
            y, xx = y * (H / h_level), xx * (W / w_level)
            kp = torch.stack([xx, y, torch.ones_like(y) * 1 / s], dim=-1)
            cell = torch.stack([torch.full_like(d.i, idx), d.channel, d.i, d.j], dim=-1)
            v = d.valid
            feats = D2NetFeatures(kp=torch.where(v[..., None], kp, 0.0), desc=desc,
                                  score=torch.where(v, d.score, 0.0), valid=v,
                                  cell=torch.where(v[..., None], cell, -1).to(torch.int32))
    return feat, d, feats


def extract_d2net(params: dict, images, cfg: D2NetConfig = D2NetConfig(),
                  device: str | torch.device | None = None,
                  stats: dict | None = None) -> D2NetFeatures:
    """D2-Net features of a batch of frames, ``process_multiscale`` per frame.

    Args:
      params: D2-Net parameters (``load_d2net_checkpoint``), on any device.
      images: (B, H, W, 3) RGB or (B, H, W) gray in [0, 255], uint8 or float, numpy or
        tensor.
      device: where it runs (default cuda; raises if there is no GPU).
      stats: a dict the call adds its counters to, on the device (``read_counts``).
    Returns:
      D2NetFeatures with K = the sum of the levels' budgets; the levels in the order
      of ``cfg.scales``, each a block of its budget's slots, best score first.
    """
    dev = resolve_device(device)
    B, H, W = images.shape[:3]
    params = params_to(params, dev)
    x = preprocess_caffe(images, dev)
    h, w = input_size(H, W, cfg)
    if (h, w) != (H, W):
        x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                          antialias=True)
    levels, counts, peaks = [], [], []
    prev = banned = None
    with span("d2net.extract", rows=B):
        for idx in range(len(cfg.scales)):
            prev, d, feats = _level(params, x, cfg, idx, prev, banned, h, w)
            banned = d.banned
            levels.append(feats)
            counts.append(d.counts)
            peaks.append(d.peak)
        del prev, banned
        with span("d2net.merge", device=True):
            out = D2NetFeatures(*(torch.cat(parts, dim=1) for parts in zip(*levels)))
            if (h, w) != (H, W):
                kp = out.kp
                out = out._replace(kp=torch.stack([kp[..., 0] * (W / w), kp[..., 1] * (H / h),
                                                   kp[..., 2]], dim=-1))
    if stats is not None:
        counts, peaks = torch.stack(counts), torch.stack(peaks)
        stats["d2net.counts"] = stats["d2net.counts"] + counts if "d2net.counts" in stats else counts
        stats["d2net.peak"] = (torch.maximum(stats["d2net.peak"], peaks)
                               if "d2net.peak" in stats else peaks)
    return out


def read_counts(stats: dict) -> dict:
    """The counters a ``stats`` dict gathered, per level: {name: [level 0, ...]} for
    each of ``COUNTERS`` and ``peak`` ({} if it gathered none). Reads the device."""
    if "d2net.counts" not in stats:
        return {}
    counts = stats["d2net.counts"].tolist()
    out = {name: [row[n] for row in counts] for n, name in enumerate(COUNTERS)}
    out["peak"] = stats["d2net.peak"].tolist()
    return out


def load_d2net_checkpoint(path: str) -> dict:
    """The published ``d2_tf.pth`` (or any ``D2Net`` state dict: under ``model``, keys
    ``dense_feature_extraction.model.{i}.weight`` / ``.bias`` at the ``nn.Sequential``
    indices of the convolutions, ``module.`` prefixes allowed) -> D2-Net parameters on
    the CPU. Raises ``FileNotFoundError`` when the file is missing and ``ValueError``
    when its keys do not fit the network; never falls back to random weights."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"D2-Net checkpoint {path} not found: put the published "
                                "d2_tf.pth there")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model", ckpt)
    state = {k.replace("module.", ""): v for k, v in state.items()}
    convs, want, index = [], set(), 0
    for step in D2NET_VGG16_CONV4_3:
        if isinstance(step, Conv):
            key = f"dense_feature_extraction.model.{index}"
            want |= {f"{key}.weight", f"{key}.bias"}
            w, b = state.get(f"{key}.weight"), state.get(f"{key}.bias")
            if w is None or b is None or tuple(w.shape) != (step.cout, step.cin, step.k, step.k):
                raise ValueError(f"{path}: no {key} of shape {(step.cout, step.cin, 3, 3)}")
            convs.append({"w": w.to(torch.float32), "b": b.to(torch.float32)})
            index += 1 + step.relu
        else:
            index += 1
    extra = sorted(set(state) - want)
    if extra:
        raise ValueError(f"{path}: keys D2-Net does not have: {extra[:5]}")
    return {"convs": convs}


def save_d2net_npz(path: str, feats: D2NetFeatures, frame: int = 0) -> str:
    """Write one frame's kept keypoints as ``extract_features.py`` does (``.d2-net``:
    keypoints (N, 3) [x, y, 1/scale], scores, descriptors), in the upstream's order:
    by level, then channel, row and column."""
    v = feats.valid[frame].cpu().numpy()
    cell = feats.cell[frame].cpu().numpy()[v]
    order = np.lexsort(cell.T[::-1])
    with open(path, "wb") as f:
        np.savez(f, keypoints=feats.kp[frame].cpu().numpy()[v][order],
                 scores=feats.score[frame].cpu().numpy()[v][order],
                 descriptors=feats.desc[frame].cpu().numpy()[v][order])
    return path
