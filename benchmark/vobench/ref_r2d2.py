"""The R2D2 cell's weights and plain reference: the Fast patch network's forward pass
in fp32 and the multiscale extraction around it (image pyramid, per-level NMS and
budget, one global top-k).

It follows the published network (naver/r2d2 ``Fast_Quad_L2Net_ConfCFS``: convolutions
padded by ``((k - 1) d) // 2``, affine-free BatchNorm from running statistics, one 2x
max-pool early, a bilinear 2x upsample of the trunk's output, L2-normalised
descriptors, a 2-way softmax reliability and a softplus-ratio repeatability on x^2)
and the extraction settings of the reference ``extract.py``, as a frozen copy of the
port's plain versions. Nothing of the program is imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vobench import counts
from vobench.ref_features import _top_k, maxpool2d_same, resize_bilinear

BN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def draw_weights(net: dict, seed: int, device) -> dict:
    """Seeded weights on ``device`` in the port's parameter layout, from one normal draw
    of a ``torch.Generator`` there: convolutions He-scaled (N(0, 2 / fan_in), OIHW),
    heads N(0, 0.05^2), biases 0, running mean 0 and variance 1."""
    layers, d = net["layers"], net["out_dim"]
    shapes = [(l["out"], l["in"], l["k"], l["k"]) for l in layers] + [(2, d, 1, 1), (1, d, 1, 1)]
    sizes = [o * i * kh * kw for o, i, kh, kw in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    ws = [w.reshape(s) for w, s in zip(torch.split(flat, sizes), shapes)]
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=device)
    convs = []
    for w, l in zip(ws, layers):
        layer = {"w": w * (2.0 / (l["k"] * l["k"] * l["in"])) ** 0.5, "b": zeros(l["out"])}
        if l["bn"]:
            layer["bn_mean"], layer["bn_var"] = zeros(l["out"]), zeros(l["out"]) + 1.0
        convs.append(layer)
    return {"convs": convs, "clf": {"w": ws[-2] * 0.05, "b": zeros(2)},
            "sal": {"w": ws[-1] * 0.05, "b": zeros(1)}}


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> ImageNet-normalised fp32, edge-padded to even H, W."""
    x = images.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    x = (x - mean) / std
    if x.shape[1] % 2:
        x = torch.cat([x, x[:, -1:]], dim=1)
    if x.shape[2] % 2:
        x = torch.cat([x, x[:, :, -1:]], dim=2)
    return x


def _softplus_ratio(x: torch.Tensor) -> torch.Tensor:
    s = torch.logaddexp(x, torch.zeros_like(x))
    return s / (1.0 + s)


def forward(params: dict, net: dict, images: torch.Tensor) -> dict:
    """(B, H, W, 3) normalised fp32 -> descriptors (B, H', W', D), reliability and
    repeatability (B, H', W')."""
    x = images.permute(0, 3, 1, 2)
    for l, p in zip(net["layers"], params["convs"]):
        x = F.conv2d(x, p["w"], padding=((l["k"] - 1) * l["dilation"]) // 2,
                     dilation=l["dilation"])
        x = x + p["b"][:, None, None]
        if l["bn"]:
            scale = torch.rsqrt(p["bn_var"] + BN_EPS)
            x = (x - p["bn_mean"][:, None, None]) * scale[:, None, None]
        if l["relu"]:
            x = torch.relu(x)
        if l["pool_after"] > 1:
            x = F.max_pool2d(x, l["pool_after"])
    x = x.permute(0, 2, 3, 1)
    up = net["upsample"]
    if up > 1:
        _, h, w, _ = x.shape
        x = resize_bilinear(x, (h * up, w * up))
    x2 = x * x
    urel = x2 @ params["clf"]["w"][:, :, 0, 0].T + params["clf"]["b"]
    urep = x2 @ params["sal"]["w"][:, :, 0, 0].T + params["sal"]["b"]
    desc = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)
    e = torch.exp(urel - torch.amax(urel, dim=-1, keepdim=True))
    return {"descriptors": desc, "reliability": e[..., 1] / torch.sum(e, dim=-1),
            "repeatability": _softplus_ratio(urep[..., 0])}


def extract(params: dict, config: dict, images_u8: torch.Tensor) -> dict:
    """Multiscale features of (B, H, W, 3) uint8 frames: {"kp" (B, K, 3) [x, y, 32/s],
    "desc" (B, K, D), "score" (B, K), "valid" (B, K)}."""
    ms, net = config["multiscale"], config["network"]
    images = normalize_images(images_u8)
    B, H, W = images_u8.shape[:3]
    dev = images.device
    bidx = torch.arange(B, device=dev)[:, None]
    parts = {"kp": [], "desc": [], "score": [], "valid": []}
    for s, nh, nw in counts.pyramid_levels(H, W, ms):
        out = forward(params, net, resize_bilinear(images, (nh, nw)))
        rel, rep, desc = out["reliability"], out["repeatability"], out["descriptors"]
        keep = ((rep >= maxpool2d_same(rep, ms["nms_size"]))
                & (rep >= ms["repeatability_thr"]) & (rel >= ms["reliability_thr"]))
        col = torch.arange(nw, device=dev)
        row = torch.arange(nh, device=dev)[:, None]
        b = ms["border"]
        keep &= (col >= b) & (col < nw - b) & (row >= b) & (row < nh - b)
        score = torch.where(keep, rel * rep, float("-inf"))
        top, idx = _top_k(score.reshape(B, nh * nw), min(ms["per_scale_k"], nh * nw))
        y, x = idx // nw, idx % nw
        valid = torch.isfinite(top)
        yf, xf = y.to(torch.float32), x.to(torch.float32)
        parts["kp"].append(torch.stack([xf * (W / nw), yf * (H / nh),
                                        torch.full_like(xf, 32.0 / s)], dim=-1))
        parts["desc"].append(torch.where(valid[..., None], desc[bidx, y, x], 0.0))
        parts["score"].append(top)
        parts["valid"].append(valid)
    kp, desc = torch.cat(parts["kp"], dim=1), torch.cat(parts["desc"], dim=1)
    score, valid = torch.cat(parts["score"], dim=1), torch.cat(parts["valid"], dim=1)
    top, idx = _top_k(score, min(ms["top_k"], score.shape[1]))
    fin = torch.isfinite(top)
    return {"kp": kp[bidx, idx], "desc": desc[bidx, idx],
            "score": torch.where(fin, top, 0.0), "valid": valid[bidx, idx] & fin}
