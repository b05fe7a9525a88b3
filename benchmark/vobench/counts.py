"""The yardstick's arithmetic: the card's published peaks, the match kernel's
operations and bytes, and the R2D2 network's operations per image.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense rates.
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_HBM_BYTES = 3.35e12


def match_ops_bytes(na: int, nb: int, d: int, bf16: bool) -> tuple[float, float]:
    """One top-2 / mutual match call on (na, d) x (nb, d): its products (2 na nb d
    operations) and its least traffic: each operand element read once (2 bytes in
    bf16, 4 in fp32), both validity masks read, nn12 (4 bytes) and the top-2
    similarities (8) written per row, nn21 (4) per column."""
    elem = 2 if bf16 else 4
    flops = 2.0 * na * nb * d
    nbytes = (na + nb) * d * elem + (na + nb) + na * (4 + 8) + nb * 4
    return flops, float(nbytes)


def match_bound_s(na: int, nb: int, d: int, bf16: bool) -> tuple[float, str]:
    """The least time one call can take on the card and what bounds it."""
    flops, nbytes = match_ops_bytes(na, nb, d, bf16)
    t_ops = flops / PEAK_FLOPS["bf16" if bf16 else "fp32"]
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def pyramid_levels(H: int, W: int, ms: dict) -> list[tuple[float, int, int]]:
    """(scale, rows, columns) of each level the multiscale extractor visits: s walks
    down from 1 by ``scale_f`` while it lies in the window of scales and sizes; a
    level's size is ``round(H s)`` x ``round(W s)``, each made even."""
    out = []
    s = 1.0
    lo = max(ms["min_scale"], ms["min_size"] / max(H, W))
    hi = min(ms["max_scale"], ms["max_size"] / max(H, W))
    while s + 0.001 >= lo:
        if s - 0.001 <= hi:
            nh, nw = max(round(H * s), 2), max(round(W * s), 2)
            out.append((s, nh + nh % 2, nw + nw % 2))
        s /= ms["scale_f"]
    return out


def patchnet_flops(layers: list[dict], out_dim: int, h: int, w: int) -> float:
    """Operations of one forward pass on an h x w input: 2 per multiply-add of every
    convolution at the resolution it runs at (a max-pool after a layer divides the
    following layers' rows and columns by its window; an output upsample restores
    them) and of the two 1x1 heads (2 and 1 outputs) at the output's resolution.
    Bias, BatchNorm, activations and normalisation are not counted."""
    total = 0.0
    hh, ww = h, w
    for layer in layers:
        total += 2.0 * layer["k"] * layer["k"] * layer["in"] * layer["out"] * hh * ww
        pool = layer.get("pool_after", 1)
        hh, ww = hh // pool, ww // pool
    return total + 2.0 * out_dim * 3 * h * w


def r2d2_flops_per_image(config: dict) -> float:
    """The network's operations on one image through the whole pyramid."""
    H, W = config["image_hw"]
    net = config["network"]
    return sum(patchnet_flops(net["layers"], net["out_dim"], nh, nw)
               for _, nh, nw in pyramid_levels(H, W, config["multiscale"]))
