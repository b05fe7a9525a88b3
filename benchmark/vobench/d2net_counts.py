"""D2-Net's operations per image: the trunk's convolutions at the sizes they run at,
through every level of the pyramid, 2 operations per multiply-add. The pools, the
ReLUs, the fusion, the detection and the sampling are not counted."""

from __future__ import annotations

import math


def level_sizes(H: int, W: int, scales) -> list[tuple[float, int, int]]:
    """(scale, rows, columns) of each level's image: ``F.interpolate(scale_factor=s)``
    floors H s and W s."""
    return [(s, math.floor(H * s), math.floor(W * s)) for s in scales]


def trunk_convs(layers: list[dict], h: int, w: int) -> list[dict]:
    """The convolutions of one h x w image as their ``d2net.conv`` spans name them
    (one row): ``k``, ``dilation``, ``cin``, ``cout`` and the size they run at (their
    padding keeps it; a pool of window k at stride s takes it to (n - k) // s + 1)."""
    out = []
    for layer in layers:
        if layer["op"] == "conv":
            out.append({"k": layer["k"], "dilation": layer["dilation"], "cin": layer["in"],
                        "cout": layer["out"], "rows": 1, "h": h, "w": w})
        else:
            h = (h - layer["k"]) // layer["stride"] + 1
            w = (w - layer["k"]) // layer["stride"] + 1
    return out


def flops_per_image(config: dict) -> float:
    """The trunk's operations on one image of the configuration's size, all levels."""
    H, W = config["image_hw"]
    total = 0.0
    for _, h, w in level_sizes(H, W, config["multiscale"]["scales"]):
        for a in trunk_convs(config["d2net"]["layers"], h, w):
            total += 2.0 * a["k"] * a["k"] * a["cin"] * a["cout"] * a["h"] * a["w"]
    return total
