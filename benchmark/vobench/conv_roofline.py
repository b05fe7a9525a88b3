"""The roofline of one convolution the program ran, from the attributes of its
``r2d2.conv`` span (``vo_tpu_torch/models/patchnet.py``): ``k``, ``dilation``, ``cin``,
``cout``, and ``rows`` frames of ``h`` x ``w`` pixels, the size the convolution reads
and writes (its padding keeps the size).

Operations: 2 per multiply-add, 2 k^2 cin cout rows h w; the dilation spreads the taps
and adds none. Bytes: the least traffic in fp32, each input and output element once and
the weights once, 4 rows h w (cin + cout) + 4 k^2 cin cout. The least time is the
larger of the operations at the fp32 peak (TF32 is off) and the bytes at the HBM
bandwidth (``counts.PEAK_FLOPS``, ``counts.PEAK_HBM_BYTES``).
"""

from __future__ import annotations

from vobench import counts

SPAN = "r2d2.conv"
DILATED = 4          # the dilation from which a convolution counts as dilated


def ops_bytes(a: dict) -> tuple[float, float]:
    """(operations, bytes) of one convolution span's attributes ``a``."""
    taps = a["k"] * a["k"] * a["cin"] * a["cout"]
    pixels = a["rows"] * a["h"] * a["w"]
    return 2.0 * taps * pixels, 4.0 * pixels * (a["cin"] + a["cout"]) + 4.0 * taps


def bound_s(a: dict) -> float:
    """The least time the convolution can take on the card."""
    ops, nbytes = ops_bytes(a)
    return max(ops / counts.PEAK_FLOPS["fp32"], nbytes / counts.PEAK_HBM_BYTES)


def span_sums(spans, frames: int) -> dict:
    """Over the finished ``r2d2.conv`` spans with a device time: their device ms, their
    least ms, and the device ms of those with dilation >= ``DILATED``, with the
    ``frames`` they covered; {} where there is no such span."""
    conv = [s for s in spans if s.name == SPAN and s.device_ms is not None]
    if not conv:
        return {}
    return {"conv_spans": len(conv),
            "conv_device_ms": sum(s.device_ms for s in conv),
            "conv_bound_ms": 1e3 * sum(bound_s(s.attrs) for s in conv),
            "dilated_conv_device_ms": sum(s.device_ms for s in conv
                                          if s.attrs["dilation"] >= DILATED),
            "conv_frames": frames}
