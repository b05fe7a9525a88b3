"""D2-Net's whole extraction step's share of the card's fp32 peak (67 TFLOP/s; TF32 is
off) over the profiled sub-window of whole batches: the trunk's operations on its
frames through every level (``d2net_counts.flops_per_image``, 2,681 GFLOP a 376 x
1232 frame), over its length (host clock, both ends synchronised)."""

from vobench import counts, d2net_counts


def read(run):
    if run.trace is None or "d2net" not in run.config or run.trace.window_s <= 0:
        return None
    flops = d2net_counts.flops_per_image(run.config) * run.trace.frames
    return 100.0 * flops / run.trace.window_s / counts.PEAK_FLOPS["fp32"]
