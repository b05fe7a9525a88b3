"""The whole extraction step's share of the card's fp32 peak (67 TFLOP/s; TF32 is
off) over the profiled sub-window of whole batches: the network's operations on its
frames, through every pyramid level (``counts.r2d2_flops_per_image``), over its
length (host clock, both ends synchronised)."""

from vobench import counts


def read(run):
    if run.trace is None or "network" not in run.config or run.trace.window_s <= 0:
        return None
    flops = counts.r2d2_flops_per_image(run.config) * run.trace.frames
    return 100.0 * flops / run.trace.window_s / counts.PEAK_FLOPS["fp32"]
