"""Device milliseconds per frame of the network's convolutions with dilation >= 4 over
the profiled sub-window: the CUDA events of the program's ``r2d2.conv`` spans of those
layers, summed over every pyramid level, over the sub-window's frames. A program
without the span reads nothing."""


def read(run):
    if "dilated_conv_device_ms" not in run.stats or not run.stats.get("conv_frames"):
        return None
    return run.stats["dilated_conv_device_ms"] / run.stats["conv_frames"]
