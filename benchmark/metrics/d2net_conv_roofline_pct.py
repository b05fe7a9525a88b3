"""D2-Net's convolutions' share of their roofline over the profiled sub-window: the
least time of every ``d2net.conv`` span the program recorded there (each bounded by its
operations at 67 TFLOP/s fp32 or its bytes at 3.35 TB/s, ``vobench/conv_roofline.py``)
over the spans' device time (CUDA events around each ``F.conv2d``), summed by the
driver ``vobench/d2net_extract.py``. A program without the span reads nothing."""


def read(run):
    if not run.stats.get("d2net_conv_device_ms"):
        return None
    return 100.0 * run.stats["d2net_conv_bound_ms"] / run.stats["d2net_conv_device_ms"]
