"""Device milliseconds per frame of the part of D2-Net that is its own, over the
profiled sub-window: the CUDA events of the program's ``d2net.fuse`` (upsample-add and
banned mask), ``d2net.detect`` (detection, localization, budget) and ``d2net.describe``
(sampling, normalisation, positions) spans, every level, over the sub-window's frames.
A program without the spans reads nothing."""


def read(run):
    if "d2net_detect_device_ms" not in run.stats or not run.stats.get("d2net_span_frames"):
        return None
    return run.stats["d2net_detect_device_ms"] / run.stats["d2net_span_frames"]
