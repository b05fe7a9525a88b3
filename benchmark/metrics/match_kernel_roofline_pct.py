"""The bf16 match kernel's share of its roofline in the profiled sub-window: the
least time its calls could take (each at the configuration's shapes: max_kp x max_kp
x bits, bounded by its operations at 989 TFLOP/s bf16 or its bytes at 3.35 TB/s)
over the time ``top2_wgmma_kernel`` ran on the device."""

from vobench import counts


def read(run):
    if run.trace is None or "extractor" not in run.config:
        return None
    calls, seconds = run.trace.kernel("top2_wgmma_kernel")
    if not calls or seconds <= 0:
        return None
    ex = run.config["extractor"]
    bound_s, _ = counts.match_bound_s(ex["max_kp"], ex["max_kp"], ex["bits"], bf16=True)
    return 100.0 * calls * bound_s / seconds
