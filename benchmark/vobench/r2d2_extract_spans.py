"""Driver of the ``r2d2_extract`` traffic for either published R2D2 network, with the
program's spans recorded over a traced run's profiled sub-window.

The inputs, a batch's call, the batches checked and the judge are ``r2d2_extract``'s,
imported; its window loop is repeated here unchanged. Two things differ:

- ``program`` takes the port's network by the configuration's name, from both
  published specs (``Fast_Quad_L2Net_ConfCFS``, ``Quad_L2Net_ConfCFS``), and raises
  when the port's layers are not the configuration's;
- in a ``--trace 1`` run the program's span recorder (``vo_tpu_torch/utils/
  profiling.py``) runs between the ends of the profiled sub-window, and the sums over
  its ``r2d2.conv`` spans (``conv_roofline.span_sums``) go into ``Run.stats``. A
  program without that span leaves them out, and their readers read nothing.
"""

from __future__ import annotations

import time

import torch

from vobench import conv_roofline
from vobench.harness import Run, checks_from
from vobench.r2d2_extract import (batches, call, control_outputs, judge, make_inputs,
                                  sample_batches)
from vobench.trace import SubWindow


def program(config: dict):
    """(the port's network spec, its MultiscaleConfig) as the configuration states
    them; raises when the port's layers are not the configuration's."""
    from vo_tpu_torch.models.multiscale import MultiscaleConfig
    from vo_tpu_torch.models.patchnet import FAST_QUAD_L2NET_CONFCFS, QUAD_L2NET_CONFCFS

    net, ms = config["network"], config["multiscale"]
    spec = {s.name: s for s in (FAST_QUAD_L2NET_CONFCFS, QUAD_L2NET_CONFCFS)}[net["name"]]
    got = [dict(**{"in": c.in_ch, "out": c.out_ch, "k": c.k, "dilation": c.dilation,
                   "bn": c.bn, "relu": c.relu, "pool_after": c.pool_after})
           for c in spec.convs]
    if got != net["layers"] or spec.out_dim != net["out_dim"] or spec.upsample != net["upsample"]:
        raise RuntimeError(f"the port's {spec.name} is not the configuration's network")
    mcfg = MultiscaleConfig(
        scale_f=ms["scale_f"], min_scale=ms["min_scale"], max_scale=ms["max_scale"],
        min_size=ms["min_size"], max_size=ms["max_size"], top_k=ms["top_k"],
        per_scale_k=ms["per_scale_k"], rel_thr=ms["reliability_thr"],
        rep_thr=ms["repeatability_thr"], nms_size=ms["nms_size"], border=ms["border"])
    return spec, mcfg


class SpanWindow(SubWindow):
    """The profiled sub-window with the program's span recorder on between its ends."""

    spans = None

    def at(self, k: int) -> None:
        from vo_tpu_torch.utils import profiling

        closing = k == self.last and self.prof is not None
        super().at(k)
        if k == self.first:
            profiling.start()
        elif closing:
            self.spans = profiling.stop()

    def span_stats(self) -> dict:
        """``conv_roofline.span_sums`` over the sub-window ({} if it never closed)."""
        if self.spans is None:
            if self.prof is not None:
                from vo_tpu_torch.utils import profiling

                profiling.stop()
            return {}
        return conv_roofline.span_sums(self.spans, self.frames)


def run(ctx) -> Run:
    """Set-up, the window, then the judge; see ``r2d2_extract``'s docstring."""
    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    inputs = make_inputs(config, traffic, ctx.seed, dev)
    spec, mcfg = program(config)
    t1 = time.perf_counter()
    call(inputs, traffic, spec, mcfg, dev, 0)
    warm_s = time.perf_counter() - t1
    sub = None
    if ctx.trace and cuda:
        first, count = traffic["trace_batches"]
        sub = SpanWindow(first, count, traffic["batch"], dev)
    keep = sample_batches(ctx.seed, traffic)
    events, outputs = [], {}
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_window = time.perf_counter()
    setup_s = t_window - ctx.t0
    ordinal = 0
    while True:
        if sub is not None:
            sub.at(ordinal)
        if ctx.trace and cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        got = call(inputs, traffic, spec, mcfg, dev, ordinal)
        if ctx.trace and cuda:
            end.record()
            events.append((start, end))
        if ordinal in keep:
            outputs[ordinal] = got
        ordinal += 1
        if time.perf_counter() - t_window >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_window
    outputs[ordinal - 1] = got
    memory = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = sub.summary() if sub is not None else None
    stats = sub.span_stats() if sub is not None else {}
    if events:
        torch.cuda.synchronize(dev)
    extract_ms = float(sum(s.elapsed_time(e) for s, e in events)) if events else None
    t_judge = time.perf_counter()
    numbers = judge(inputs, outputs, config, traffic, dev)
    judge_s = time.perf_counter() - t_judge
    frames = ordinal * traffic["batch"]
    return Run(frames=frames, window_s=window_s, setup_s=setup_s, memory_peak_bytes=memory,
               checks=checks_from(numbers, config["correctness"]["limits"]),
               attempted=frames, stats=stats, extract_ms=extract_ms,
               extract_frames=len(events) * traffic["batch"], trace=summary, config=config,
               traffic=traffic, info={"batches": ordinal, "inputs_s": t1 - t0,
                                      "warm_s": warm_s, "checked_batches": sorted(outputs),
                                      "judge_s": judge_s, **stats})


def readings(config: dict, traffic: dict, seed: int, device, control: bool = False) -> dict:
    """The judge's numbers for every distinct batch of the seed's frames through the
    program, or through the control in its place (to set the limits from)."""
    inputs = make_inputs(config, traffic, seed, device)
    if control:
        outputs = {o: control_outputs(inputs, config, traffic, o, device)
                   for o in range(batches(inputs, traffic))}
    else:
        spec, mcfg = program(config)
        outputs = {o: call(inputs, traffic, spec, mcfg, device, o)
                   for o in range(batches(inputs, traffic))}
    return judge(inputs, outputs, config, traffic, device)
