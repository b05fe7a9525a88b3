"""A profiled sub-window of a run and what the per-layer readers take from it.

The profiler traces the device only (CUPTI: kernels, copies, sets, and the host's CUDA
runtime calls) over a few whole chunks of work, and the raw events are read directly:
building the profiler's event tree for the ~10,900 launches of each engine step would
take minutes. Device busy time is the union of the device intervals, so work that
overlaps on two streams counts once.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaLaunchCooperativeKernel"}
HOST_BETWEEN_CALLS = "host between CUDA calls"


@dataclass
class Summary:
    """The sub-window: its host-clock length, the device's busy seconds in it, the
    frames it covered, launches counted from the runtime calls, and per device
    operation its count and seconds."""

    window_s: float
    busy_s: float
    frames: int
    launches: int
    runtime_calls: int
    ops: dict = field(default_factory=dict)          # name -> [count, seconds]
    gaps: dict = field(default_factory=dict)         # host label -> idle seconds

    def kernel(self, name_part: str) -> tuple[int, float]:
        """(calls, seconds) of the device operations whose name holds ``name_part``
        (a kernel's name in the trace may carry its signature)."""
        n = s = 0
        for name, (c, sec) in self.ops.items():
            if name_part in name:
                n, s = n + c, s + sec
        return n, s

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name[:96], sec] for name, (_, sec) in top],
                "idle_gaps": [[label, sec] for label, sec in gaps]}


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{which}_us")() * 1000)


def summarize(events, window_s: float, frames: int) -> Summary:
    """Read raw kineto events (``prof.profiler.kineto_results.events()``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev_s, dev_e, rt_s, rt_e, rt_name = [], [], [], [], []
    ops: dict = {}
    launches = 0
    for e in events:
        if e.is_user_annotation():
            continue
        name = e.name()
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if e.device_type() == cuda:
            dev_s.append(start)
            dev_e.append(start + dur)
            rec = ops.setdefault(name, [0, 0.0])
            rec[0] += 1
            rec[1] += dur * 1e-9
        else:
            rt_s.append(start)
            rt_e.append(start + dur)
            rt_name.append(name)
            launches += name in LAUNCH_CALLS
    busy_ns, gaps = 0, {}
    if dev_s:
        order = np.argsort(dev_s, kind="stable")
        s, e = np.asarray(dev_s)[order], np.asarray(dev_e)[order]
        run_end = np.maximum.accumulate(e)
        # A new busy interval starts wherever a start lies past every earlier end.
        new = np.concatenate([[True], s[1:] > run_end[:-1]])
        starts = s[new]
        ends = np.concatenate([run_end[:-1][new[1:]], run_end[-1:]])
        busy_ns = int(np.sum(ends - starts))
        gap_lo, gap_hi = ends[:-1], starts[1:]
        gaps = _label_gaps(gap_lo, gap_hi, rt_s, rt_e, rt_name)
    return Summary(window_s=window_s, busy_s=busy_ns * 1e-9, frames=frames,
                   launches=launches, runtime_calls=len(rt_s), ops=ops, gaps=gaps)


def _label_gaps(lo, hi, rt_s, rt_e, rt_name) -> dict:
    """Idle seconds per label: the host's CUDA runtime call in progress at the middle
    of each gap, else ``HOST_BETWEEN_CALLS`` (Python and framework work)."""
    out: dict = {}
    if len(lo) == 0:
        return out
    mid = (lo + hi) // 2
    dur = (hi - lo) * 1e-9
    if rt_s:
        order = np.argsort(rt_s, kind="stable")
        s, e = np.asarray(rt_s)[order], np.asarray(rt_e)[order]
        names = np.asarray(rt_name, dtype=object)[order]
        i = np.searchsorted(s, mid, side="right") - 1
        inside = (i >= 0) & (e[np.clip(i, 0, None)] > mid)
        labels = np.where(inside, names[np.clip(i, 0, None)], HOST_BETWEEN_CALLS)
    else:
        labels = np.full(len(lo), HOST_BETWEEN_CALLS, dtype=object)
    for label, d in zip(labels, dur):
        out[label] = out.get(label, 0.0) + float(d)
    return out


class SubWindow:
    """Start and stop the profiler around whole chunks of a run: ``at(k)`` is called
    before the k-th unit of work of the window; the profiler runs over units
    [first, first + count). Both ends synchronise the card, so the sub-window holds
    exactly that work."""

    def __init__(self, first: int, count: int, frames_per_unit: int, device):
        self.first, self.last = first, first + count
        self.frames = count * frames_per_unit
        self.device = device
        self.prof = None
        self.window_s = None

    def at(self, k: int) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if k == self.first:
            torch.cuda.synchronize(self.device)
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif k == self.last and self.prof is not None:
            torch.cuda.synchronize(self.device)
            self.window_s = time.perf_counter() - self.t0
            self.prof.stop()

    def summary(self) -> Summary | None:
        """Read the trace, once the run's window has closed (None if it never ran)."""
        if self.window_s is None:
            if self.prof is not None:
                self.prof.stop()
            return None
        return summarize(self.prof.profiler.kineto_results.events(), self.window_s,
                         self.frames)
