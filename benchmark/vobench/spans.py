"""The program's spans (``vo_tpu_torch/utils/profiling.py``) laid over a profiled
sub-window's device trace: in which stage of the program the host was when it launched
a kernel, and when the card sat idle.

Both lie on one clock: the spans read ``time.time_ns``, on which ``torch.profiler``
stamps its kineto events. A launch call belongs to a span of the thread that made it
(in a CUDA-only trace CUPTI names that thread by the low 32 bits of its pthread id,
``device_resource_id``); an idle gap of the card belongs to the spans open at its
midpoint, and, for ``idle_by_span``, to the innermost span of the thread that recorded
the most spans (the streaming entry's consumer, or the extraction's caller).

Nothing here is read by a metric of ``BENCHMARK.json`` yet: the drivers would have to
start the recorder with the profiler, and ``trace.Summary`` carry the launch calls and
the gaps (PERF.md section 7). ``benchmark/span_split.py`` reads it from a cell's run.
"""

from __future__ import annotations

import numpy as np

from vobench.trace import LAUNCH_CALLS, _ns

_OPEN = np.iinfo(np.int64).max        # the end of a span still open when the window shut
NO_SPAN = "(no span)"


def trace_intervals(events) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Raw kineto events -> (the launch calls' start ns, their threads' low 32 bits,
    the device's idle gaps as (n, 2) ns): the gaps between the union of the device's
    intervals, as ``trace.summarize`` takes them."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, starts, threads = [], [], []
    for e in events:
        if e.is_user_annotation():
            continue
        start = _ns(e, "start")
        if e.device_type() == cuda:
            dev.append((start, start + _ns(e, "duration")))
        elif e.name() in LAUNCH_CALLS:
            starts.append(start)
            threads.append(e.device_resource_id() & 0xFFFFFFFF)
    gaps = np.zeros((0, 2), np.int64)
    if dev:
        d = np.asarray(sorted(dev), np.int64)
        run_end = np.maximum.accumulate(d[:, 1])
        new = d[1:, 0] > run_end[:-1]       # a start past every earlier end: a gap
        gaps = np.stack([run_end[:-1][new], d[1:, 0][new]], axis=1)
    return (np.asarray(starts, np.int64), np.asarray(threads, np.int64), gaps)


def _bounds(spans, pick) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the spans ``pick`` keeps, sorted by start."""
    iv = sorted((s.start_ns, _OPEN if s.end_ns is None else s.end_ns)
                for s in spans if pick(s))
    a = np.asarray(iv, np.int64).reshape(-1, 2)
    return a[:, 0], a[:, 1]


def _inside(t: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Which times lie in one of the disjoint intervals [lo, hi] (sorted)."""
    if not len(lo):
        return np.zeros(len(t), bool)
    i = np.searchsorted(lo, t, side="right") - 1
    return (i >= 0) & (t <= hi[np.clip(i, 0, None)])


def _main_thread(spans) -> int:
    counts: dict = {}
    for s in spans:
        counts[s.thread] = counts.get(s.thread, 0) + 1
    return max(counts, key=counts.get)


def innermost(spans, times: np.ndarray, thread: int) -> np.ndarray:
    """Index into ``spans`` of the innermost span of ``thread`` open at each time, -1
    where none is. A thread's spans nest, so the spans of one depth are disjoint."""
    depth = []
    for s in spans:
        depth.append(depth[s.parent] + 1 if s.parent >= 0 else 0)
    out = np.full(len(times), -1, np.int64)
    for d in sorted(set(depth)):
        idx = [i for i, s in enumerate(spans) if depth[i] == d and s.thread == thread]
        if not idx:
            continue
        idx.sort(key=lambda i: spans[i].start_ns)
        lo = np.asarray([spans[i].start_ns for i in idx], np.int64)
        hi = np.asarray([_OPEN if spans[i].end_ns is None else spans[i].end_ns
                         for i in idx], np.int64)
        j = np.searchsorted(lo, times, side="right") - 1
        hit = (j >= 0) & (times <= hi[np.clip(j, 0, None)])
        out[hit] = np.asarray(idx)[j[hit]]
    return out


def _host_ms(spans, name: str) -> float | None:
    done = [s.end_ns - s.start_ns for s in spans if s.name == name and s.end_ns is not None]
    return sum(done) * 1e-6 if done else None


def readings(spans, launches: np.ndarray, launch_threads: np.ndarray, gaps: np.ndarray,
             frames: int) -> dict:
    """The spans' per-frame readings over the sub-window's ``frames`` (None where the
    run recorded no span of that stage), and ``idle_by_span``: the ten innermost spans
    of the main thread with the most idle seconds at gap midpoints."""
    out = {"pnp_host_ms_per_frame": None, "pnp_launches_per_frame": None,
           "engine_idle_ms_per_frame": None, "readback_wait_ms_per_frame": None,
           "r2d2_select_ms_per_frame": None, "idle_by_span": []}
    if not spans or not frames:
        return out
    pnp = _host_ms(spans, "pnp.ransac")
    if pnp is not None:
        out["pnp_host_ms_per_frame"] = pnp / frames
        n = 0
        for th in {s.thread for s in spans if s.name == "pnp.ransac"}:
            lo, hi = _bounds(spans, lambda s: s.name == "pnp.ransac" and s.thread == th)
            mine = (launch_threads & 0xFFFFFFFF) == (th & 0xFFFFFFFF)
            n += int(_inside(launches[mine], lo, hi).sum())
        out["pnp_launches_per_frame"] = n / frames
    mid = (gaps[:, 0] + gaps[:, 1]) // 2
    idle_s = (gaps[:, 1] - gaps[:, 0]) * 1e-9
    if any(s.name == "engine.chunk" for s in spans):
        lo, hi = _bounds(spans, lambda s: s.name == "engine.chunk")
        out["engine_idle_ms_per_frame"] = 1e3 * float(idle_s[_inside(mid, lo, hi)].sum()) \
            / frames
    wait = _host_ms(spans, "stream.sync_wait")
    if wait is not None:
        out["readback_wait_ms_per_frame"] = wait / frames
    sel = [s.device_ms for s in spans
           if s.name in ("r2d2.select", "r2d2.merge") and s.device_ms is not None]
    if sel:
        out["r2d2_select_ms_per_frame"] = sum(sel) / frames
    by = _idle_by_innermost(spans, gaps)
    out["idle_by_span"] = [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:10]]
    return out


def _idle_by_innermost(spans, gaps: np.ndarray) -> dict:
    """Idle seconds per name of the main thread's innermost span at each gap's
    midpoint (``NO_SPAN`` where none is open)."""
    mid = (gaps[:, 0] + gaps[:, 1]) // 2
    by: dict = {}
    for i, ns in zip(innermost(spans, mid, _main_thread(spans)), gaps[:, 1] - gaps[:, 0]):
        name = spans[i].name if i >= 0 else NO_SPAN
        by[name] = by.get(name, 0.0) + float(ns) * 1e-9
    return by


def table(spans, frames: int, launches: np.ndarray, launch_threads: np.ndarray,
          gaps: np.ndarray) -> dict:
    """Per span name, per frame of the sub-window: [spans closed inside the window, host
    ms, device ms (None without events), launch calls made with it innermost on their
    thread, idle ms with it innermost on the main thread at the gaps' midpoints]."""
    out: dict = {}
    for s in spans:
        rec = out.setdefault(s.name, [0, 0.0, None, 0.0, 0.0])
        if s.end_ns is None:
            continue
        rec[0] += 1
        rec[1] += (s.end_ns - s.start_ns) * 1e-6 / frames
        if s.device_ms is not None:
            rec[2] = (rec[2] or 0.0) + s.device_ms / frames
    for th in {s.thread for s in spans}:
        mine = (launch_threads & 0xFFFFFFFF) == (th & 0xFFFFFFFF)
        for i in innermost(spans, launches[mine], th):
            if i >= 0:
                out[spans[i].name][3] += 1 / frames
    for name, sec in _idle_by_innermost(spans, gaps).items():
        if name in out:
            out[name][4] = 1e3 * sec / frames
    return out
