"""The program's spans over a trace (``vobench/spans.py``) on hand-made spans and
events: gap-midpoint attribution, launch calls counted only inside spans of their own
thread, the innermost span per gap, the gaps against ``trace.summarize``'s busy time,
and nothing read from a run without spans."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vobench import spans as sp
from vobench import trace
from vo_tpu_torch.utils.profiling import SpanRecord

MAIN, OTHER = 0x7F00_1234_5678, 0x7F00_8765_4321      # pthread ids; CUPTI keeps 32 bits
MS = 1_000_000


def _span(name, start, end, parent=-1, thread=MAIN, device_ms=None, **attrs):
    return SpanRecord(name, 1 if thread == MAIN else 2, thread, start * MS,
                      None if end is None else end * MS, parent, attrs, device_ms)


def _chunk():
    """One chunk 0-100 ms: an engine.chunk 10-90 holding a step 10-90 whose PnP runs
    40-80, then a readback wait 90-95; the producer's upload 0-30 on its thread."""
    return [_span("stream.chunk", 0, 100, chunk=0),
            _span("engine.chunk", 10, 90, 0),
            _span("engine.step", 10, 90, 1, frame=1),
            _span("pnp.ransac", 40, 80, 2),
            _span("stream.sync_wait", 90, 95, 0, what="readback"),
            _span("loader.upload", 0, 30, thread=OTHER)]


def test_readings_attribute_by_midpoint_and_thread():
    """Launch calls count in a span of their own thread only; idle time goes to the spans
    open at each gap's midpoint."""
    s = _chunk()
    # launches at 20 (step), 50 and 60 (PnP), 70 (PnP, but on the producer's thread)
    launches = np.array([20, 50, 60, 70], np.int64) * MS
    threads = np.array([MAIN, MAIN, MAIN, OTHER], np.int64) & 0xFFFFFFFF
    # gaps: 5-15 (mid 10: engine.chunk opens at 10 -> inside), 45-55 (PnP),
    # 85-99 (mid 92: the wait, outside engine.chunk), 100-110 (after every span)
    gaps = np.array([[5, 15], [45, 55], [85, 99], [100, 110]], np.int64) * MS
    r = sp.readings(s, launches, threads, gaps, frames=2)
    assert r["pnp_host_ms_per_frame"] == pytest.approx(40.0 / 2)
    assert r["pnp_launches_per_frame"] == 2 / 2
    assert r["engine_idle_ms_per_frame"] == pytest.approx((10 + 10) / 2)
    assert r["readback_wait_ms_per_frame"] == pytest.approx(5.0 / 2)
    assert r["r2d2_select_ms_per_frame"] is None
    assert dict(r["idle_by_span"]) == pytest.approx(
        {"engine.step": 0.010, "pnp.ransac": 0.010, "stream.sync_wait": 0.014,
         sp.NO_SPAN: 0.010})
    assert [k for k, _ in r["idle_by_span"]][0] == "stream.sync_wait"
    t = sp.table(s, 2, launches, threads, gaps)
    assert {k: v[3] for k, v in t.items() if v[3]} == {"engine.step": 0.5, "pnp.ransac": 1.0}


def test_open_spans_run_to_the_end_of_the_window():
    s = [_span("stream.chunk", 0, None, chunk=5), _span("stream.queue_wait", 0, 10, 0)]
    where = sp.innermost(s, np.array([5, 50], np.int64) * MS, MAIN)
    assert where.tolist() == [1, 0]
    t = sp.table(s, 1, np.array([5 * MS, 50 * MS]), np.array([MAIN, OTHER]),
                 np.array([[40, 60]]) * MS)
    assert t == {"stream.chunk": [0, 0.0, None, 0.0, pytest.approx(20.0)],
                 "stream.queue_wait": [1, pytest.approx(10.0), None, 1.0, 0.0]}


def test_device_times_of_the_selection():
    s = [_span("r2d2.extract", 0, 30),
         _span("r2d2.level", 0, 20, 0, scale=1.0),
         _span("r2d2.network", 0, 10, 1, device_ms=7.0),
         _span("r2d2.select", 10, 20, 1, device_ms=2.0),
         _span("r2d2.merge", 20, 30, 0, device_ms=0.5)]
    r = sp.readings(s, np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros((0, 2), np.int64), frames=5)
    assert r["r2d2_select_ms_per_frame"] == pytest.approx(2.5 / 5)
    assert r["pnp_host_ms_per_frame"] is None and r["engine_idle_ms_per_frame"] is None
    empty = np.zeros(0, np.int64)
    assert sp.table(s, 5, empty, empty, np.zeros((0, 2), np.int64))["r2d2.network"] == [
        1, pytest.approx(2.0), pytest.approx(1.4), 0.0, 0.0]


def test_nothing_without_spans():
    r = sp.readings([], np.array([1]), np.array([1]), np.array([[0, 1]]), frames=4)
    assert all(v is None for k, v in r.items() if k != "idle_by_span")
    assert r["idle_by_span"] == []


class _Event:
    def __init__(self, name, start, dur, cuda, res=0):
        self._n, self._s, self._d, self._c, self._r = name, start, dur, cuda, res

    def is_user_annotation(self):
        return False

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def device_resource_id(self):
        return self._r


def test_trace_intervals_against_summarize():
    ev = [_Event("cudaLaunchKernel", 0, 5, False, -685771072),
          _Event("k1", 10, 20, True), _Event("k2", 25, 10, True),     # busy 10-35
          _Event("cudaMemcpyAsync", 36, 2, False),
          _Event("cuLaunchKernel", 40, 3, False, 121),
          _Event("k3", 50, 5, True), _Event("k4", 70, 10, True)]      # busy 50-55, 70-80
    launches, threads, gaps = sp.trace_intervals(ev)
    assert launches.tolist() == [0, 40]
    assert threads.tolist() == [-685771072 & 0xFFFFFFFF, 121]
    assert gaps.tolist() == [[35, 50], [55, 70]]
    s = trace.summarize(ev, window_s=80e-9, frames=1)
    assert s.busy_s == pytest.approx((80 - 10 - gaps[:, 1].sum() + gaps[:, 0].sum()) * 1e-9)
    assert s.gaps == pytest.approx({"cuLaunchKernel": 15e-9,        # mid 42 in 40-43
                                    trace.HOST_BETWEEN_CALLS: 15e-9})
