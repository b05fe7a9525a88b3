"""Profiling harness: per-stage wall timing, a torch.profiler trace, and the port's
own spans. Port of ``vo_tpu/utils/profiling.py``.

CUDA work runs asynchronously to the host, so ``StageTimer.stage`` synchronises the
current CUDA stream before it reads the clock, at the start and at the end of the
stage (the JAX package's ``timed`` forces a host copy of the result for the same
reason); ``trace`` writes a Chrome trace (Perfetto-compatible) into ``log_dir``.

Spans mark the port's stages on the hot path without synchronising anything:

    profiling.start()
    ...                                  # code that opens ``with span("pnp.ransac"):``
    records = profiling.stop()           # list[SpanRecord]
    profiling.to_chrome(records, "spans.json")

A span reads the host clock at its ends, on the clock of ``torch.profiler``'s kineto
events (``time.time_ns``, the Unix epoch), so the spans lie on the device trace's
timeline: its kernels, its CUDA runtime calls and the device's idle gaps. A span
opened with ``device=True`` also records a pair of CUDA events on the current stream
(none while the stream is being captured into a CUDA graph); their elapsed time is read
in ``stop``. Spans nest per thread: each record names its parent's index. A ``chunk``
attribute is handed down to the spans nested under the span that carries it.

The recorder is one switch for the process, as ``torch.profiler`` is: the spans sit
deep inside the engine, where no recorder object can be passed. While it is off,
``span`` costs one flag test and returns a shared null context.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class StageTimer:
    """Accumulates wall time per named stage; prints a table."""

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn under ``stage(name)``: its device work is finished when the clock
        stops."""
        with self.stage(name):
            return fn(*args, **kwargs)

    def report(self) -> str:
        lines = [f"{'stage':<28}{'total_s':>10}{'calls':>8}{'ms/call':>10}"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<28}{tot:>10.3f}{n:>8}{tot / n * 1000:>10.1f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA when there is a card) and write
    ``log_dir/trace.json``, and the port's spans over the block as
    ``log_dir/spans.json`` on the same time base (Perfetto shows both on one timeline
    once their ``traceEvents`` lists are joined into one file)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        start()
        try:
            yield prof
        finally:
            _sync()
            records = stop()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    to_chrome(records, os.path.join(log_dir, "spans.json"), _trace_base_ns(path))


class SpanRecord(NamedTuple):
    """One finished span: ``end_ns`` is None for a span still open at ``stop``;
    ``parent`` is the index of the enclosing span in the same list, -1 for a root;
    ``device_ms`` the CUDA events' elapsed time of a ``device=True`` span, else None."""

    name: str
    tid: int                  # the OS thread id, as the profiler's CPU events name threads
    thread: int               # ``threading.get_ident()``: CUPTI's runtime calls carry
    start_ns: int             # its low 32 bits in a CUDA-only trace
    end_ns: int | None
    parent: int
    attrs: dict
    device_ms: float | None


_on = False              # the switch; ``span`` tests it and nothing else while off
_records: list = []      # spans opened since ``start``, in the order they opened
_local = threading.local()      # per thread: the open span (``cur``) and its ids
_NULL = contextlib.nullcontext()


class _Span:
    """A span while it is open; ``recorded`` False for a ``timed`` block the recorder
    does not keep (its clock is read all the same)."""

    __slots__ = ("name", "attrs", "recorded", "device", "ids", "parent", "events",
                 "start_ns", "end_ns")

    def __init__(self, name: str, attrs: dict, recorded: bool = True,
                 device: bool = False):
        self.name, self.attrs, self.recorded, self.device = name, attrs, recorded, device
        self.parent = self.events = None
        self.end_ns = None

    def __enter__(self):
        if self.recorded:
            loc = _local
            self.ids = getattr(loc, "ids", None) or _thread_ids()
            self.parent = getattr(loc, "cur", None)
            loc.cur = self
            _records.append(self)
            if (self.device and torch.cuda.is_initialized()
                    and not torch.cuda.is_current_stream_capturing()):
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        if self.recorded:
            if self.events is not None:
                self.events[1].record()
            _local.cur = self.parent
        self.end_ns = end
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _thread_ids() -> tuple[int, int]:
    _local.ids = (threading.get_native_id(), threading.get_ident())
    return _local.ids


def span(name: str, device: bool = False, **attrs):
    """Context manager marking a stage (``device``: also time it with CUDA events).
    Attributes are host values only: reading a device tensor would be a host sync."""
    if not _on:
        return _NULL
    return _Span(name, attrs, device=device)


def recording() -> bool:
    """Whether the recorder is on: a site whose span attributes cost work to gather
    tests this before it builds them."""
    return _on


def timed(name: str, **attrs) -> _Span:
    """A span whose clock is read whether or not the recorder is on, for a caller that
    also sums the interval itself (``.seconds``): both come from the same two reads."""
    return _Span(name, attrs, recorded=_on)


def start() -> None:
    """Switch the recorder on, dropping anything recorded before."""
    global _on
    _records.clear()
    _on = True


def stop() -> list[SpanRecord]:
    """Switch the recorder off and hand back what it recorded since ``start``. Reads the
    elapsed time of each device span's events, waiting for its end event if the device
    has not reached it."""
    global _on
    _on = False
    live = list(_records)
    _records.clear()
    index = {id(s): i for i, s in enumerate(live)}
    out: list[SpanRecord] = []
    for s in live:
        parent = index.get(id(s.parent), -1) if s.parent is not None else -1
        attrs = dict(s.attrs)
        if parent >= 0 and "chunk" not in attrs and "chunk" in out[parent].attrs:
            attrs["chunk"] = out[parent].attrs["chunk"]
        device_ms = None
        if s.events is not None and s.end_ns is not None:
            s.events[1].synchronize()
            device_ms = s.events[0].elapsed_time(s.events[1])
        out.append(SpanRecord(s.name, *s.ids, s.start_ns, s.end_ns, parent, attrs,
                              device_ms))
    return out


def to_chrome(records: list[SpanRecord], path: str, base_ns: int = 0) -> str:
    """Write the finished spans as Chrome trace events (``ph: X``, microseconds since
    ``base_ns``), on this process's id and each span's thread id."""
    pid = os.getpid()
    events = []
    for r in records:
        if r.end_ns is None:
            continue
        args = dict(r.attrs)
        if r.device_ms is not None:
            args["device_ms"] = r.device_ms
        events.append({"name": r.name, "ph": "X", "pid": pid, "tid": r.tid,
                       "ts": (r.start_ns - base_ns) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": base_ns, "traceEvents": events}, f)
    return path


def _trace_base_ns(path: str) -> int:
    """The time base of a trace ``torch.profiler`` exported (0 if it states none)."""
    with open(path) as f:
        head = f.read(1 << 16)
    m = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    return int(m.group(1)) if m else 0
