"""Profiling harness: per-stage wall timing and a torch.profiler trace.
Port of ``vo_tpu/utils/profiling.py``.

CUDA work runs asynchronously to the host, so ``StageTimer.stage`` synchronises the
current CUDA stream before it reads the clock, at the start and at the end of the
stage (the JAX package's ``timed`` forces a host copy of the result for the same
reason); ``trace`` writes a Chrome trace (Perfetto-compatible) into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

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
    ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
