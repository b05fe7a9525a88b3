"""The readers of the engine's device time and of the Gauss-Newton kernel's share on
hand-made runs: a full reading, a program without the counters (the parent of the
kernel) and a window without steps."""

from __future__ import annotations

import pytest

from vobench import harness


def _run(stats: dict) -> harness.Run:
    return harness.Run(frames=320, window_s=5.0, setup_s=1.0, memory_peak_bytes=0,
                       checks=[], attempted=320, stats=stats)


FULL = {"graph_replays": 318, "eager_steps": 0, "engine_device_s": 1.59,
        "gn_kernel_solves": 636, "engine_s": 0.12}


@pytest.mark.parametrize("name, stats, want", [
    ("engine_device_ms_per_frame", FULL, 5.0),
    ("engine_device_ms_per_frame", {"graph_replays": 318, "eager_steps": 0,
                                    "engine_s": 0.12}, None),
    ("engine_device_ms_per_frame", dict(FULL, graph_replays=0, engine_device_s=0.0), None),
    ("engine_device_ms_per_frame", dict(FULL, graph_replays=0, eager_steps=4), None),
    ("pnp_gn_kernel_pct", FULL, 100.0),
    ("pnp_gn_kernel_pct", dict(FULL, graph_replays=150, eager_steps=9,
                               gn_kernel_solves=159), 50.0),
    ("pnp_gn_kernel_pct", dict(FULL, graph_replays=0, eager_steps=7, gn_kernel_solves=0),
     0.0),
    ("pnp_gn_kernel_pct", {"graph_replays": 318, "eager_steps": 0, "engine_s": 0.12}, None),
    ("pnp_gn_kernel_pct", {"gn_kernel_solves": 12}, None),
    ("pnp_gn_kernel_pct", dict(FULL, graph_replays=0, eager_steps=0, gn_kernel_solves=0),
     None),
])
def test_engine_counter_readers(name, stats, want):
    got = harness.reader(name)(_run(stats))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["engine_device_ms_per_frame", "pnp_gn_kernel_pct"])
def test_engine_counter_readers_read_nothing_from_an_empty_run(name):
    assert harness.reader(name)(_run({})) is None
