"""The reader of the hypothesis-bank kernel's share on hand-made runs: a full reading,
eager steps, a program without the counter (the parent of the kernel) and a window
without steps."""

from __future__ import annotations

import pytest

from vobench import harness


def _run(stats: dict) -> harness.Run:
    return harness.Run(frames=320, window_s=5.0, setup_s=1.0, memory_peak_bytes=0,
                       checks=[], attempted=320, stats=stats)


FULL = {"graph_replays": 318, "eager_steps": 0, "engine_device_s": 0.32,
        "gn_kernel_solves": 636, "bank_kernel_calls": 318, "engine_s": 0.12}


@pytest.mark.parametrize("stats, want", [
    (FULL, 100.0),
    (dict(FULL, graph_replays=150, eager_steps=9, bank_kernel_calls=159), 100.0),
    (dict(FULL, graph_replays=150, eager_steps=10, bank_kernel_calls=80), 50.0),
    (dict(FULL, graph_replays=0, eager_steps=7, bank_kernel_calls=0), 0.0),
    ({k: v for k, v in FULL.items() if k != "bank_kernel_calls"}, None),
    ({"bank_kernel_calls": 12}, None),
    (dict(FULL, graph_replays=0, eager_steps=0, bank_kernel_calls=0), None),
    ({}, None),
])
def test_bank_kernel_pct_reader(stats, want):
    got = harness.reader("pnp_bank_kernel_pct")(_run(stats))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)
