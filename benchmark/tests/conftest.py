"""Shared set-up of the benchmark's own tests: the harness and the program on the
path, the ``cuda`` marker, and the cells cut to a size a CPU test holds."""

from __future__ import annotations

import copy
import os
import sys
import time
from types import SimpleNamespace

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

from vobench import harness  # noqa: E402

# A small camera with the cells' field of view, and a small drive.
SMALL_HW = (120, 384)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


def shrink(workload: str, frames: int = 24) -> dict:
    """The workload's files with the camera, the budgets and the drive cut down."""
    w = copy.deepcopy(harness.workload(workload))
    cfg, tr = w["config"], w["traffic"]
    H, W = SMALL_HW
    f = 721.53 * W / 1232
    cfg["image_hw"] = [H, W]
    cfg["K"] = [[f, 0.0, (W - 1) / 2], [0.0, f, (H - 1) / 2], [0.0, 0.0, 1.0]]
    if "extractor" in cfg:
        cfg["extractor"]["max_kp"] = 512
        cfg["engine"]["pnp"]["n_hypotheses"] = 64
        tr.update(frames=frames, batch=8, check_frames=6)
    else:
        cfg["multiscale"].update(min_size=32, max_size=128, top_k=300, per_scale_k=128)
        tr.update(frames=8, batch=4, sample_range=4)
    return w


def context(w: dict, seed: int, device="cpu", seconds: float = 0.5) -> SimpleNamespace:
    import torch

    return SimpleNamespace(config=w["config"], traffic=w["traffic"],
                           device=torch.device(device), seed=seed, seconds=seconds,
                           trace=False, t0=time.perf_counter())


@pytest.fixture
def card():
    """The card, or a skip: decided inside the test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
