"""PnP's Gauss-Newton solve around its CUDA kernel, on the CPU: CPU tensors take the
plain version and launch nothing, the kernel's wrapper refuses what the kernel does not
take, and the engine's replay timer reads only the events it was told have completed
(its launches under a CUDA graph capture: tests/test_torch_kernels.py). The kernel
against the plain version runs on the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vo_tpu_torch.engine.vo import ReplayTimer
from vo_tpu_torch.estimation.pnp import PnPConfig, _gn_refine, _gn_refine_plain
from vo_tpu_torch.ops import pnp_gn

CFG = PnPConfig()
SCHEDULES = {"anneal": list(CFG.anneal) + [CFG.reproj_threshold] * 4,
             "refine": None, "long": [8.0, 2.0] + [1.5] * 70, "empty": []}


def _problem(n=256, seed=3):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-10, 10, n), rng.uniform(-2, 2, n), rng.uniform(4, 40, n)], 1)
    Y = X + np.array([0.1, 0.0, 0.5])
    x = 300.0 * Y[:, :2] / Y[:, 2:] + np.array([160.0, 120.0]) + rng.normal(0, 0.3, (n, 2))
    K = np.array([[300.0, 0.0, 160.0], [0.0, 300.0, 120.0], [0.0, 0.0, 1.0]])
    return (torch.eye(4), torch.tensor(X, dtype=torch.float32),
            torch.tensor(x, dtype=torch.float32), torch.from_numpy(rng.uniform(size=n) > 0.2),
            torch.tensor(K, dtype=torch.float32))


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_cpu_tensors_take_the_plain_version_without_launch(schedule):
    pose, X, x_px, valid, K = _problem()
    thr = SCHEDULES[schedule]
    before = pnp_gn.launch_gn.launches
    got = _gn_refine(pose, X, x_px, valid, K, CFG, thresholds=thr)
    want = _gn_refine_plain(pose, X, x_px, valid, K, CFG,
                            [CFG.reproj_threshold] * CFG.gn_iterations if thr is None else thr)
    assert torch.equal(got, want)
    assert pnp_gn.launch_gn.launches == before
    if schedule == "empty":
        assert torch.equal(got, pose)
    else:
        assert (got[:3, 3] - torch.tensor([0.1, 0.0, 0.5])).abs().max() < 0.05


def test_kernel_wrapper_refuses_cpu_tensors():
    before = pnp_gn.launch_gn.launches
    with pytest.raises(ValueError, match="runs on cuda"):
        pnp_gn.launch_gn(*_problem(), [1.5] * 10, CFG.min_depth)
    assert pnp_gn.launch_gn.launches == before


@pytest.mark.parametrize("bad, error", [
    (lambda a: a.__setitem__(1, a[1].double()), TypeError),
    (lambda a: a.__setitem__(2, a[2][:, :1]), ValueError),
    (lambda a: a.__setitem__(3, a[3].to(torch.uint8)), ValueError),
    (lambda a: a.__setitem__(3, a[3][:-1]), ValueError),
    (lambda a: a.__setitem__(0, a[0][:3]), ValueError),
    (lambda a: a.__setitem__(4, a[4].half()), TypeError),
])
def test_kernel_operands_are_checked(bad, error):
    args = list(_problem())
    bad(args)
    with pytest.raises(error):
        pnp_gn._inputs(*args)


def test_operands_made_contiguous():
    pose, X, x_px, valid, K = _problem()
    (p, Xc, xc, vc, Kc), n = pnp_gn._inputs(pose.T.T, X.T.contiguous().T, x_px, valid, K.T.T)
    assert n == X.shape[0] and all(t.is_contiguous() for t in (p, Xc, xc, vc, Kc))
    assert torch.equal(Xc, X)


class _Event:
    """A stand-in for ``torch.cuda.Event``: its record time comes from a counter, and
    reading one that was never recorded fails."""

    clock = [0.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self):
        _Event.clock[0] += 1.5
        self.t = _Event.clock[0]

    def elapsed_time(self, end):
        assert self.t is not None and end.t is not None
        return end.t - self.t


def test_replay_timer_reads_only_what_the_mark_covers(monkeypatch):
    """``read(mark)`` sums the replays recorded before the mark and drops their events;
    later replays wait for a later mark; nothing is read twice."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    timer = ReplayTimer()
    ran = []
    for i in range(3):
        timer.record(lambda i=i: ran.append(i))
    mark = timer.mark()
    timer.record(lambda: ran.append(3))
    timer.read(mark)
    assert ran == [0, 1, 2, 3] and timer.seconds == pytest.approx(3 * 1.5e-3)
    assert len(timer._events) == 1
    timer.read(mark)
    assert timer.seconds == pytest.approx(3 * 1.5e-3)
    timer.read(timer.mark())
    assert timer.seconds == pytest.approx(4 * 1.5e-3) and not timer._events
