"""PnP's hypothesis bank around its CUDA kernel, on the CPU: CPU tensors take the plain
bank, which records its spans and launches nothing, and the kernel's wrapper refuses
what the kernel does not take. The kernel against the plain bank runs on the card
(tests/test_torch_cuda.py); the benchmark's reader of its share is tested in
benchmark/tests/test_bank_counter.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vo_tpu_torch import prng
from vo_tpu_torch.estimation.pnp import (PnPConfig, _bank, _bank_plain, _hypotheses,
                                         _reproject_residuals, pnp_ransac)
from vo_tpu_torch.ops import pnp_bank
from vo_tpu_torch.utils import profiling

CFG = PnPConfig(n_hypotheses=128)


def _problem(n=300, seed=7, depth=True):
    """Keyframe points, their pixels under a small motion (0.3 px noise, 30 % gross
    outliers), masks and the current frame's points; K of a 320 x 240 camera."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n), rng.uniform(4, 40, n)], 1)
    Y = X + np.array([0.1, -0.05, -0.6])
    K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]])
    x = 260.0 * Y[:, :2] / Y[:, 2:] + K[:2, 2] + rng.normal(0, 0.3, (n, 2))
    out = rng.uniform(size=n) < 0.3
    x[out] += rng.uniform(-60, 60, (int(out.sum()), 2))
    f32 = (lambda a: torch.tensor(a, dtype=torch.float32))
    cur = (f32(Y + rng.normal(0, 0.02, Y.shape)), torch.from_numpy(rng.uniform(size=n) > 0.2))
    return (prng.fold_in(prng.key(8214), 5), f32(X), f32(x),
            torch.from_numpy(rng.uniform(size=n) > 0.1), f32(K),
            *(cur if depth else (None, None)))


@pytest.mark.parametrize("depth", [True, False], ids=["kabsch_and_dlt", "dlt_only"])
@pytest.mark.parametrize("n_hyp", [128, 256])
def test_cpu_tensors_take_the_plain_bank_without_launch(depth, n_hyp):
    """``_bank`` on CPU tensors is ``_bank_plain``, which is the bank as ``pnp_ransac``
    scored it before the kernel: the first hypothesis with the most inliers."""
    key, X, x, valid, K, Xc, vc = _problem(depth=depth)
    cfg = PnPConfig(n_hypotheses=n_hyp, sample_size=6 if depth else 8)
    before = pnp_bank.launch_bank.launches
    got = _bank(key, X, x, valid, K, cfg, Xc, vc)
    assert pnp_bank.launch_bank.launches == before
    for a, b in zip(got, _bank_plain(key, X, x, valid, K, cfg, Xc, vc)):
        assert torch.equal(a, b)
    hyp = _hypotheses(key, X, x, valid, K, cfg, Xc, vc)
    res, z = _reproject_residuals(hyp, X, x, K)
    inl = (res < cfg.reproj_threshold) & (z > cfg.min_depth) & valid
    counts = inl.sum(-1)
    best = int(torch.nonzero(counts == counts.max())[0])
    pose, count, mask = got
    assert torch.equal(pose, hyp[best]) and torch.equal(mask, inl[best])
    assert count.dtype == torch.int64 and int(count) == int(counts.max())
    if depth:      # the Kabsch bank finds the motion's inliers, ~0.9 x 0.7 x 300
        assert int(count) > 120


def test_cpu_pnp_ransac_records_the_bank_spans():
    key, X, x, valid, K, Xc, vc = _problem()
    profiling.start()
    try:
        res = pnp_ransac(key, X, x, valid, K, CFG, points_3d_cur=Xc, valid_cur=vc)
    finally:
        spans = profiling.stop()
    names = [s.name for s in spans]
    for name in ("pnp.ransac", "pnp.hypotheses", "pnp.score", "pnp.anneal", "pnp.refine"):
        assert names.count(name) == 1, names
    assert bool(res.ok)
    assert (res.pose[:3, 3] - torch.tensor([0.1, -0.05, -0.6])).abs().max() < 0.05


def test_kernel_wrapper_refuses_cpu_tensors():
    key, X, x, valid, K, Xc, vc = _problem()
    before = pnp_bank.launch_bank.launches
    with pytest.raises(ValueError, match="runs on cuda"):
        pnp_bank.launch_bank(key, X, x, valid, K, 512, 6, 1.5, 1e-3, Xc, vc)
    assert pnp_bank.launch_bank.launches == before


@pytest.mark.parametrize("kwargs, match", [
    (dict(m=5), "sample sizes 6-16"),
    (dict(m=17), "sample sizes 6-16"),
    (dict(n_hyp=0), "at least one hypothesis"),
    (dict(X_cur=None), "valid_cur without X_cur"),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(kwargs, match):
    key, X, x, valid, K, Xc, vc = _problem()
    args = dict(n_hyp=512, m=6, thr=1.5, min_depth=1e-3, X_cur=Xc, valid_cur=vc)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        pnp_bank.launch_bank(key, X, x, valid, K, **args)


@pytest.mark.parametrize("bad, error", [
    (lambda a: a.__setitem__(1, a[1].double()), TypeError),
    (lambda a: a.__setitem__(2, a[2][:, :1]), ValueError),
    (lambda a: a.__setitem__(3, a[3].to(torch.uint8)), ValueError),
    (lambda a: a.__setitem__(3, a[3][:-1]), ValueError),
    (lambda a: a.__setitem__(4, a[4].half()), TypeError),
    (lambda a: a.__setitem__(5, a[5][:, :2]), ValueError),
    (lambda a: a.__setitem__(6, a[6][1:]), ValueError),
    (lambda a: a.__setitem__(0, a[0].to(torch.int32)), ValueError),
    (lambda a: a.__setitem__(0, a[0][:1]), ValueError),
    (lambda a: a.__setitem__(1, a[1][:0]), ValueError),
])
def test_kernel_operands_are_checked(bad, error):
    args = list(_problem())
    bad(args)
    with pytest.raises(error):
        pnp_bank._inputs(*args)


def test_operands_made_contiguous_and_optional_depth_kept_absent():
    key, X, x, valid, K, Xc, vc = _problem()
    (k, Xo, xo, vo, Ko, Xco, vco), n = pnp_bank._inputs(key, X.T.contiguous().T, x, valid,
                                                        K.T.T, Xc, vc)
    assert n == X.shape[0] and all(t.is_contiguous() for t in (k, Xo, xo, vo, Ko, Xco, vco))
    assert torch.equal(Xo, X)
    _, X2, _, _, _, Xc2, vc2 = _problem(depth=False)
    out, _ = pnp_bank._inputs(key, X2, x, valid, K, Xc2, vc2)
    assert out[5] is None and out[6] is None
