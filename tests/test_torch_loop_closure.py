"""The port's loop closure and adaptive refinement (``engine/loop_closure.py``,
``engine/refine.py::refine_full``) against the JAX package's, given identical
features, on the CPU.

The workloads of tests/test_loop_runner.py: a 40-frame full circle (240 x 320, 512
keypoints, the JAX extractor's features handed to both packages) whose odometry drifts
by 0.004 rad and 2 cm per step, the same circle undrifted, a non-revisiting slalom,
and a chain with no loop edge. Tolerances: loop edges (a, b) and inlier counts equal,
the same branch; poses within 5e-3 m / 1e-3 rad (PERF.md section 2).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_refine import assert_poses_close, drifted, features

from vo_tpu.engine import loop_closure as jloop
from vo_tpu.engine import refine as jref
from vo_tpu_torch.ba import PoseGraphConfig
from vo_tpu_torch.engine import loop_closure as tloop
from vo_tpu_torch.engine import refine as tref
from vo_tpu_torch.port_state import config_from_jax
from vo_tpu_torch.utils.synthetic import slalom_trajectory

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
F = 40


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def circle():
    jax_args, port_args, gt = features(F, step=0.8, yaw_rate=2 * np.pi / (F * 0.8))
    noisy = drifted(gt, np.random.default_rng(8214), 0.004, 0.02)
    return jax_args, port_args, gt, noisy


def _edges_equal(got, ref):
    assert [(a, b, n) for a, b, _, n in got] == [(a, b, n) for a, b, _, n in ref]
    for (_, _, Z, _), (_, _, jZ, _) in zip(got, ref):
        assert_poses_close(Z, jZ)


def test_detect_and_close_loops_match_jax(circle):
    jax_args, port_args, gt, noisy = circle
    kfs = np.arange(0, F, 3)
    jcfg = jloop.LoopClosureConfig(min_gap=6, radius=8.0)
    cfg = tloop.LoopClosureConfig(min_gap=6, radius=8.0)
    jedges = jloop.detect_loop_closures(kfs, noisy, *jax_args, K, jcfg)
    edges = tloop.detect_loop_closures(kfs, noisy, *port_args, K, cfg, device="cpu")
    assert len(edges) >= 1 and all(b - a >= cfg.min_gap for a, b, _, _ in edges)
    _edges_equal(edges, jedges)

    jclosed, jinfo = jloop.optimize_with_loops(noisy, kfs, jedges, jcfg)
    closed, info = tloop.optimize_with_loops(noisy, kfs, edges, cfg, device="cpu")
    assert_poses_close(closed, jclosed)
    assert info["n_loop_edges"] == len(edges)
    np.testing.assert_allclose(info["pgo_cost"][:5], jinfo["pgo_cost"][:5], rtol=1e-4)
    e0 = np.linalg.norm(noisy[:, :3, 3] - gt[:, :3, 3], axis=1)
    e1 = np.linalg.norm(closed[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert e1[-1] < 0.5 * e0[-1] and e1.mean() < e0.mean()


@pytest.mark.parametrize("odometry", ["drifted", "exact"])
def test_refine_full_matches_jax(circle, odometry):
    """Drifted: the heading residual exceeds 1 deg, so both take the rotation-only BA
    branch; exact (the ground truth as odometry): both skip BA and close
    isotropically."""
    jax_args, port_args, gt, noisy = circle
    poses = noisy if odometry == "drifted" else gt
    jclosed, jinfo = jref.refine_full(poses, *jax_args, K)
    closed, info = tref.refine_full(poses, *port_args, K, device="cpu")
    assert info["ran_ba"] == jinfo["ran_ba"] == (odometry == "drifted")
    assert info["loop_edges"] == jinfo["loop_edges"] >= 1
    # the median loop residual, in degrees, to the parity limit of 1e-3 rad
    assert info["loop_rot_disc_deg"] == pytest.approx(jinfo["loop_rot_disc_deg"],
                                                      abs=np.degrees(1e-3))
    np.testing.assert_array_equal(info["keyframes"], jinfo["keyframes"])
    assert len(info["ba"]["windows"]) == len(jinfo["ba"]["windows"])
    assert_poses_close(info["refined_odometry"], jinfo["refined_odometry"])
    assert_poses_close(closed, jclosed)
    if odometry == "drifted":
        drift = np.linalg.norm(poses[-1, :3, 3] - gt[-1, :3, 3])
        assert np.linalg.norm(closed[-1, :3, 3] - gt[-1, :3, 3]) < drift


def test_non_revisiting_trajectory_proposes_no_candidates():
    """A slalom never revisits: near-in-space pairs are near along the path too, so
    no candidate is verified, and ``refine_full`` returns the odometry unchanged."""
    poses = slalom_trajectory(200, step=0.5)
    kfs = np.arange(0, 200, 4)
    dummy = (np.zeros((200, 4, 2), np.float32), np.zeros((200, 4, 2), np.float32),
             np.zeros((200, 4), bool), np.zeros((200, 4, 3), np.float32))
    before = tref.verify_row_pairs.pairs
    assert tloop.detect_loop_closures(kfs, poses, *dummy, K, device="cpu") == []
    assert jloop.detect_loop_closures(kfs, poses, *dummy, K) == []
    out, info = tref.refine_full(poses, *dummy, K, device="cpu")
    np.testing.assert_array_equal(out, poses)
    assert info["loop_edges"] == 0 and not info["ran_ba"]
    assert tref.verify_row_pairs.pairs == before


def test_no_loops_is_identity():
    gt = slalom_trajectory(12, step=0.8).astype(np.float32)
    kfs = np.arange(0, 12, 3)
    out, info = tloop.optimize_with_loops(gt, kfs, [], device="cpu")
    jout, _ = jloop.optimize_with_loops(gt, kfs, [], jloop.LoopClosureConfig())
    assert info["n_loop_edges"] == 0
    np.testing.assert_allclose(out, gt, atol=1e-3)
    assert_poses_close(out, jout)


def test_loop_closure_config_from_jax():
    jcfg = jloop.LoopClosureConfig(odo_rot_info=1000.0, min_gap=6)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert isinstance(cfg, tloop.LoopClosureConfig) and isinstance(cfg.pgo, PoseGraphConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
