"""The port's refinement (``vo_tpu_torch.engine.refine``) against the JAX package's,
given identical features, on the CPU.

Features: the JAX extractor's on 12 rendered 240 x 320 frames of a turning drive (512
keypoints; extraction parity is held elsewhere), handed to both packages. The drift
model is tests/test_refine.py's: every relative step perturbed by 0.003 rad and 2 cm.
Tolerances: matches, masks and inlier counts equal; poses within 5e-3 m / 1e-3 rad
(PERF.md section 2); problem arrays equal (poses to fp32 rounding); BA costs rtol 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.engine import refine as jref
from vo_tpu.engine.pipeline import extract_and_backproject
from vo_tpu.features import OrbLikeExtractor
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch.ba import BAConfig
from vo_tpu_torch.engine import refine as tref
from vo_tpu_torch.geometry.se3 import pose_from_rt
from vo_tpu_torch.geometry.so3 import so3_exp
from vo_tpu_torch.port_state import config_from_jax

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
F = 12
JCFG = jref.RefineConfig(window=6, obs_per_pose=192)
TCFG = tref.RefineConfig(window=6, obs_per_pose=192)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def drifted(gt, rng, rot_sigma, trans_sigma):
    """Accumulated drift: each relative step of ``gt`` slightly wrong."""
    noisy = gt.copy()
    for i in range(1, len(gt)):
        rel = np.linalg.inv(gt[i - 1]) @ gt[i]
        dw = torch.from_numpy(rng.normal(0, rot_sigma, 3).astype(np.float32))
        dt = torch.from_numpy(rng.normal(0, trans_sigma, 3).astype(np.float32))
        noisy[i] = noisy[i - 1] @ (rel @ pose_from_rt(so3_exp(dw), dt).numpy())
    return noisy


def features(n_frames, **render):
    """(JAX features, the same as numpy arrays for the port, ground truth)."""
    imgs, deps, gt = render_sequence(n_frames, K, H=240, W=320, **render)
    feats, kp3d = extract_and_backproject(OrbLikeExtractor(max_kp=512), jnp.asarray(imgs),
                                          jnp.asarray(deps), jnp.asarray(K))
    jax_args = (feats.kp, feats.desc, feats.valid, kp3d)
    port_args = (np.asarray(feats.kp), np.asarray(feats.desc, np.float32),
                 np.asarray(feats.valid), np.asarray(kp3d))
    return jax_args, port_args, gt


@pytest.fixture(scope="module")
def drive():
    jax_args, port_args, gt = features(F, step=0.8, yaw_rate=0.01)
    noisy = drifted(gt, np.random.default_rng(8214), 0.003, 0.02)
    return jax_args, port_args, gt, noisy


def assert_poses_close(got, ref, trans_tol=5e-3, rot_tol=1e-3):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got[..., :3, 3] - ref[..., :3, 3]).max() < trans_tol
    rot = np.linalg.norm(got[..., :3, :3] - ref[..., :3, :3], axis=(-2, -1)) / np.sqrt(2)
    assert rot.max() < rot_tol


def _kp3d_valid(port_args):
    _, _, valid, kp3d = port_args
    return valid & (kp3d[..., 2] > 0.1) & (kp3d[..., 2] < 80.0)


@pytest.mark.parametrize("retention", ["all", "sparse"])
def test_select_keyframes_matches_jax(retention):
    rng = np.random.default_rng(41)
    for n in (2, 9, 40, 120):
        promoted = rng.uniform(size=n - 1) < 0.2
        allowed = None
        if retention == "sparse":
            allowed = np.unique(np.concatenate([np.arange(0, n, 4), [n - 1],
                                                np.nonzero(promoted)[0] + 1]))
        got = tref._select_keyframes(promoted, n, allowed=allowed)
        np.testing.assert_array_equal(got, jref._select_keyframes(promoted, n,
                                                                  allowed=allowed))
        assert got[0] == 0 and got[-1] == n - 1
        if allowed is not None:
            assert set(got) <= set(allowed.tolist())


def test_loop_rotation_discrepancy_matches_jax():
    poses = np.stack([np.eye(4)] * 20)
    poses[:, 2, 3] = np.arange(20.0)
    kfs = np.arange(20)
    Z = np.linalg.inv(poses[0]) @ poses[19]
    drift = np.eye(4)
    drift[:3, :3] = so3_exp(torch.tensor([0.0, np.radians(3.0), 0.0])).numpy()
    poses_d = poses.copy()
    poses_d[19] = poses_d[19] @ drift
    for p, edges in ((poses, [(0, 19, Z, 50)]), (poses, []),
                     (poses_d, [(0, 19, Z, 50), (1, 19, Z, 40), (0, 18, Z, 30)])):
        got = tref.loop_rotation_discrepancy_deg(p, kfs, edges)
        assert got == pytest.approx(jref.loop_rotation_discrepancy_deg(p, kfs, edges),
                                    abs=1e-9)
    assert tref.loop_rotation_discrepancy_deg(poses_d, kfs, [(0, 19, Z, 50)]) == \
        pytest.approx(3.0, abs=0.01)


def test_verify_row_pairs_matches_jax(drive):
    jax_args, port_args, _, _ = drive
    kv = _kp3d_valid(port_args)
    ra, rb = np.array([0, 1, 2, 4]), np.array([1, 3, 5, 4])
    ref = jref.verify_row_pairs(ra, rb, *jax_args, kv, K, JCFG)
    before = tref.verify_row_pairs.pairs
    idx, mask, pose, n_in = tref.verify_row_pairs(ra, rb, *port_args, kv, K, TCFG,
                                                  device="cpu")
    assert tref.verify_row_pairs.pairs == before + 4
    np.testing.assert_array_equal(idx, np.asarray(ref[0]))
    np.testing.assert_array_equal(mask, np.asarray(ref[1]))
    np.testing.assert_array_equal(n_in, np.asarray(ref[3]))
    assert (n_in > 100).all()
    assert_poses_close(pose, ref[2])
    # one pair through _pair_match: the same per-pair key
    i1, m1 = tref._pair_match(1, 3, *port_args, kv, K, TCFG, device="cpu")
    np.testing.assert_array_equal(i1, idx[1])
    np.testing.assert_array_equal(m1, mask[1])


def test_problem_builders_match_jax(drive):
    """Given the same verified pairs (JAX's), both builders give equal arrays."""
    jax_args, port_args, _, noisy = drive
    kv = _kp3d_valid(port_args)
    kfs = np.array([0, 3, 6, 9, 11])
    pairs = jref._all_adjacent_pair_matches(kfs, *jax_args, kv, K, JCFG)
    loop = jref._loop_pair_matches(np.array([0]), np.array([9]), *jax_args, kv, K, JCFG)

    def check(got, ref):
        for name in ("points", "obs_lm", "obs_uv", "obs_valid", "K", "obs_z"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)), err_msg=name)
        np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=2e-6)

    window = dict(enumerate(pairs[:3]))
    check(tref._build_window_problem(kfs[:4], noisy, *port_args, kv, K, TCFG,
                                     pairs=window, device="cpu"),
          jref._build_window_problem(kfs[:4], noisy, *jax_args, kv, K, JCFG, pairs=window))
    args = (kfs, noisy)
    tail = (kfs, pairs, [(0, 3)], loop)
    got = tref._build_global_problem(*args, *port_args, kv, K, TCFG, *tail, device="cpu")
    check(got, jref._build_global_problem(*args, *jax_args, kv, K, JCFG, *tail))
    assert got.poses.shape[0] == 32 and got.points.shape[0] == 2048


def test_refine_trajectory_matches_jax(drive):
    jax_args, port_args, gt, noisy = drive
    jposes, jinfo = jref.refine_trajectory(noisy, *jax_args, K, cfg=JCFG)
    poses, info = tref.refine_trajectory(noisy, *port_args, K, cfg=TCFG, device="cpu")
    assert_poses_close(poses, jposes)
    np.testing.assert_array_equal(info["keyframes"], jinfo["keyframes"])
    assert len(info["windows"]) == len(jinfo["windows"]) >= 1
    for w, jw in zip(info["windows"], jinfo["windows"]):
        assert w.keys() == jw.keys() and w["n_obs"] == jw["n_obs"]
        assert w["final_cost"] == pytest.approx(jw["final_cost"], rel=1e-4)
    assert set(info["timing"]) == {"match_s", "ba_s", "host_s"}
    err0 = np.linalg.norm(noisy[:, :3, 3] - gt[:, :3, 3], axis=1)
    err = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert err.mean() < 0.7 * err0.mean() and info["windows"][0]["mean_reproj"] < 2.0


def test_refine_trajectory_global_matches_jax(drive):
    jax_args, port_args, gt, noisy = drive
    jposes, jinfo = jref.refine_trajectory_global(noisy, *jax_args, K, cfg=JCFG)
    poses, info = tref.refine_trajectory_global(noisy, *port_args, K, cfg=TCFG,
                                                device="cpu")
    assert_poses_close(poses, jposes)
    assert not info.get("skipped") and not jinfo.get("skipped")
    assert info["n_obs"] == jinfo["n_obs"] > 100
    assert info["final_cost"] == pytest.approx(jinfo["final_cost"], rel=1e-4)
    assert set(info["timing"]) == {"match_s", "build_s", "ba_s"}
    err0 = np.linalg.norm(noisy[:, :3, 3] - gt[:, :3, 3], axis=1)
    err = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert err.mean() < 0.7 * err0.mean()


def test_refine_trajectory_on_sparse_retention_matches_jax(drive):
    """Features of frames 0, 2, 3, 5, 8 and 11 only (``feat_rows``): the keyframes snap
    to the retained frames, and both packages refine alike."""
    jax_args, port_args, _, noisy = drive
    rows = np.array([0, 2, 3, 5, 8, 11])
    jposes, jinfo = jref.refine_trajectory(noisy, *(a[rows] for a in jax_args), K,
                                           cfg=JCFG, feat_rows=rows)
    poses, info = tref.refine_trajectory(noisy, *(a[rows] for a in port_args), K,
                                         cfg=TCFG, feat_rows=rows, device="cpu")
    np.testing.assert_array_equal(info["keyframes"], jinfo["keyframes"])
    assert set(info["keyframes"]) <= set(rows.tolist())
    assert len(info["windows"]) == len(jinfo["windows"]) >= 1
    assert_poses_close(poses, jposes)


def test_window_without_observations_does_not_raise(drive):
    """No valid feature: every window is empty, and with no damping its reduced
    system is singular. The steps come out non-finite and are rejected (JAX's solve
    behaves so; ``torch.linalg.solve`` would raise), so the trajectory is unchanged."""
    _, (kp, desc, valid, kp3d), _, noisy = drive
    cfg = dataclasses.replace(TCFG, ba=BAConfig(iterations=3, damping_init=0.0))
    poses, info = tref.refine_trajectory(noisy, kp, desc, np.zeros_like(valid), kp3d, K,
                                         cfg=cfg, device="cpu")
    np.testing.assert_allclose(poses, noisy, atol=1e-6)
    assert [w["n_obs"] for w in info["windows"]] == [0.0] * len(info["windows"])


def test_refine_config_from_jax():
    for jcfg in (JCFG, jref.RefineConfig(trans_damp=0.0, anchor_tail=False)):
        cfg = config_from_jax(dataclasses.asdict(jcfg))
        assert isinstance(cfg, tref.RefineConfig) and isinstance(cfg.ba, BAConfig)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
