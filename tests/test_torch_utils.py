"""Port parity: the scene-point tracking and parking-spot utilities
(``utils/tracking.py``, ``utils/parking.py``), the JAX package against the port on
the same inputs, on the CPU. Tolerances: rtol 1e-6 of each array's scale for the
projections (elementwise formulas); the mask scan, the corners and the consensus
mask exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.utils import parking as jpark
from vo_tpu.utils import tracking as jtrack
from vo_tpu_torch.geometry.so3 import so3_exp
from vo_tpu_torch.utils import parking as tpark
from vo_tpu_torch.utils import tracking as ttrack

K = np.array([[300.0, 0.0, 320.0], [0.0, 300.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def _close(got, ref, rtol=1e-6):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


def _trajectory(rng, n=12):
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = so3_exp(torch.from_numpy(rng.normal(0, 0.05, (n, 3)).astype(np.float32))).numpy()
    T[:, 2, 3] = np.arange(n) * 0.8
    T[:, 0, 3] = rng.normal(0, 0.2, n)
    return T


def test_lift_track_distance(rng):
    depth = rng.uniform(2.0, 30.0, (480, 640)).astype(np.float32)
    pix = (412.7, 301.2)
    p_ref = jtrack.lift_point(jnp.asarray(depth), pix, jnp.asarray(K))
    p = ttrack.lift_point(depth, pix, K, device="cpu")
    _close(p, p_ref)
    poses = _trajectory(rng)
    for g, r in zip(ttrack.track_point(p, poses, K),
                    jtrack.track_point(p_ref, jnp.asarray(poses), jnp.asarray(K))):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            _close(g, r)
    _close(ttrack.distance_to_point(p, poses),
           jtrack.distance_to_point(p_ref, jnp.asarray(poses)))


def test_track_point_behind_camera(rng):
    poses = _trajectory(rng)
    point = torch.tensor([0.0, 0.0, -5.0])
    uv, z, vis = ttrack.track_point(point, poses, K)
    ruv, rz, rvis = jtrack.track_point(jnp.asarray(point.numpy()), jnp.asarray(poses),
                                       jnp.asarray(K))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(rvis))
    assert not vis.numpy().any()
    _close(z, rz)


def _road_mask():
    mask = np.zeros((480, 640), np.uint8)
    for x in range(120, 640):
        mask[int(0.05 * x + 150), x] = 255
    for x in range(100, 640):
        mask[int(-0.02 * x + 400), x] = 255
    return mask


@pytest.mark.parametrize("case", ["both lines", "no hit on the top line", "empty mask"])
def test_find_spot_corners(case):
    mask = _road_mask()
    if case == "no hit on the top line":
        mask[:300] = 0
    elif case == "empty mask":
        mask[:] = 0
    lines = ((0.05, 150.0), (-0.02, 400.0))
    ref = jpark.find_spot_corners(jnp.asarray(mask), *lines, spot_width_px=200)
    got = tpark.find_spot_corners(mask, *lines, spot_width_px=200, device="cpu")
    np.testing.assert_array_equal(got.corners.numpy(), np.asarray(ref.corners))
    assert bool(got.found) == bool(ref.found) == (case == "both lines")
    if case == "empty mask":     # no hit: the first column
        np.testing.assert_array_equal(got.corners.numpy()[[0, 3], 0], [0.0, 0.0])


def test_midpoint_world_to_image_fit_line(rng):
    lines = ((0.05, 150.0), (-0.02, 400.0))
    corners = tpark.find_spot_corners(_road_mask(), *lines, device="cpu").corners
    H = np.array([[1.1, 0.02, 3.0], [0.01, 0.9, -2.0], [1e-4, 2e-4, 1.0]], np.float32)
    for g, r in zip(tpark.find_midpoint(corners, H),
                    jpark.find_midpoint(jnp.asarray(corners.numpy()), jnp.asarray(H))):
        _close(g, r, 1e-5)
    pts = rng.uniform(0, 10, (20, 2)).astype(np.float32)
    _close(tpark.world_to_image(H, pts, device="cpu"),
           jpark.world_to_image(jnp.asarray(H), jnp.asarray(pts)))
    x = np.linspace(0, 10, 50, dtype=np.float32)
    line = torch.from_numpy(np.stack([x, 2.0 * x + 1.0], -1))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, 50).astype(np.float32))
    for weights in (None, w):
        got = tpark.fit_line(line, weights)
        ref = jpark.fit_line(jnp.asarray(line.numpy()),
                             None if weights is None else jnp.asarray(weights.numpy()))
        for g, r in zip(got, ref):
            _close(g, r, 1e-5)
    assert float(got[0]) == pytest.approx(2.0, abs=1e-4)


def test_plane_consensus_mask(rng):
    kp = rng.uniform([0, 0], [64, 32], (40, 2)).astype(np.float32)
    inl = rng.uniform(size=40) > 0.4
    got = tpark.plane_consensus_mask((32, 64), kp, inl, radius=3, device="cpu")
    ref = jpark.plane_consensus_mask((32, 64), jnp.asarray(kp), jnp.asarray(inl), radius=3)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
