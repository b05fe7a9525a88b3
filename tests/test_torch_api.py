"""Port parity: the public functions of the ported modules that the main path does not
call (camera model, SE(3) helpers, image ops, ``matches_to_pairs``,
``native_available``) and the subpackage re-exports, the JAX package against the port
on the same seeded numpy inputs, on the CPU.

Tolerances and their reasons:
- elementwise formulas (projection, normalisation, distortion, visibility, dense
  back-projection, pose composition, point transforms, the box filter): 1e-6 relative
  (XLA's jitted CPU code contracts multiply-adds; the port's eager ops do not).
- ``chain_relative_poses``: 1e-5 (the prefix products are grouped in another order
  than ``lax.associative_scan``'s; 32 products of rotations).
- ``undistort_points``: 1e-4 px (8 fixed-point iterations of the above).
- ``avgpool2d``: 1e-6 relative (window sums in another order).
- ``bilinear_sample``, ``matches_to_pairs``, the masks: exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.geometry import camera as jcam
from vo_tpu.geometry import se3 as jse3
from vo_tpu.matching import matchers as jmatch
from vo_tpu.ops import image as jimg
from vo_tpu_torch.geometry import camera as tcam
from vo_tpu_torch.geometry import se3 as tse3
from vo_tpu_torch.geometry.so3 import so3_exp
from vo_tpu_torch.matching import matchers as tmatch
from vo_tpu_torch.ops import image as timg

K = np.array([[500.0, 0.0, 320.0], [0.0, 480.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
Kj, Kt = jnp.asarray(K), torch.from_numpy(K)


def _close(got, ref, rtol=1e-6, atol=0.0):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol or rtol * max(np.abs(ref).max(), 1e-30))


def _poses(rng, n):
    w = torch.from_numpy(rng.normal(0, 0.3, (n, 3)).astype(np.float32))
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = so3_exp(w).numpy()
    T[:, :3, 3] = rng.normal(0, 2.0, (n, 3))
    return T


# Every name the JAX package's subpackage __init__ re-exports.
EXPORTS = {
    "geometry": ["hat", "vee", "so3_exp", "so3_log", "rodrigues", "inv_rodrigues",
                 "se3_exp", "se3_log", "pose_from_rt", "pose_inverse", "pose_compose",
                 "transform_points", "chain_relative_poses", "identity_pose",
                 "PinholeCamera", "project", "unproject", "normalize_kp",
                 "depth_to_3d_at", "depth_to_3d", "triangulate", "umeyama_alignment"],
    "ops": ["rgb_to_gray", "gaussian_blur", "sobel_gradients", "box_filter",
            "maxpool2d_same", "avgpool2d", "bilinear_sample"],
    "matching": ["similarity_matrix", "mutual_nn_match", "ratio_mutual_nn_match",
                 "ratio_match", "MatchResult", "matches_to_pairs"],
    "features": ["harris_response", "shi_tomasi_response", "detect_keypoints",
                 "oriented_brief_descriptors", "brief_offsets", "OrbLikeExtractor",
                 "Features"],
    "estimation": ["PnPConfig", "PnPResult", "pnp_ransac", "kabsch", "EssentialConfig",
                   "EssentialResult", "essential_ransac", "relative_scale"],
}
LATER: dict = {}


@pytest.mark.parametrize("sub", sorted(EXPORTS))
def test_subpackage_exports(sub):
    """Each subpackage re-exports what the JAX package's does, and importing it builds
    no kernel."""
    from vo_tpu_torch.ops import match

    jmod = importlib.import_module(f"vo_tpu.{sub}")
    tmod = importlib.import_module(f"vo_tpu_torch.{sub}")
    jnames = {n for n in vars(jmod) if not n.startswith("_")
              and not isinstance(getattr(jmod, n), type(importlib))}
    assert jnames - LATER.get(sub, set()) <= set(EXPORTS[sub]) | {"annotations"}
    for name in EXPORTS[sub]:
        assert name in jnames, name
        assert getattr(tmod, name).__module__.startswith("vo_tpu_torch."), name
    assert match._lib is None


def test_project_normalize_unproject(rng):
    pts = np.concatenate([rng.uniform([-5, -3, 1], [5, 3, 40], (64, 3)),
                          [[1.0, 2.0, 0.0], [1.0, 2.0, -3.0]]]).astype(np.float32)
    (juv, jz), (tuv, tz) = jcam.project(jnp.asarray(pts), Kj), tcam.project(
        torch.from_numpy(pts), Kt)
    _close(tuv.numpy()[:-2], np.asarray(juv)[:-2])
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert np.isfinite(tuv.numpy()).all()
    kp = rng.uniform([0, 0], [640, 480], (3, 50, 2)).astype(np.float32)
    _close(tcam.normalize_kp(torch.from_numpy(kp), Kt).numpy(),
           jcam.normalize_kp(jnp.asarray(kp), Kj))
    back = tcam.unproject(tuv, tz, Kt).numpy()
    _close(back[:-2], pts[:-2], rtol=1e-5)


def test_depth_to_3d(rng):
    depth = rng.uniform(0.5, 30.0, (24, 32)).astype(np.float32)
    got = tcam.depth_to_3d(torch.from_numpy(depth), Kt).numpy()
    assert got.shape == (24, 32, 3)
    _close(got, jcam.depth_to_3d(jnp.asarray(depth), Kj))


def test_pinhole_camera():
    jc, tc = jcam.PinholeCamera.from_K(Kj), tcam.PinholeCamera.from_K(K)
    np.testing.assert_array_equal(tc.K.numpy(), np.asarray(jc.K))
    assert float(tc.fy) == float(jc.fy) == 480.0


def test_distortion_round_trip_and_parity(rng):
    coeffs = [-0.28, 0.07, 1e-4, -2e-4, 0.01]
    jd, td = jcam.Distortion.from_coeffs(coeffs), tcam.Distortion.from_coeffs(coeffs)
    kp = rng.uniform([80, 60], [560, 420], (200, 2)).astype(np.float32)
    jkd = jcam.distort_points(jnp.asarray(kp), Kj, jd)
    tkd = tcam.distort_points(torch.from_numpy(kp), Kt, td)
    _close(tkd.numpy(), jkd)
    xy = torch.from_numpy(rng.uniform(-0.5, 0.5, (50, 2)).astype(np.float32))
    _close(tcam.distort_normalized(xy, td).numpy(),
           jcam.distort_normalized(jnp.asarray(xy.numpy()), jd), rtol=1e-6, atol=1e-6)
    _close(tcam.undistort_normalized(xy, td, iters=5).numpy(),
           jcam.undistort_normalized(jnp.asarray(xy.numpy()), jd, iters=5), atol=1e-5)
    tku = tcam.undistort_points(tkd, Kt, td)
    _close(tku.numpy(), jcam.undistort_points(jkd, Kj, jd), atol=1e-4)
    np.testing.assert_allclose(tku.numpy(), kp, atol=5e-2)    # test_aux_utils.py's bar
    assert bool(tcam.Distortion.from_coeffs([0.0]).is_zero) and not bool(td.is_zero)
    assert tcam.Distortion.from_coeffs([0.1, 0.2]).k3 == 0.0


def test_visibility(rng):
    pts = np.array([[0.0, 0.0, 5.0], [0.0, 0.0, -5.0], [10.0, 0.0, 5.0],
                    [0.0, 0.0, 100.0]], np.float32)
    pts = np.concatenate([pts, rng.uniform([-20, -20, -5], [20, 20, 80], (200, 3))
                          .astype(np.float32)])
    for kw in ({}, {"z_near": 1.0, "z_far": 50.0}):
        got = tcam.are_visible(torch.from_numpy(pts), Kt, 640, 480, **kw).numpy()
        np.testing.assert_array_equal(got, np.asarray(jcam.are_visible(
            jnp.asarray(pts), Kj, 640, 480, **kw)))
    assert got[:4].tolist() == [True, False, False, False]
    uv = rng.uniform(-20, 660, (300, 2)).astype(np.float32)
    for margin in (0.0, 10.0):
        np.testing.assert_array_equal(
            tcam.is_in_frame(torch.from_numpy(uv), 640, 480, margin).numpy(),
            np.asarray(jcam.is_in_frame(jnp.asarray(uv), 640, 480, margin)))


def test_se3_helpers(rng):
    A, B = _poses(rng, 5), _poses(rng, 5)
    np.testing.assert_array_equal(tse3.identity_pose().numpy(), np.asarray(jse3.identity_pose()))
    assert tse3.identity_pose(torch.float64).dtype == torch.float64
    _close(tse3.pose_compose(torch.from_numpy(A), torch.from_numpy(B)).numpy(),
           jse3.pose_compose(jnp.asarray(A), jnp.asarray(B)))
    pts = rng.normal(0, 5, (5, 30, 3)).astype(np.float32)
    _close(tse3.transform_points(torch.from_numpy(pts), torch.from_numpy(A)).numpy(),
           jse3.transform_points(jnp.asarray(pts), jnp.asarray(A)), atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 7, 32])
def test_chain_relative_poses(rng, n):
    rel = _poses(rng, n)
    rel[:, :3, 3] *= 0.1
    init = _poses(rng, 1)[0]
    for kw in ({}, {"initial": init}):
        got = tse3.chain_relative_poses(torch.from_numpy(rel),
                                        **{k: torch.from_numpy(v) for k, v in kw.items()})
        ref = jse3.chain_relative_poses(jnp.asarray(rel),
                                        **{k: jnp.asarray(v) for k, v in kw.items()})
        _close(got.numpy(), ref, atol=1e-5)


def test_box_filter_avgpool_bilinear(rng):
    img = rng.uniform(0, 255, (2, 37, 50)).astype(np.float32)
    for size in (3, 5):
        _close(timg.box_filter(torch.from_numpy(img), size).numpy(),
               jimg.box_filter(jnp.asarray(img), size))
    for size in (2, 4):
        got = timg.avgpool2d(torch.from_numpy(img), size).numpy()
        assert got.shape == (2, 37 // size, 50 // size)
        _close(got, jimg.avgpool2d(jnp.asarray(img), size))
    xy = rng.uniform(-3, 53, (2, 100, 2)).astype(np.float32)
    xy[0, :4] = [[0, 0], [49, 36], [10.5, 7.25], [60, -5]]
    for f in range(2):
        np.testing.assert_array_equal(
            timg.bilinear_sample(torch.from_numpy(img[f]), torch.from_numpy(xy[f])).numpy(),
            np.asarray(jimg.bilinear_sample(jnp.asarray(img[f]), jnp.asarray(xy[f]))))


def test_matches_to_pairs(rng):
    a = np.sign(rng.normal(size=(60, 64))).astype(np.float32)
    b = np.concatenate([a[:40], np.sign(rng.normal(size=(30, 64)))]).astype(np.float32)
    j = jmatch.ratio_match(jnp.asarray(a), jnp.asarray(b), binary_dim=64)
    t = tmatch.ratio_match(torch.from_numpy(a), torch.from_numpy(b), binary_dim=64)
    pairs = tmatch.matches_to_pairs(t)
    np.testing.assert_array_equal(pairs, jmatch.matches_to_pairs(j))
    assert ((pairs[:, 0] == pairs[:, 1]) & (pairs[:, 0] < 40)).sum() == 40
    none = tmatch.MatchResult(torch.zeros(3, dtype=torch.int64), torch.zeros(3, dtype=torch.bool),
                              torch.zeros(3))
    assert tmatch.matches_to_pairs(none).shape == (0, 2)


def test_native_available():
    from vo_tpu.io.native import native_available as jnative
    from vo_tpu_torch.io.native import native_available

    assert native_available() is True       # the port builds the loader here (g++)
    assert isinstance(jnative(), bool)
