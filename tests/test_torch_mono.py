"""Port parity: the monocular slice (triangulation, Umeyama, homographies, the
essential-matrix RANSAC, the metric scale and the mono engine), the JAX package
against the port on the same seeded numpy inputs, on the CPU.

Tolerances and their reasons (measured on the CPU; ROADMAP §3 records the
differences):
- ``umeyama_alignment``, ``relative_scale``: rtol 1e-4 of each array's scale (SVDs
  and sums in another order). ``triangulate``: rtol 1e-3 per coordinate (a far
  point's 4x4 fp32 SVD leaves both packages up to 3.6e-4 / 7.6e-4 from float64).
- Homographies: the DLT's 9x9 fp32 ``eigh`` leaves both packages 3-6e-4 from the
  float64 solution in H's translation entries, so H is held within 1e-3 of JAX's
  (the mapped points within 1e-3 px), not rtol 1e-4; RANSAC inliers are equal.
- The essential bank: the IRLS fits on clean 48-point samples within 1e-3 (both
  packages are ~2e-4 from float64); the Jacobian of the Sampson residual rtol 1e-4;
  one Gauss-Newton step from the same start 1e-5, fifteen 1e-3.
- ``essential_ransac``: the final polish resolves the weak (bas-relief) direction
  only to fp32's noise floor; JAX's own poses scatter up to 0.018 rad from the truth
  across keys on a clean set. On the clean set inliers, ``ok`` and the cheirality
  choice are equal, the translation direction within 1e-3, the rotation within
  0.02 rad; on the outlier-heavy set both packages are held to tests/
  test_essential.py's limits (which basin a key lands in is decided by fp32 rounding
  in the noise-limited hypothesis bank, in both packages).

The mono engine itself is held in tests/test_torch_mono_engine.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.estimation import essential as je
from vo_tpu.estimation import homography as jh
from vo_tpu.geometry.triangulation import triangulate as jtriangulate
from vo_tpu.geometry.umeyama import umeyama_alignment as jumeyama
from vo_tpu_torch import prng
from vo_tpu_torch.estimation import essential as te
from vo_tpu_torch.estimation import homography as th
from vo_tpu_torch.geometry.so3 import so3_exp
from vo_tpu_torch.geometry.triangulation import triangulate
from vo_tpu_torch.geometry.umeyama import umeyama_alignment

K2 = np.array([[700.0, 0.0, 320.0], [0.0, 700.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


def _angle(Ra, Rb):
    R = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def _pose(rot, trans):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = so3_exp(torch.tensor(rot, dtype=torch.float32)).numpy()
    T[:3, 3] = trans
    return T


def _project(X):
    return (X[:, :2] / X[:, 2:3] * K2[[0, 1], [0, 1]] + K2[:2, 2]).astype(np.float32)


def two_view_scene(rng, n=400, rot=(0.01, 0.05, 0.0), trans=(0.6, 0.05, 0.3),
                   outlier_frac=0.3, noise_px=0.3):
    """tests/test_essential.py's scene: points 5-40 m ahead, noise, gross outliers."""
    X = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n),
                  rng.uniform(5, 40, n)], -1).astype(np.float32)
    T = _pose(rot, trans)
    uv1 = _project(X) + rng.normal(0, noise_px, (n, 2))
    uv2 = _project(X @ T[:3, :3].T + T[:3, 3]) + rng.normal(0, noise_px, (n, 2))
    out = rng.choice(n, int(outlier_frac * n), replace=False)
    uv2[out] += rng.uniform(20, 120, (len(out), 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), np.ones(n, bool), T, out


def test_triangulate(rng):
    n = 300
    X = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n),
                  rng.uniform(5, 40, n)], -1).astype(np.float32)
    T1, T2 = _pose([0.0, 0.02, 0.0], [0.1, 0.0, 0.0]), _pose([0.01, 0.05, 0.0],
                                                            [0.6, 0.05, 0.3])
    kp1 = _project(X @ T1[:3, :3].T + T1[:3, 3]) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    kp2 = _project(X @ T2[:3, :3].T + T2[:3, 3]) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    ref = jtriangulate(*(jnp.asarray(a) for a in (kp1, kp2, T1, T2, K2)))
    got = triangulate(kp1, kp2, T1, T2, K2, device="cpu")
    for g, r in zip(got, ref):
        assert g.shape == (n, 3) and g.dtype == torch.float32
        # The far points' 4x4 fp32 SVDs: both packages are up to 3.6e-4 (JAX) and
        # 7.6e-4 (port) of a coordinate from the float64 solution.
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-4 * np.abs(np.asarray(r)).max())


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama(rng, with_scale):
    x = rng.normal(size=(3, 50)).astype(np.float32)
    R = so3_exp(torch.tensor([0.3, -0.2, 0.5])).numpy()
    y = (2.5 * R @ x + np.array([[1.0], [2.0], [-3.0]], np.float32)
         + rng.normal(0, 0.01, (3, 50)).astype(np.float32))
    ref = jumeyama(jnp.asarray(x), jnp.asarray(y), with_scale)
    got = umeyama_alignment(x, y, with_scale, device="cpu")
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)
    assert float(got[2]) == (pytest.approx(2.5, abs=1e-2) if with_scale else 1.0)


def _rand_h(rng):
    H = np.eye(3) + rng.normal(0, 0.1, (3, 3))
    H[2, :2] = rng.normal(0, 1e-4, 2)
    return (H / H[2, 2]).astype(np.float32)


def test_apply_and_normalize(rng):
    Hs = np.stack([_rand_h(rng) for _ in range(3)])
    pts = rng.uniform(0, 640, (3, 20, 2)).astype(np.float32)
    _close(th.apply_homography(torch.from_numpy(Hs), torch.from_numpy(pts)),
           jh.apply_homography(jnp.asarray(Hs), jnp.asarray(pts)), 1e-6)
    w = rng.uniform(0.0, 1.0, (3, 20)).astype(np.float32)
    for g, r in zip(th._normalize_pts(torch.from_numpy(pts), torch.from_numpy(w)),
                    jh._normalize_pts(jnp.asarray(pts), jnp.asarray(w))):
        _close(g, r, 1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_homography_dlt_batched(rng, weighted):
    Hs = np.stack([_rand_h(rng) for _ in range(5)])
    src = rng.uniform(0, 640, (5, 16, 2)).astype(np.float32)
    dst = np.asarray(jh.apply_homography(jnp.asarray(Hs), jnp.asarray(src)))
    dst = dst + rng.normal(0, 0.5, dst.shape).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (5, 16)).astype(np.float32) if weighted else None
    ref = np.asarray(jh.homography_dlt(jnp.asarray(src), jnp.asarray(dst),
                                       None if w is None else jnp.asarray(w)))
    got = th.homography_dlt(torch.from_numpy(src), torch.from_numpy(dst),
                            None if w is None else torch.from_numpy(w))
    assert got.shape == (5, 3, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)
    mapped = th.apply_homography(got, torch.from_numpy(src)).numpy()
    np.testing.assert_allclose(mapped, np.asarray(jh.apply_homography(
        jnp.asarray(ref), jnp.asarray(src))), rtol=0, atol=1e-3)


@pytest.mark.parametrize("key", [0, 3])
def test_homography_ransac(rng, key):
    H = _rand_h(rng)
    N = 200
    src = rng.uniform(50, 600, (N, 2)).astype(np.float32)
    dst = np.array(jh.apply_homography(jnp.asarray(H), jnp.asarray(src)))
    out = rng.random(N) < 0.35
    dst[out] += rng.uniform(20, 100, (out.sum(), 2))
    valid = rng.random(N) > 0.05
    ref = jh.homography_ransac(jax.random.key(key), jnp.asarray(src), jnp.asarray(dst),
                               jnp.asarray(valid), jh.HomographyConfig())
    got = th.homography_ransac(prng.key(key), src, dst, valid, device="cpu")
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) and bool(got.ok) == bool(ref.ok)
    assert got.n_inliers.dtype == torch.int32
    np.testing.assert_allclose(got.H.numpy(), np.asarray(ref.H), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.H.numpy(), H, rtol=0, atol=1e-3)
    inl = got.inliers.numpy()
    assert (inl & out).sum() <= 3 and inl[~out & valid].mean() > 0.9


def test_plane_helpers(rng):
    K = np.array([[300.0, 0.0, 320.0], [0.0, 300.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
    n, d = np.array([0.0, 1.0, 0.0], np.float32), 1.5
    kp = rng.uniform([200, 260], [440, 420], (64, 2)).astype(np.float32)
    Kt, nt, kpt = (torch.from_numpy(a) for a in (K, n, kp))
    _close(th.plane_induced_depth(kpt, Kt, nt, d),
           jh.plane_induced_depth(jnp.asarray(kp), jnp.asarray(K), jnp.asarray(n), d), 1e-6)
    R = so3_exp(torch.tensor([0.02, -0.03, 0.01]))
    t = torch.tensor([0.2, 0.0, 0.4])
    Hp = th.homography_from_plane(Kt, R, t, nt, d)
    _close(Hp, jh.homography_from_plane(jnp.asarray(K), jnp.asarray(R.numpy()),
                                        jnp.asarray(t.numpy()), jnp.asarray(n), d), 1e-6)
    _close(th.plane_depth_reference_convention(Hp, kpt),
           jh.plane_depth_reference_convention(jnp.asarray(Hp.numpy()), jnp.asarray(kp)), 1e-5)
    z = th.plane_depth_reference_convention(torch.diag(torch.tensor([0.01, 1.0, 1.0])),
                                            torch.tensor([[7.0, 3.0], [12.5, 9.0]]))
    np.testing.assert_allclose(z.numpy(), [7.0, 12.5], atol=1e-6)


def _normalised(uv):
    return np.stack([(uv[:, 0] - K2[0, 2]) / K2[0, 0],
                     (uv[:, 1] - K2[1, 2]) / K2[1, 1]], -1).astype(np.float32)


def test_essential_design_sampson_midpoint(rng):
    uv1, uv2, valid, T, _ = two_view_scene(rng, n=64, outlier_frac=0.2)
    x1, x2 = _normalised(uv1), _normalised(uv2)
    np.testing.assert_array_equal(
        te._epipolar_design(torch.from_numpy(x1), torch.from_numpy(x2)).numpy(),
        np.asarray(je._epipolar_design(jnp.asarray(x1), jnp.asarray(x2))))
    E = rng.normal(size=(5, 3, 3)).astype(np.float32)
    _close(te._sampson_dist(torch.from_numpy(E), torch.from_numpy(x1), torch.from_numpy(x2)),
           je._sampson_dist(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2)), 1e-5)
    R, t = T[:3, :3], T[:3, 3] / np.linalg.norm(T[:3, 3])
    for g, r in zip(te._midpoint_depths(torch.from_numpy(R), torch.from_numpy(t),
                                        torch.from_numpy(x1), torch.from_numpy(x2)),
                    je._midpoint_depths(jnp.asarray(R), jnp.asarray(t), jnp.asarray(x1),
                                        jnp.asarray(x2))):
        _close(g, r, 1e-5)


def test_irls_essential_bank(rng):
    """The hypothesis bank, batched over 16 clean noisy 48-point samples (the JAX
    package vmaps one sample)."""
    n = 48 * 16
    X = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n),
                  rng.uniform(5, 40, n)], -1).astype(np.float32)
    T = _pose([0.01, 0.05, 0.0], [1.2, 0.1, 0.6])
    X2 = X @ T[:3, :3].T + T[:3, 3]
    x1 = (X[:, :2] / X[:, 2:] + rng.normal(0, 0.3 / 700, (n, 2))).astype(np.float32)
    x2 = (X2[:, :2] / X2[:, 2:] + rng.normal(0, 0.3 / 700, (n, 2))).astype(np.float32)
    x1, x2 = x1.reshape(16, 48, 2), x2.reshape(16, 48, 2)
    ref = np.asarray(jax.jit(jax.vmap(lambda a, b: je._irls_essential(a, b, 4, 2e-6)))(
        jnp.asarray(x1), jnp.asarray(x2)))
    got = te._irls_essential(torch.from_numpy(x1), torch.from_numpy(x2), 4, 2e-6).numpy()
    gap = np.minimum(np.abs(got - ref).max((1, 2)), np.abs(got + ref).max((1, 2)))
    assert gap.max() < 1e-3, gap
    # The fits are essential matrices: singular values (s, s, 0).
    s = np.linalg.svd(got.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s[:, 0], s[:, 1], rtol=1e-4)
    assert (s[:, 2] < 1e-5 * s[:, 0]).all()


def _polish_inputs(rng):
    uv1, uv2, valid, T, _ = two_view_scene(rng, trans=(1.2, 0.1, 0.6), outlier_frac=0.2)
    x1, x2 = _normalised(uv1), _normalised(uv2)
    R0 = _pose([0.015, 0.045, 0.004], [0, 0, 0])[:3, :3]
    t0 = T[:3, 3] + np.array([0.05, -0.03, 0.02], np.float32)
    return x1, x2, R0, (t0 / np.linalg.norm(t0)).astype(np.float32)


def test_sampson_jacobian(rng):
    """The analytic Jacobian of the signed Sampson residual against jax.jacfwd of the
    JAX package's residual."""
    x1, x2, R0, t0 = _polish_inputs(rng)
    p1, p2 = (np.concatenate([x, np.ones_like(x[:, :1])], -1) for x in (x1, x2))
    B = te._tangent_basis(torch.from_numpy(t0)[None])[0].numpy()

    def jres(params):
        Rn = je.so3_exp(params[:3]) @ R0
        tn = t0 + B @ params[3:]
        tn = tn / jnp.linalg.norm(tn)
        E = je.hat(tn) @ Rn
        Ex1, Etx2 = p1 @ E.T, p2 @ E
        den = jnp.sqrt(jnp.clip(Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2
                                + Etx2[:, 1] ** 2, 1e-12))
        return jnp.sum(p2 * Ex1, axis=-1) / den

    J_ref = np.asarray(jax.jit(jax.jacfwd(jres))(jnp.zeros(5)))
    r, J = te._residual_and_jacobian(*(torch.from_numpy(a)[None] for a in (R0, t0, B)),
                                     torch.from_numpy(p1), torch.from_numpy(p2))
    assert J.shape == (1, 400, 5)
    _close(J[0], J_ref, 1e-4)
    _close(r[0], jres(jnp.zeros(5)), 1e-5)


@pytest.mark.parametrize("iters,tol", [(1, 1e-5), (15, 1e-3)])
def test_refine_pose_sampson(rng, iters, tol):
    x1, x2, R0, t0 = _polish_inputs(rng)
    w = (rng.uniform(size=len(x1)) > 0.1).astype(np.float32)
    Rj, tj = je._refine_pose_sampson(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(x1),
                                     jnp.asarray(x2), jnp.asarray(w), sigma2=2e-6,
                                     iters=iters)
    Rt, tt = te._refine_pose_sampson(torch.from_numpy(R0)[None], torch.from_numpy(t0)[None],
                                     torch.from_numpy(x1), torch.from_numpy(x2),
                                     torch.from_numpy(w), sigma2=2e-6, iters=iters)
    np.testing.assert_allclose(Rt[0].numpy(), np.asarray(Rj), rtol=0, atol=tol)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj), rtol=0, atol=tol)


@pytest.mark.parametrize("key", [0, 1, 2, 3])
def test_essential_ransac_clean(rng, key):
    uv1, uv2, valid, T_true, _ = two_view_scene(rng, trans=(1.2, 0.1, 0.6),
                                                outlier_frac=0.0)
    ref = je.essential_ransac(jax.random.key(key), jnp.asarray(uv1), jnp.asarray(uv2),
                              jnp.asarray(valid), jnp.asarray(K2))
    got = te.essential_ransac(prng.key(key), uv1, uv2, valid, K2, device="cpu")
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) and bool(got.ok) == bool(ref.ok)
    Tj, Tt = np.asarray(ref.pose), got.pose.numpy()
    assert np.dot(Tj[:3, 3], Tt[:3, 3]) > 1.0 - 1e-6      # same cheirality choice
    np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], rtol=0, atol=1e-3)
    assert _angle(Tj[:3, :3], Tt[:3, :3]) < 0.02
    assert _angle(T_true[:3, :3], Tt[:3, :3]) < 0.02
    np.testing.assert_allclose(got.E.numpy(), np.asarray(ref.E), rtol=0, atol=2e-2)


@pytest.mark.parametrize("key", [0, 1])
def test_essential_ransac_outlier_heavy(rng, key):
    """tests/test_essential.py's low-parallax scene with 30 % gross outliers: both
    packages hold that test's limits with the same key."""
    uv1, uv2, valid, T_true, out = two_view_scene(rng)
    ref = je.essential_ransac(jax.random.key(key), jnp.asarray(uv1), jnp.asarray(uv2),
                              jnp.asarray(valid), jnp.asarray(K2))
    got = te.essential_ransac(prng.key(key), uv1, uv2, valid, K2, device="cpu")
    for res, inl in ((ref, np.asarray(ref.inliers)), (got, got.inliers.numpy())):
        assert _angle(T_true[:3, :3], np.asarray(res.pose)[:3, :3]) < 0.05
        assert inl[out].mean() < 0.2
    assert got.pose.dtype == torch.float32 and got.n_inliers.dtype == torch.int32


@pytest.mark.parametrize("key", [0, 1])
def test_relative_scale(rng, key):
    n = 300
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    noisy = pts * 3.7 + rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    noisy[::7] *= 5.0                                   # gross outliers
    valid = rng.uniform(size=n) > 0.2
    ref = float(je.relative_scale(jax.random.key(key), jnp.asarray(pts),
                                  jnp.asarray(noisy), jnp.asarray(valid)))
    got = te.relative_scale(prng.key(key), pts, noisy, valid, device="cpu")
    assert got.shape == () and abs(float(got) - ref) <= 1e-4 * ref
    assert abs(float(got) - 3.7) < 0.05


@pytest.mark.parametrize("n_nan", [0, 1, 17, 64])
def test_nanmedian_matches_jax(rng, n_nan):
    """An even count of non-NaN values averages the two middle ones (the count here
    is 64 - n_nan: even, odd, odd, none)."""
    x = rng.normal(size=64).astype(np.float32)
    x[rng.choice(64, n_nan, replace=False)] = np.nan
    ref = np.asarray(jnp.nanmedian(jnp.asarray(x)))
    got = te._nanmedian(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    if n_nan == 0:
        assert float(got) != float(torch.nanmedian(torch.from_numpy(x)))


def test_non_finite_rows_give_nan(rng):
    """A non-finite correspondence gives NaN in its row (triangulation) or batch entry
    (DLT), as in JAX, where torch's SVD and eigh would raise; the other rows keep
    their values."""
    kp1 = rng.uniform(0, 600, (4, 2)).astype(np.float32)
    kp2 = kp1 + np.float32(3.0)
    kp1[1, 0] = np.nan
    T = _pose([0.0, 0.0, 0.0], [0.5, 0.0, 0.0])
    ref = np.asarray(jtriangulate(jnp.asarray(kp1), jnp.asarray(kp2), jnp.eye(4),
                                  jnp.asarray(T), jnp.asarray(K2))[0])
    got = triangulate(kp1, kp2, np.eye(4, dtype=np.float32), T, K2, device="cpu")[0].numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[1]).all() and np.isfinite(got[[0, 2, 3]]).all()
    src = rng.uniform(0, 600, (2, 6, 2)).astype(np.float32)
    dst = src + np.float32(2.0)
    src[1, 2, 0] = np.nan
    ref = np.asarray(jh.homography_dlt(jnp.asarray(src), jnp.asarray(dst)))
    got = th.homography_dlt(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    # 6 points, a pure shift by 2 px: the fp32 eigh floor is a few 1e-3 in the shift.
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=5e-3)
