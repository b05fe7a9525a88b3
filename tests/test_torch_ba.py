"""The port's bundle adjustment and pose graph (``vo_tpu_torch.ba``) against the JAX
package's (``vo_tpu.ba``) on the same numpy inputs, on the CPU.

Problems as tests/test_ba.py builds them: 6 cameras on an arc over 120 landmarks, 80
observation slots each, noisy initialisation; a 12- or 40-node pose chain with a
loop edge. Tolerances: SE(3) maps and blocks 1e-5 (relative where stated); BA and PGO
results rtol 1e-4 of each array's scale, the iteration costs rtol 1e-4 (the solves
sum in another order than XLA: never bit-equal). The port's block sums
(``ba/segment.py::segment_sum``) are fixed-order: bit-equal to ``index_add_`` on the
CPU and from call to call.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.geometry import se3 as jse3
from vo_tpu_torch.ba import BAConfig, BAProblem, PoseGraphConfig, bundle_adjust, optimize_pose_graph
from vo_tpu_torch.ba.pose_graph import adjoint
from vo_tpu_torch.ba.segment import segment_sum, segments
from vo_tpu_torch.geometry.se3 import se3_exp, se3_log
from vo_tpu_torch.geometry.so3 import so3_exp
from vo_tpu_torch.port_state import ba_problem_from_numpy, config_from_jax

# The modules (each package's ba/__init__.py re-exports a function of the same name).
jbundle = importlib.import_module("vo_tpu.ba.bundle_adjust")
jpgo = importlib.import_module("vo_tpu.ba.pose_graph")
tbundle = importlib.import_module("vo_tpu_torch.ba.bundle_adjust")

K = np.array([[400.0, 0.0, 320.0], [0.0, 400.0, 180.0], [0.0, 0.0, 1.0]], np.float32)


def _pose(w, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = so3_exp(torch.from_numpy(np.asarray(w, np.float32))).numpy()
    T[:3, 3] = t
    return T


def make_problem(rng, P=6, L=120, M=80, px_noise=0.3, obs_z=False):
    """tests/test_ba.py::make_ba_problem in numpy: (poses, points, obs_lm, obs_uv,
    obs_valid, K[, obs_z]) arrays."""
    pts = np.stack([rng.uniform(-8, 8, L), rng.uniform(-4, 4, L),
                    rng.uniform(8, 25, L)], -1).astype(np.float32)
    gt = np.stack([_pose([0.0, 0.04 * p, 0.0], [-0.5 * p, 0.02 * p, 0.1 * p])
                   for p in range(P)])
    obs_lm = np.zeros((P, M), np.int32)
    obs_uv = np.zeros((P, M, 2), np.float32)
    obs_valid = np.zeros((P, M), bool)
    depth = np.zeros((P, M), np.float32)
    for p in range(P):
        lm = rng.choice(L, M, replace=False)
        Y = pts[lm] @ gt[p, :3, :3].T + gt[p, :3, 3]
        uv = (Y[:, :2] / Y[:, 2:3]) * K[0, 0] + K[:2, 2]
        obs_lm[p], obs_uv[p] = lm, uv + rng.normal(0, px_noise, (M, 2))
        obs_valid[p] = Y[:, 2] > 0
        depth[p] = Y[:, 2] * (1.0 + rng.normal(0, 0.001, M))
    init = gt.copy()
    for p in range(1, P):
        init[p] = _pose(rng.normal(0, 0.02, 3), rng.normal(0, 0.1, 3)) @ gt[p]
    points = pts + rng.normal(0, 0.05, (L, 3)).astype(np.float32)
    arrays = dict(poses=init, points=points, obs_lm=obs_lm, obs_uv=obs_uv,
                  obs_valid=obs_valid, K=K)
    if obs_z:
        arrays["obs_z"] = np.where(rng.uniform(size=(P, M)) < 0.8, depth, 0.0)
    return arrays


def _both(arrays):
    """The JAX BAProblem and the port's (on the CPU) of the same arrays."""
    jprob = jbundle.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jprob, ba_problem_from_numpy(jprob, device="cpu")


def _close(got, ref, rtol=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-6))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["random", "small", "near_pi"])
def test_se3_log_matches_jax_and_inverts_exp(kind):
    rng = np.random.default_rng(31)
    xi = rng.normal(size=(64, 6)).astype(np.float32)
    if kind == "small":
        xi[:, 3:] *= 1e-5
    elif kind == "near_pi":
        w = rng.normal(size=(64, 3))
        xi[:, 3:] = w / np.linalg.norm(w, axis=1, keepdims=True) * (np.pi - 2e-3)
    T = se3_exp(torch.from_numpy(xi))
    got = se3_log(T).numpy()
    np.testing.assert_allclose(got, np.asarray(jse3.se3_log(jnp.asarray(T.numpy()))),
                               rtol=1e-5, atol=2e-5)
    if kind != "near_pi":      # near pi so3_log (both packages') loses fp32 digits
        np.testing.assert_allclose(got, xi, rtol=1e-4, atol=5e-5)
        np.testing.assert_allclose(se3_exp(torch.from_numpy(got)).numpy(), T.numpy(),
                                   atol=5e-5)


def test_adjoint_and_damped_inv3_match_jax():
    rng = np.random.default_rng(32)
    T = se3_exp(torch.from_numpy(rng.normal(size=(16, 6)).astype(np.float32)))
    np.testing.assert_allclose(adjoint(T).numpy(),
                               np.asarray(jpgo.adjoint(jnp.asarray(T.numpy()))), atol=1e-6)
    A = rng.normal(size=(50, 3, 5)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1)
    H[:5] = 0.0                                   # unobserved landmarks
    for damping in (0.0, 1e-3, 0.25):
        got = tbundle.damped_inv3(torch.from_numpy(H), torch.tensor(damping)).numpy()
        ref = np.asarray(jbundle.damped_inv3(jnp.asarray(H), damping))
        _close(got[5:], ref[5:], rtol=1e-5)
        _close(got[:5], ref[:5], rtol=1e-5)
        if damping:
            H_d = H[5:] + (damping * np.trace(H[5:], axis1=1, axis2=2)[:, None, None] / 3
                           + 1e-8) * np.eye(3)
            np.testing.assert_allclose(got[5:] @ H_d, np.broadcast_to(np.eye(3), H_d.shape),
                                       atol=1e-4)


@pytest.mark.parametrize("with_depth", [False, True], ids=["reprojection", "rgbd"])
def test_residuals_jacobians_and_reduced_system_match_jax(with_depth):
    arrays = make_problem(np.random.default_rng(33), obs_z=with_depth)
    jprob, tprob = _both(arrays)
    jcfg, tcfg = jbundle.BAConfig(), BAConfig()
    ref = jbundle._residuals_and_jacobians(jprob.poses, jprob.points, jprob, jcfg)
    got = tbundle._residuals_and_jacobians(tprob.poses, tprob.points,
                                           tprob._replace(obs_lm=tprob.obs_lm.long()), tcfg)
    for g, r in zip(got, ref):
        _close(g.numpy(), r, rtol=2e-5)
    L = arrays["points"].shape[0]
    S_ref, g_ref, _ = jbundle._assemble_reduced_system(*ref, jprob.obs_lm, L, 1e-3)
    S, g, _ = tbundle._assemble_reduced_system(*got, tprob.obs_lm.long(), L,
                                               torch.tensor(1e-3))
    _close(S.numpy(), S_ref, rtol=1e-4)
    _close(g.numpy(), g_ref, rtol=1e-4)


@pytest.mark.parametrize("case", ["plain", "rgbd", "masked"])
def test_bundle_adjust_matches_jax(case):
    rng = np.random.default_rng(34)
    arrays = make_problem(rng, obs_z=case == "rgbd")
    if case == "masked":                          # corrupted half, masked out
        arrays["obs_uv"][:, ::2] += 500.0
        arrays["obs_valid"][:, ::2] = False
    jprob, tprob = _both(arrays)
    jp, jx, ji = jbundle.bundle_adjust(jprob, jbundle.BAConfig(iterations=12))
    p, x, info = bundle_adjust(tprob, BAConfig(iterations=12), device="cpu")
    _close(p.numpy(), jp)
    _close(x.numpy(), jx)
    _close(info["costs"].numpy(), ji["costs"])
    _close(info["final_cost"].numpy(), ji["final_cost"])
    _close(info["mean_reproj"].numpy(), ji["mean_reproj"])
    assert float(info["mean_reproj"]) < 1.0


def test_all_invalid_window_gives_non_finite_steps_without_raising():
    """No valid observation and no damping: the reduced system is singular. JAX's
    solve returns non-finite values and every step is rejected; the port's
    ``solve_ex`` does the same, where ``torch.linalg.solve`` raises."""
    arrays = make_problem(np.random.default_rng(35), P=4, L=20, M=8)
    arrays["obs_valid"][:] = False
    jprob, tprob = _both(arrays)
    cfg = dict(iterations=3, damping_init=0.0)
    jp, _, ji = jbundle.bundle_adjust(jprob, jbundle.BAConfig(**cfg))
    p, x, info = bundle_adjust(tprob, BAConfig(**cfg), device="cpu")
    costs = info["costs"].numpy()
    assert (costs[:, 0] == 0).all() and not np.isfinite(costs[:, 1]).any()
    np.testing.assert_array_equal(np.isfinite(costs), np.isfinite(np.asarray(ji["costs"])))
    np.testing.assert_array_equal(p.numpy(), arrays["poses"])    # every step rejected
    np.testing.assert_array_equal(np.asarray(jp), arrays["poses"])
    S, g, _ = tbundle._assemble_reduced_system(
        *tbundle._residuals_and_jacobians(tprob.poses, tprob.points,
                                          tprob._replace(obs_lm=tprob.obs_lm.long()),
                                          BAConfig()),
        tprob.obs_lm.long(), 20, torch.tensor(0.0))
    with pytest.raises(RuntimeError):
        torch.linalg.solve(S, g)


def _chain(rng, N=12, drift=0.05):
    """tests/test_ba.py::TestPoseGraph.make_chain: odometry edges with drift noise and
    an exact loop edge from 0 to N-1; the initialisation integrates the odometry."""
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(1, N):
        gt.append(gt[-1] @ _pose([0.0, 0.02, 0.0], [0.0, 0.0, 1.0]))
    gt = np.stack(gt)
    edges, zs = [], []
    for i in range(N - 1):
        dT = _pose(rng.normal(0, drift, 3) * 0.2, rng.normal(0, drift, 3))
        edges.append((i, i + 1))
        zs.append(dT @ np.linalg.inv(gt[i]) @ gt[i + 1])
    edges.append((0, N - 1))
    zs.append(np.linalg.inv(gt[0]) @ gt[N - 1])
    init = [gt[0]]
    for i in range(N - 1):
        init.append(init[-1] @ zs[i])
    return gt, np.stack(init).astype(np.float32), np.asarray(edges, np.int32), \
        np.stack(zs).astype(np.float32)


@pytest.mark.parametrize("weights", ["isotropic", "anisotropic", "long"])
def test_pose_graph_matches_jax(weights):
    rng = np.random.default_rng(36)
    gt, init, edges, zs = _chain(rng, N=40 if weights == "long" else 12)
    iters = 120 if weights == "long" else 25
    if weights == "anisotropic":
        w = np.ones((len(edges), 6), np.float32)
        w[:-1, 3:] = 1000.0
        w[-1] = 20.0
    else:
        w = np.ones(len(edges), np.float32)
        w[-1] = 20.0
    jopt, jcosts = jpgo.optimize_pose_graph(jnp.asarray(init), jnp.asarray(edges),
                                            jnp.asarray(zs), jnp.asarray(w),
                                            jpgo.PoseGraphConfig(iterations=iters))
    opt, costs = optimize_pose_graph(init, edges, zs, w, PoseGraphConfig(iterations=iters),
                                     device="cpu")
    _close(opt.numpy(), jopt)
    _close(costs.numpy()[:20], np.asarray(jcosts)[:20])
    costs = costs.numpy()
    assert np.isfinite(costs).all() and costs[-1] < costs[0]
    err0 = np.linalg.norm(init[-1, :3, 3] - gt[-1, :3, 3])
    assert np.linalg.norm(opt.numpy()[-1, :3, 3] - gt[-1, :3, 3]) < 0.5 * err0
    if weights == "long":       # rejected steps hold: recorded costs never rise
        assert (np.diff(costs) <= 1e-4 * np.maximum(costs[:-1], 1.0)).all()


def test_pose_graph_rejects_a_diverging_step():
    """A step that does not lower the cost (here: from the optimum with no damping)
    is rejected and the damping raised; the poses stay where they were."""
    gt, _, edges, _ = _chain(np.random.default_rng(37), drift=0.0)
    zs = np.stack([np.linalg.inv(gt[i]) @ gt[j] for i, j in edges]).astype(np.float32)
    w = np.ones(len(edges), np.float32)
    cfg = dict(iterations=4, damping=0.0)
    jopt, jcosts = jpgo.optimize_pose_graph(jnp.asarray(gt), jnp.asarray(edges),
                                            jnp.asarray(zs), jnp.asarray(w),
                                            jpgo.PoseGraphConfig(**cfg))
    opt, costs = optimize_pose_graph(gt, edges, zs, w, PoseGraphConfig(**cfg), device="cpu")
    np.testing.assert_allclose(opt.numpy(), gt, atol=1e-4)
    np.testing.assert_allclose(opt.numpy(), np.asarray(jopt), atol=1e-4)
    assert np.abs(costs.numpy()).max() < 1e-6 and np.abs(np.asarray(jcosts)).max() < 1e-6


def test_solvers_configs_and_problem_from_jax():
    for jcfg in (jbundle.BAConfig(iterations=7, huber_delta=3.0), jpgo.PoseGraphConfig(
            iterations=9, damping=1e-3, fix_first=False)):
        cfg = config_from_jax(dataclasses.asdict(jcfg))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    arrays = make_problem(np.random.default_rng(38), P=3, L=10, M=6)
    prob = ba_problem_from_numpy(arrays, device="cpu")
    assert isinstance(prob, BAProblem) and prob.obs_z is None
    for name, value in arrays.items():
        np.testing.assert_array_equal(getattr(prob, name).numpy(), value)


@pytest.mark.parametrize("shape", [(3, 3), (6,), (6, 6)])
def test_segment_sum_equals_index_add_and_repeats(shape):
    """The fixed-order segment sum gives ``index_add_``'s bits on the CPU (both add
    each segment's values in their original order, from 0), empty segments are 0, and
    two calls, with a plan or without, give the same bits."""
    rng = np.random.default_rng(39)
    n, num = 5000, 700                       # ~7 values per id, some ids unused
    ids = torch.from_numpy(rng.integers(0, num, n))
    ids[ids == 3] = 4                        # an empty segment
    values = torch.from_numpy(rng.normal(size=(n,) + shape).astype(np.float32) * 1e3)
    ref = values.new_zeros((num,) + shape).index_add_(0, ids, values)
    got = segment_sum(values, ids, num)
    assert torch.equal(got, ref)
    assert (got[3] == 0).all()
    plan = segments(ids, num)
    assert torch.equal(segment_sum(values, plan), got)
    assert torch.equal(segment_sum(values, plan), segment_sum(values, plan))
    empty = segment_sum(values[:0], ids[:0], 4)
    assert empty.shape == (4,) + shape and (empty == 0).all()


def test_solvers_repeat_bit_for_bit():
    """Two calls of each solver on the same problem give identical bits."""
    arrays = make_problem(np.random.default_rng(40), P=5, L=60, M=30)
    _, tprob = _both(arrays)
    runs = [bundle_adjust(tprob, BAConfig(iterations=4), device="cpu") for _ in range(2)]
    for a, b in zip(runs[0][:2], runs[1][:2]):
        assert torch.equal(a, b)
    _, init, edges, zs = _chain(np.random.default_rng(41))
    w = np.ones(len(edges), np.float32)
    (o1, c1), (o2, c2) = (optimize_pose_graph(init, edges, zs, w, device="cpu")
                          for _ in range(2))
    assert torch.equal(o1, o2) and torch.equal(c1, c2)
