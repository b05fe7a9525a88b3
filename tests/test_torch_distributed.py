"""The port's distributed layer (``vo_tpu_torch.parallel``, ``ba/distributed.py``) in
spawned CPU processes on gloo, against the JAX package's sharded programs on the
8-device virtual CPU mesh of tests/conftest.py (tests/test_distributed.py's cases).

The ranks run functions of the package (``runners/dryrun.py``) on numpy inputs and
return their results through files; this process never joins a group.

- Sharded BA, three cases solved in one 4-rank launch: tests/test_ba.py's problem over
  the ``model`` axis of a (2, 2) mesh (JAX: ``make_mesh(4, 2)``, 2 shards as well),
  7 poses and 102 landmarks over a 4-rank ``kf`` mesh (both paddings), and the
  ``obs_z`` depth path over ``model``. Against JAX's sharded solve at the same shard
  count: rtol 1e-4 of each array's scale (the sums run in another order); against
  the port's ``bundle_adjust``: tests/test_distributed.py's limits (poses within
  1e-3, cost rtol 1e-2), with the distances printed. Every rank holds the same bits,
  and each iteration issued one reduce-scatter of Hll and of bl, one all-to-all of U,
  one all-reduce of S and of g, two of the cost and one all-gather of the landmark
  updates (the counterpart of ``test_hlo_contains_collectives``).
- Data-parallel extraction and matching over a (2, 2) mesh equal one process's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from tests.test_ba import make_ba_problem
from vo_tpu.ba import BAConfig as JBAConfig
from vo_tpu.ba.distributed import bundle_adjust_sharded as jax_sharded
from vo_tpu.parallel import make_mesh as jax_mesh
from vo_tpu_torch.parallel import launch
from vo_tpu_torch.runners import dryrun

ITERATIONS = 8
CASES = ("model", "padded", "depth")


def _problem(case):
    rng = np.random.default_rng({"model": 8214, "padded": 8215, "depth": 8216}[case])
    if case == "padded":
        prob, _, _ = make_ba_problem(rng, P=7, L=102, M=48)
        return prob
    prob, poses_gt, points_gt = make_ba_problem(rng, P=6, L=96, M=64)
    if case == "depth":
        X = points_gt[np.asarray(prob.obs_lm)]
        z = (np.einsum("pij,pmj->pmi", poses_gt[:, :3, :3], X)[..., 2]
             + poses_gt[:, 2, 3][:, None])
        prob = prob._replace(obs_z=jnp.asarray(z.astype(np.float32)))
    return prob


def _close(got, ref, rtol=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-6))


@pytest.fixture(scope="module")
def solves():
    """The port's sharded solves (one 4-rank launch) and JAX's, per case."""
    probs = {c: _problem(c) for c in CASES}
    cases = [({k: None if v is None else np.asarray(v) for k, v in probs[c]._asdict().items()},
              "kf" if c == "padded" else "model", 2, ITERATIONS) for c in CASES]
    ranks = launch.spawn(dryrun.solve_rank, 4, "gloo", "cpu", cases, 1)
    out = {}
    for i, c in enumerate(CASES):
        mesh = (Mesh(np.asarray(jax.devices()[:4]), axis_names=("kf",)) if c == "padded"
                else jax_mesh(4, 2))
        jp, jpt, ji = jax_sharded(probs[c], mesh, JBAConfig(iterations=ITERATIONS),
                                  axis="kf" if c == "padded" else "model")
        jax_out = {"poses": jp, "points": jpt, "costs": ji["costs"],
                   "final_cost": ji["final_cost"], "mean_reproj": ji["mean_reproj"]}
        out[c] = ([{k[len(f"case{i}/"):]: v for k, v in r.items() if k.startswith(f"case{i}/")}
                   for r in ranks], {k: np.asarray(v) for k, v in jax_out.items()})
    return out


@pytest.mark.parametrize("case", CASES)
def test_sharded_ba_matches_jax_sharded(solves, case):
    ranks, ref = solves[case]
    assert int(ranks[0]["shards"]) == (4 if case == "padded" else 2)
    assert ranks[0]["poses"].shape == ref["poses"].shape
    assert ranks[0]["points"].shape == ref["points"].shape
    for k in ("poses", "points", "costs", "final_cost", "mean_reproj"):
        _close(ranks[0][k], ref[k])


@pytest.mark.parametrize("case", CASES)
def test_sharded_ba_matches_single_solve(solves, case):
    r0 = solves[case][0][0]
    d_pose = float(np.abs(r0["poses"] - r0["single_poses"]).max())
    c, c1 = float(r0["final_cost"]), float(r0["single_final_cost"])
    print(f"{case}: sharded vs bundle_adjust: poses {d_pose:.3e} apart, cost {c:.6f} vs "
          f"{c1:.6f} (rel {abs(c - c1) / abs(c1):.2e})")
    assert d_pose <= 1e-3
    assert c == pytest.approx(c1, rel=1e-2)


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_the_same_bits(solves, case):
    ranks = solves[case][0]
    for r in ranks[1:]:
        for k in ("poses", "points", "costs", "final_cost", "mean_reproj"):
            assert np.array_equal(r[k], ranks[0][k]), k
    assert all(bool(r["repeat_equal"]) for r in ranks)


@pytest.mark.parametrize("case", CASES)
def test_collectives_per_iteration(solves, case):
    import json

    n = ITERATIONS
    want = {"reduce_scatter Hll": n, "reduce_scatter bl": n, "all_to_all U": n,
            "all_reduce S": n, "all_reduce g": n, "all_reduce cost": 2 * n + 1,
            "all_reduce wsum": 1, "all_gather delta_l": n}
    for r in solves[case][0]:
        calls = {k: c for k, (c, _) in json.loads(str(r["collectives"])).items()}
        assert calls == want


def test_dp_extraction_and_matching_match_one_process():
    rng = np.random.default_rng(8214)
    imgs = rng.uniform(0, 255, (8, 120, 160)).astype(np.float32)
    deps = rng.uniform(1, 50, (8, 120, 160)).astype(np.float32)
    ranks = launch.spawn(dryrun.inference_rank, 4, "gloo", "cpu", imgs, deps, dryrun.K_DRY,
                         128, 21, 2)
    ref = {k: v.numpy() for k, v in
           dryrun.reference_inference(imgs, deps, dryrun.K_DRY, 128, 21, "cpu").items()}
    for a, b in ((0, 1), (2, 3)):              # one model row: the same block
        for k in ("kp", "desc", "idx", "mask"):
            assert np.array_equal(ranks[a][k], ranks[b][k])
    rows = (ranks[0], ranks[2])
    assert [int(r["pair0"]) for r in rows] == [0, 4]
    for k in ("kp", "desc", "valid", "kp3d"):
        assert np.array_equal(np.concatenate([r[k] for r in rows]), ref[k]), k
    mask = np.concatenate([r["mask"] for r in rows])
    idx = np.concatenate([r["idx"] for r in rows])
    assert mask.shape == (7, 128)               # 3 + 1 crossing pairs, then 3
    assert np.array_equal(mask, ref["mask"])
    assert np.array_equal(idx[mask], ref["idx"][mask])
    assert int(ranks[0]["n_matches"]) == int(ref["mask"].sum()) > 0


@pytest.mark.parametrize("backend,device", [("nccl", "cpu"), ("gloo", "cuda"),
                                            ("mpi", "cpu")])
def test_backend_and_device_must_agree(backend, device):
    with pytest.raises(ValueError):
        launch.check_backend(backend, device)
