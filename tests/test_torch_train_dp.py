"""The data-parallel training step (``train_step_batch(..., group=)``) over 2 spawned
CPU ranks on gloo, against the JAX package's ``train_step_batch`` on the whole batch
and against the port's step in one process.

The narrow Fast network of tests/test_torch_train_step.py, batch 4 at 64 x 64 (2 pairs
per rank). The batch is drawn from key 1, as in that file, and the step
(``runners/dryrun.py::train_rank``) and the moments (``bn_moments_rank``) are launched
once each and shared by the cases. Tolerances: the train-mode BatchNorm moments over
the group within 2e-5 of the whole batch's (JAX's ``apply_patchnet``); the step under
that file's ``check_step`` gates (loss within 1e-4 relative, each gradient leaf within
1e-3 of its scale, parameters within 2.5 lr); the port's one-process step the same
way; and each gradient leaf within 1e-4 of its scale of the port's one-process step in
fp64. Both ranks hold the same bits. Moments of each rank's own half (what per-rank
BatchNorm, e.g. DDP's, would use) miss the whole batch's, and the loss with them
misses JAX's by more than the gate: the case that shows the step needs the moments of
the group.

On the batch of key 5 JAX's own fp32 step lies 4.5e-3 of a leaf's scale from its fp64
step, outside ``check_step``'s 1e-3, so there the reference is JAX's step run in fp64
(x64 enabled, its hard-wired float32 casts and fp32 ImageNet constants widened for the
call): the port's fp64 step within 1e-6 of it, and the data-parallel fp32 step under
``check_step``'s gates against it.
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import HW, JSPEC, TSPEC, check_step, port_state
from vo_tpu.models import patchnet as jpatchnet
from vo_tpu.train import losses as jlosses
from vo_tpu.train import pairs as jpairs
from vo_tpu.train import trainer as jtrainer
from vo_tpu_torch.parallel import launch
from vo_tpu_torch.runners import dryrun
from vo_tpu_torch.train import trainer

BATCH = 4


def _jax_and_port_state():
    cfg_j = jtrainer.TrainConfig(batch=BATCH, height=HW, width=HW)
    jstate = jtrainer.create_train_state(JSPEC, cfg_j)
    state0 = port_state(jstate)
    return cfg_j, jstate, state0, [t.numpy() for _, t in trainer._state_leaves(state0)]


def _dp_states(ranks, state0, n_leaves):
    return [trainer.state_from_leaves(state0, [torch.from_numpy(r[f"state/{i}"])
                                               for i in range(n_leaves)]) for r in ranks]


def _fp64_step(state0, tb, cfg):
    return trainer.train_step_batch(
        trainer.state_to(state0, "cpu", torch.float64),
        tuple(x.double() if x.is_floating_point() else x for x in tb), TSPEC, cfg)


@pytest.fixture(scope="module")
def run():
    cfg_t = trainer.TrainConfig(batch=BATCH, height=HW, width=HW)
    cfg_j, jstate, state0, leaves = _jax_and_port_state()
    jbatch = jpairs.synthetic_pair_batch(jax.random.key(1), BATCH, HW, HW)
    batch = tuple(np.array(x) for x in jbatch)
    ranks = launch.spawn(dryrun.train_rank, 2, "gloo", "cpu", TSPEC, cfg_t, leaves, batch)
    moments = launch.spawn(dryrun.bn_moments_rank, 2, "gloo", "cpu", TSPEC, cfg_t, leaves,
                           batch)
    jstate1, jm = jtrainer.train_step_batch(jstate, jbatch, JSPEC, cfg_j)
    x1 = jtrainer._normalize(jbatch[0])
    jmoments = jpatchnet.apply_patchnet(jstate.params, JSPEC, x1, train=True)["bn_stats"]
    tb = tuple(torch.from_numpy(x) for x in batch)
    return dict(ranks=ranks, moments=moments, states=_dp_states(ranks, state0, len(leaves)),
                jstate1=jstate1, jm=jm, cfg=cfg_t,
                one=trainer.train_step_batch(state0, tb, TSPEC, cfg_t),
                one64=_fp64_step(state0, tb, cfg_t),
                jmoments=[tuple(map(np.asarray, m)) for m in jmoments])


class _Float64Numpy(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _jax_step_fp64(jstate, batch, cfg):
    """JAX's ``train_step_batch`` in fp64: x64 enabled, the state and batch widened,
    the float32 casts of its patchnet and losses and its compute dtype read as float64,
    and its ImageNet constants the port's exact decimals (fp32-rounded in the JAX
    package, which moves the fp64 gradient by ~1e-6 of a leaf's scale)."""
    wide = _Float64Numpy("jax.numpy")
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpatchnet, "jnp", wide)
        mp.setattr(jlosses, "jnp", wide)
        mp.setattr(jtrainer, "apply_patchnet",
                   functools.partial(jpatchnet.apply_patchnet, compute_dtype=jnp.float64))
        mp.setattr(jtrainer, "_IMAGENET_MEAN", np.array([0.485, 0.456, 0.406]))
        mp.setattr(jtrainer, "_IMAGENET_STD", np.array([0.229, 0.224, 0.225]))
        up = lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x
        state1, metrics = jtrainer.train_step_batch(
            jax.tree.map(up, jstate), tuple(up(jnp.asarray(x)) for x in batch), JSPEC, cfg)
        assert {str(x.dtype) for x in jax.tree.leaves(state1.params)} == {"float64"}
        return state1, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def run5():
    """The batch of key 5: the data-parallel step, the port's fp32 and fp64 steps in
    one process, JAX's fp32 step and JAX's step in fp64."""
    cfg_t = trainer.TrainConfig(batch=BATCH, height=HW, width=HW)
    cfg_j, jstate, state0, leaves = _jax_and_port_state()
    jbatch = jpairs.synthetic_pair_batch(jax.random.key(5), BATCH, HW, HW)
    batch = tuple(np.array(x) for x in jbatch)
    ranks = launch.spawn(dryrun.train_rank, 2, "gloo", "cpu", TSPEC, cfg_t, leaves, batch)
    tb = tuple(torch.from_numpy(x) for x in batch)
    jstate64, jm64 = _jax_step_fp64(jstate, batch, cfg_j)
    return dict(ranks=ranks, states=_dp_states(ranks, state0, len(leaves)), cfg=cfg_t,
                one=trainer.train_step_batch(state0, tb, TSPEC, cfg_t),
                one64=_fp64_step(state0, tb, cfg_t), jstate64=jstate64,
                j64=port_state(jstate64), jm64=jm64,
                j32=port_state(jtrainer.train_step_batch(jstate, jbatch, JSPEC, cfg_j)[0]))


@pytest.mark.parametrize("rank", [0, 1])
def test_group_moments_are_the_whole_batch(run, rank):
    r = run["moments"][rank]
    assert len(run["jmoments"]) == 8
    for l, (jm, jv) in enumerate(run["jmoments"]):
        np.testing.assert_allclose(r[f"bn_mean/{l}"], jm, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r[f"bn_var/{l}"], jv, rtol=2e-5, atol=2e-5)


def test_rank_local_moments_miss(run):
    """Each rank's own half gives other moments, and a loss outside the gate."""
    r = run["moments"][0]
    gap = max(float(np.abs(r[f"local_mean/{l}"] - jm).max())
              for l, (jm, _) in enumerate(run["jmoments"]))
    assert gap > 1e-3
    local, want = float(r["local_bn_total"]), float(run["jm"]["total"])
    print(f"loss with rank-local moments {local:.6f}, JAX {want:.6f}")
    assert abs(local - want) > 1e-4 * abs(want)


@pytest.mark.parametrize("rank", [0, 1])
def test_dp_step_matches_jax_whole_batch(run, rank):
    r = run["ranks"][rank]
    assert int(r["batch_per_rank"]) == BATCH // 2
    for k in ("cosim", "peaky", "ap", "total"):
        assert float(r[k]) == pytest.approx(float(run["jm"][k]), rel=1e-4)
    assert not bool(r["skipped"])
    check_step(run["jstate1"], run["states"][rank], run["cfg"].lr)


def _worst_gradient_leaf(state, ref):
    """The largest distance of a gradient leaf (Adam's first moment, 0.1 g) of ``state``
    from ``ref``'s, over that leaf's largest |g|; the biases of the convolutions that
    BatchNorm follows, whose gradient is rounding noise around 0, over the network's."""
    paths = trainer.leaf_paths(ref.params)
    mu, mu_ref = trainer._leaves(state.opt_state.mu), trainer._leaves(ref.opt_state.mu)
    net = max(float(m.abs().max()) for m in mu_ref)
    worst = 0.0
    for (group, i, k), a, b in zip(paths, mu, mu_ref):
        if k.startswith("bn_"):
            continue
        noise = group == "convs" and k == "b" and "bn_mean" in ref.params["convs"][i]
        worst = max(worst, float((a.double() - b.double()).abs().max())
                    / (net if noise else float(b.abs().max())))
    return worst


def test_dp_step_matches_one_process(run):
    state1, m1 = run["one"]
    r = run["ranks"][0]
    for k in ("cosim", "peaky", "ap", "total"):
        assert float(r[k]) == pytest.approx(float(m1[k]), rel=1e-4)
    for a, b in zip(trainer._leaves(run["states"][0].params), trainer._leaves(state1.params)):
        assert float((a - b).abs().max()) <= 2.5 * run["cfg"].lr
    assert _worst_gradient_leaf(run["states"][0], state1) <= 1e-3


def test_dp_gradients_match_the_fp64_step(run):
    worst = _worst_gradient_leaf(run["states"][0], run["one64"][0])
    print(f"DP step vs the fp64 one-process step: worst gradient leaf {worst:.2e}")
    assert worst <= 1e-4


def test_ranks_hold_the_same_state_and_one_gradient_all_reduce(run):
    a, b = run["ranks"]
    for i in range(len(trainer._state_leaves(run["states"][0]))):
        assert np.array_equal(a[f"state/{i}"], b[f"state/{i}"])
    reduces = json.loads(str(a["all_reduces"]))
    assert reduces["gradients"][0] == 1
    n_grad = sum(t.numel() for p, t in zip(trainer.leaf_paths(run["states"][0].params),
                                           trainer._leaves(run["states"][0].params))
                 if not p[2].startswith("bn_"))
    assert reduces["gradients"][1] == 4 * n_grad            # one flat fp32 buffer
    assert reduces["BatchNorm sum"][0] == reduces["BatchNorm squares"][0] == 2 * 8


def test_fp64_steps_agree_on_the_key5_batch(run5):
    """The port's fp64 step against JAX's: what is left is fp64 rounding. JAX's own
    fp32 step is printed beside it, the reason the key-1 batch holds the fp32 steps."""
    worst = _worst_gradient_leaf(run5["one64"][0], run5["j64"])
    jax32 = _worst_gradient_leaf(run5["j32"], run5["j64"])
    port32 = _worst_gradient_leaf(run5["one"][0], run5["j64"])
    print(f"key 5, worst gradient leaf against JAX's fp64 step: the port's fp64 step "
          f"{worst:.2e}, the port's fp32 step {port32:.2e}, JAX's fp32 step {jax32:.2e}")
    assert float(run5["one64"][1]["total"]) == pytest.approx(run5["jm64"]["total"], rel=1e-12)
    assert worst <= 1e-6


def test_dp_step_matches_the_jax_fp64_step_on_the_key5_batch(run5):
    for r, state in zip(run5["ranks"], run5["states"]):
        assert int(r["batch_per_rank"]) == BATCH // 2
        for k in ("cosim", "peaky", "ap", "total"):
            assert float(r[k]) == pytest.approx(run5["jm64"][k], rel=1e-4)
        assert not bool(r["skipped"])
        check_step(run5["jstate64"], state, run5["cfg"].lr)
    a, b = run5["ranks"]
    assert all(np.array_equal(a[k], b[k]) for k in a if k.startswith("state/"))
