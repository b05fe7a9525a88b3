"""The port's train-mode patchnet, AdamW step, NaN guard and checkpoints against the
JAX package's trainer on the CPU.

A narrow Fast network (``_fast_quad_specs(mchan=1, dim=32)``), batch 2, 64 x 64. The
JAX state is carried across by ``port_state.train_state_from_jax`` and both take one
``train_step_batch`` on the same batch. Tolerances: the train-mode forward and its
``bn_stats`` within 2e-5; ``update_bn_running_stats`` exact; the loss within 1e-4
relative; each gradient leaf (read off Adam's first moment, 0.1 g) within 1e-3 of
that leaf's largest |g|, except the biases of the convolutions that train-mode
BatchNorm follows, whose gradient is zero up to rounding in both packages (noise of
~1e-8): those are held within 1e-3 of the network's largest |g|; the parameters after
the update within 2.5 x lr (Adam's first step moves a weight by +-lr whatever its
gradient's size, so a near-zero gradient of the other sign moves it by 2 lr); the
cosine learning rate at counts 0, warmup, mid and end, and the running statistics'
weight decay, within 1e-6 of optax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vo_tpu.models import patchnet as jpatchnet
from vo_tpu.train import pairs as jpairs
from vo_tpu.train import trainer as jtrainer
from vo_tpu_torch import prng
from vo_tpu_torch.models import patchnet
from vo_tpu_torch.port_state import (load_jax_train_checkpoint, patchnet_params_from_jax,
                                     train_state_from_jax)
from vo_tpu_torch.train import trainer

JSPEC = jpatchnet.PatchNetSpec("narrow", jpatchnet._fast_quad_specs(1, 32), out_dim=32,
                               upsample=2)
TSPEC = patchnet.PatchNetSpec("narrow", patchnet._fast_quad_specs(1, 32), out_dim=32,
                              upsample=2)
HW = 64


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_state(jstate):
    return train_state_from_jax(np_tree(jstate.params), np_tree(jstate.opt_state),
                                np.asarray(jstate.step), device="cpu")


def jax_batch(seed=1):
    batch = jpairs.synthetic_pair_batch(jax.random.key(seed), 2, HW, HW)
    return batch, tuple(torch.from_numpy(np.array(x)) for x in batch)


def bn_biases(params):
    """Paths of the conv biases that train-mode BatchNorm follows."""
    return {("convs", i, "b") for i, layer in enumerate(params["convs"]) if "bn_mean" in layer}


def check_step(jstate1, tstate1, lr):
    """The port's state after a step against the JAX package's after the same step."""
    want = port_state(jstate1)
    paths = trainer.leaf_paths(want.params)
    mu_t, mu_j = trainer._leaves(tstate1.opt_state.mu), trainer._leaves(want.opt_state.mu)
    net_scale = max(float(m.abs().max()) for m in mu_j)
    noise = bn_biases(want.params)
    for path, mt, mj in zip(paths, mu_t, mu_j):
        scale = net_scale if path in noise else float(mj.abs().max())
        assert float((mt - mj).abs().max()) <= 1e-3 * scale, path
    for path, pt, pj in zip(paths, trainer._leaves(tstate1.params),
                            trainer._leaves(want.params)):
        assert float((pt - pj).abs().max()) <= 2.5 * lr, path
    assert int(tstate1.step) == int(want.step)
    assert int(tstate1.opt_state.count) == int(want.opt_state.count)


@pytest.mark.parametrize("spec_name", ["narrow", "quad"])
def test_train_forward_and_bn_stats(spec_name):
    if spec_name == "narrow":
        jspec, tspec = JSPEC, TSPEC
    else:
        jspec = jpatchnet.PatchNetSpec("q", jpatchnet._quad_specs(1, 32), out_dim=32)
        tspec = patchnet.PatchNetSpec("q", patchnet._quad_specs(1, 32), out_dim=32)
    params = jpatchnet.init_patchnet_params(jax.random.key(2), jspec)
    x = np.random.default_rng(91).normal(size=(2, 32, 48, 3)).astype(np.float32)
    jout = jpatchnet.apply_patchnet(params, jspec, jnp.asarray(x), train=True)
    tout = patchnet.apply_patchnet(patchnet_params_from_jax(np_tree(params), "cpu"), tspec,
                                   torch.from_numpy(x), train=True)
    for k in ("descriptors", "reliability", "repeatability"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=0, atol=2e-5)
    assert len(tout["bn_stats"]) == len(jout["bn_stats"]) == 8
    for (tm, tv), (jm, jv) in zip(tout["bn_stats"], jout["bn_stats"]):
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-5, atol=2e-5)


def test_update_bn_running_stats_exact():
    rng = np.random.default_rng(92)
    params = np_tree(jpatchnet.init_patchnet_params(jax.random.key(3), JSPEC))
    stats = [(rng.normal(size=l["bn_mean"].shape).astype(np.float32),
              rng.uniform(0.1, 3, size=l["bn_var"].shape).astype(np.float32))
             for l in params["convs"] if "bn_mean" in l]
    for l in params["convs"]:
        if "bn_mean" in l:
            l["bn_mean"] = rng.normal(size=l["bn_mean"].shape).astype(np.float32)
    want = jpatchnet.update_bn_running_stats(jax.tree.map(jnp.asarray, params),
                                             [tuple(map(jnp.asarray, s)) for s in stats], 0.9)
    got = patchnet.update_bn_running_stats(
        patchnet_params_from_jax(params, "cpu"),
        [tuple(map(torch.from_numpy, s)) for s in stats], 0.9)
    for tl_, jl_ in zip(got["convs"], want["convs"]):
        for k in ("bn_mean", "bn_var"):
            if k in jl_:
                assert np.array_equal(tl_[k].numpy(), np.asarray(jl_[k]))


@pytest.mark.parametrize("spec_name", ["fast", "quad"])
def test_gradients_flow_through_both_architectures(spec_name):
    spec = {"fast": patchnet.FAST_QUAD_L2NET_CONFCFS, "quad": patchnet.QUAD_L2NET_CONFCFS}[spec_name]
    params = patchnet.init_patchnet_params(prng.key(0), spec)
    leaves = [t.requires_grad_(True) for t in trainer._leaves(params)]
    x = prng.uniform(prng.key(1), (1, 16, 16, 3))
    out = patchnet.apply_patchnet(params, spec, x, train=True)
    loss = (torch.mean(out["descriptors"] ** 2) + torch.mean(out["reliability"])
            + torch.mean(out["repeatability"]))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(g is None or torch.isfinite(g).all() for g in grads)
    assert any(g is not None and float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("sampler", ["grid", "ngh"])
def test_train_step_batch_matches_jax(sampler):
    cfg_j = jtrainer.TrainConfig(batch=2, height=HW, width=HW, sampler=sampler)
    cfg_t = trainer.TrainConfig(batch=2, height=HW, width=HW, sampler=sampler)
    jstate = jtrainer.create_train_state(JSPEC, cfg_j)
    tstate = trainer.create_train_state(TSPEC, cfg_t, device="cpu")
    for a, b in zip(trainer._leaves(tstate.params), trainer._leaves(port_state(jstate).params)):
        assert float((a - b).abs().max()) <= 1e-6     # the same initialisation from the seed
    jb, tb = jax_batch()
    jstate1, jm = jtrainer.train_step_batch(jstate, jb, JSPEC, cfg_j)
    tstate1, tm = trainer.train_step_batch(port_state(jstate), tb, TSPEC, cfg_t)
    for k in ("cosim", "peaky", "ap", "total"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4)
    assert not bool(tm["skipped"]) and not bool(jm["skipped"])
    check_step(jstate1, tstate1, cfg_t.lr)


def test_cosine_learning_rate_matches_optax():
    cfg = trainer.TrainConfig(lr=3e-4, lr_schedule="cosine", total_steps=300, warmup_steps=30)
    jcfg = jtrainer.TrainConfig(lr=3e-4, lr_schedule="cosine", total_steps=300, warmup_steps=30)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 30, 300, 3e-4 * 0.05)
    for count in (0, 1, 29, 30, 31, 165, 299, 300, 400):
        got = float(trainer.learning_rate(cfg, torch.tensor(count, dtype=torch.int32)))
        assert got == pytest.approx(float(sched(jnp.int32(count))), abs=1e-6 * 3e-4), count
    assert trainer.learning_rate(trainer.TrainConfig(), torch.tensor(5)) == 1e-4
    # optax's update reads the schedule at the count before its increment.
    opt = jtrainer.make_optimizer(jcfg)
    p = {"w": jnp.ones(3)}
    s = opt.init(p)
    for _ in range(3):
        u, s = opt.update({"w": jnp.zeros(3)}, s, p)
    assert float(u["w"][0]) == pytest.approx(-float(sched(2)) * 5e-4, rel=1e-6)


def test_running_stats_decay_like_optax():
    """Every leaf decays by lr * wd, the zero-gradient running statistics included."""
    cfg = trainer.TrainConfig()
    jcfg = jtrainer.TrainConfig()
    params = np_tree(jpatchnet.init_patchnet_params(jax.random.key(4), JSPEC))
    rng = np.random.default_rng(93)
    for l in params["convs"]:
        if "bn_mean" in l:
            l["bn_mean"] = rng.normal(size=l["bn_mean"].shape).astype(np.float32)
            l["bn_var"] = rng.uniform(0.5, 2, size=l["bn_var"].shape).astype(np.float32)
    opt = jtrainer.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    grads = jax.tree.map(jnp.zeros_like, jp)
    upd, _ = opt.update(grads, opt.init(jp), jp)
    want = optax.apply_updates(jp, upd)
    tp = patchnet_params_from_jax(params, "cpu")
    topt = trainer.make_optimizer(cfg)
    got, _ = topt.update([torch.zeros_like(t) for t in trainer._leaves(tp)], topt.init(tp), tp)
    for l_t, l_j, l_0 in zip(got["convs"], want["convs"], params["convs"]):
        for k in ("bn_mean", "bn_var"):
            if k in l_j:
                np.testing.assert_allclose(l_t[k].numpy(), np.asarray(l_j[k]), rtol=1e-6)
                np.testing.assert_allclose(l_t[k].numpy(), l_0[k] * (1 - 1e-4 * 5e-4),
                                           rtol=1e-6)


def test_nan_guard_keeps_the_state():
    cfg = trainer.TrainConfig(batch=2, height=HW, width=HW)
    state = trainer.create_train_state(TSPEC, cfg, device="cpu")
    img1, img2, flow, mask = jax_batch()[1]
    img1 = img1.clone()
    img1[0, 5, 5] = float("nan")
    new, metrics = trainer.train_step_batch(state, (img1, img2, flow, mask), TSPEC, cfg)
    assert bool(metrics["skipped"]) and not bool(torch.isfinite(metrics["total"]))
    assert int(new.step) == int(state.step) + 1
    old_leaves = trainer._state_leaves(state)
    for (n, a), (_, b) in zip(trainer._state_leaves(new), old_leaves):
        if n != "step":
            assert torch.equal(a, b), n


def test_loss_falls_over_eight_fixed_batch_steps():
    cfg = trainer.TrainConfig(batch=2, height=HW, width=HW)
    state = trainer.create_train_state(TSPEC, cfg, device="cpu")
    key = prng.key(1)
    losses = []
    for _ in range(8):
        state, metrics = trainer.train_step(state, key, TSPEC, cfg)
        assert not bool(metrics["skipped"])
        losses.append(float(metrics["total"]))
    assert losses[-1] < losses[0], losses
    assert int(state.step) == 8


def test_checkpoint_round_trip(tmp_path):
    cfg = trainer.TrainConfig(batch=2, height=HW, width=HW)
    state = trainer.create_train_state(TSPEC, cfg, device="cpu")
    state, _ = trainer.train_step(state, prng.key(0), TSPEC, cfg)
    path = str(tmp_path / "ckpt.npz")
    trainer.save_checkpoint(path, state, TSPEC.name)
    back = trainer.load_checkpoint(path, trainer.create_train_state(TSPEC, cfg, device="cpu"))
    for (n, a), (_, b) in zip(trainer._state_leaves(back), trainer._state_leaves(state)):
        assert torch.equal(a, b), n
    other = patchnet.PatchNetSpec("x", patchnet._fast_quad_specs(1, 16), out_dim=16, upsample=2)
    with pytest.raises(ValueError, match="tree mismatch"):
        trainer.load_checkpoint(path, trainer.create_train_state(other, cfg, device="cpu"))


@pytest.mark.parametrize("schedule", ["const", "cosine"])
def test_resume_a_jax_checkpoint(tmp_path, schedule):
    """A JAX ``save_checkpoint`` file read by ``load_jax_train_checkpoint`` takes the
    same next step in the port as in the JAX package."""
    kw = dict(batch=2, height=HW, width=HW, lr_schedule=schedule, total_steps=20,
              warmup_steps=2)
    jcfg, tcfg = jtrainer.TrainConfig(**kw), trainer.TrainConfig(**kw)
    jstate = jtrainer.create_train_state(JSPEC, jcfg)
    jstate, _ = jtrainer.train_step_batch(jstate, jax_batch(2)[0], JSPEC, jcfg)
    path = str(tmp_path / "jax.ckpt")
    jtrainer.save_checkpoint(path, jstate, JSPEC.name)
    tstate = load_jax_train_checkpoint(path, TSPEC, tcfg, device="cpu")
    assert int(tstate.step) == 1 and int(tstate.opt_state.count) == 1
    jb, tb = jax_batch(3)
    jstate2, _ = jtrainer.train_step_batch(jstate, jb, JSPEC, jcfg)
    tstate2, _ = trainer.train_step_batch(tstate, tb, TSPEC, tcfg)
    check_step(jstate2, tstate2, tcfg.lr)
    wrong = trainer.TrainConfig(**dict(kw, lr_schedule="const" if schedule == "cosine"
                                       else "cosine"))
    with pytest.raises(ValueError, match="expected"):
        load_jax_train_checkpoint(path, TSPEC, wrong, device="cpu")
