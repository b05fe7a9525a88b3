"""The port's R2D2 losses and their gradients against the JAX package's on the CPU.

Inputs are the JAX package's synthetic pairs (a random-homography flow whose mask
leaves part of image 1 without a correspondence) and seeded repeatability,
reliability and L2-normed descriptor maps. Tolerances: each loss's value within 1e-5
relative; its gradient (``torch.autograd`` against ``jax.grad``) within 1e-4 of the
largest |g| of that input; both samplers. Ties follow ``jax.grad``'s rules: the
soft histogram's ``clip(1 - |s - c| / delta, 0, 1)`` at a bin centre and the masked
-1.0 negatives, and ``jnp.clip``'s 0.5 / 0.5 split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.train import losses as jl
from vo_tpu.train import pairs as jpairs
from vo_tpu_torch.train import losses as tl

B, H, W, D = 2, 64, 80, 16


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(81)
    _, _, flow, mask = (np.asarray(x) for x in
                        jpairs.synthetic_pair_batch(jax.random.key(8), B, H, W))
    assert 0.3 < mask.mean() < 0.99
    rep1, rep2, rel1 = (rng.uniform(0.05, 0.95, (B, H, W)).astype(np.float32)
                        for _ in range(3))
    # Smooth but distinctive descriptors, so the rings' positives stay similar.
    base = rng.normal(size=(B, H // 8, W // 8, D)).astype(np.float32)
    d1 = np.asarray(jax.image.resize(jnp.asarray(base), (B, H, W, D), "linear"))
    d1 = d1 / np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = d1 + 0.2 * rng.normal(size=d1.shape).astype(np.float32)
    d2 = d2 / np.linalg.norm(d2, axis=-1, keepdims=True)
    return dict(rep1=rep1, rep2=rep2, rel1=rel1, desc1=d1.astype(np.float32),
                desc2=d2.astype(np.float32), flow=flow, mask=mask)


def both(jfn, tfn, inputs: dict, diff: tuple):
    """Value and gradients w.r.t. ``diff`` of a JAX and a port loss on the same
    numpy inputs."""
    def jloss(*args):
        kw = dict(inputs, **dict(zip(diff, args)))
        return jfn(**{k: jnp.asarray(v) for k, v in kw.items()})

    jval, jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(diff))))(
        *(jnp.asarray(inputs[k]) for k in diff))
    targs = {k: torch.tensor(v, requires_grad=k in diff) for k, v in inputs.items()}
    tval = tfn(**targs)
    tgrads = torch.autograd.grad(tval, [targs[k] for k in diff])
    return float(jval), [np.asarray(g) for g in jgrads], float(tval), [g.numpy() for g in tgrads]


def check(jval, jgrads, tval, tgrads, names):
    assert tval == pytest.approx(jval, rel=1e-5, abs=1e-7)
    for name, jg, tg in zip(names, jgrads, tgrads):
        assert tg.shape == jg.shape
        scale = float(np.abs(jg).max())
        assert scale > 0, name
        assert np.abs(tg - jg).max() <= 1e-4 * scale, (name, np.abs(tg - jg).max(), scale)


def test_cosim_loss(maps):
    inputs = {k: maps[k] for k in ("rep1", "rep2", "flow", "mask")}
    res = both(jl.cosim_loss, tl.cosim_loss, inputs, ("rep1", "rep2"))
    check(*res, ("rep1", "rep2"))


def test_cosim_loss_with_a_window_fully_masked(maps):
    mask = maps["mask"].copy()
    mask[:, :16, :16] = False
    inputs = dict(rep1=maps["rep1"], rep2=maps["rep2"], flow=maps["flow"], mask=mask)
    jval, jg, tval, tg = both(jl.cosim_loss, tl.cosim_loss, inputs, ("rep1", "rep2"))
    assert all(np.isfinite(g).all() for g in tg)
    check(jval, jg, tval, tg, ("rep1", "rep2"))


@pytest.mark.parametrize("window", [16, 8])
def test_peaky_loss(maps, window):
    res = both(lambda rep: jl.peaky_loss(rep, window), lambda rep: tl.peaky_loss(rep, window),
               {"rep": maps["rep1"]}, ("rep",))
    check(*res, ("rep",))


@pytest.mark.parametrize("sampler", ["grid", "ngh"])
def test_ap_reliability_loss(maps, sampler):
    jfn = {"grid": jl.ap_reliability_loss, "ngh": jl.ngh_ap_reliability_loss}[sampler]
    tfn = {"grid": tl.ap_reliability_loss, "ngh": tl.ngh_ap_reliability_loss}[sampler]
    inputs = {k: maps[k] for k in ("desc1", "desc2", "rel1", "flow", "mask")}
    res = both(jfn, tfn, inputs, ("desc1", "desc2", "rel1"))
    check(*res, ("desc1", "desc2", "rel1"))


@pytest.mark.parametrize("sampler", ["grid", "ngh"])
def test_r2d2_loss(maps, sampler):
    names = ("rep1", "rep2", "rel1", "desc1", "desc2")

    def make(fn):
        def loss(rep1, rep2, rel1, desc1, desc2, flow, mask):
            out1 = {"repeatability": rep1, "reliability": rel1, "descriptors": desc1}
            out2 = {"repeatability": rep2, "reliability": rel1, "descriptors": desc2}
            return fn(out1, out2, flow, mask, sampler=sampler)[0]
        return loss

    inputs = {k: maps[k] for k in names + ("flow", "mask")}
    res = both(make(jl.r2d2_loss), make(tl.r2d2_loss), inputs, names)
    check(*res, names)
    jparts = jl.r2d2_loss(*({"repeatability": jnp.asarray(maps[r]),
                             "reliability": jnp.asarray(maps["rel1"]),
                             "descriptors": jnp.asarray(maps[d])}
                            for r, d in (("rep1", "desc1"), ("rep2", "desc2"))),
                          jnp.asarray(maps["flow"]), jnp.asarray(maps["mask"]),
                          sampler=sampler)[1]
    tparts = tl.r2d2_loss(*({"repeatability": torch.from_numpy(maps[r]),
                             "reliability": torch.from_numpy(maps["rel1"]),
                             "descriptors": torch.from_numpy(maps[d])}
                            for r, d in (("rep1", "desc1"), ("rep2", "desc2"))),
                          torch.from_numpy(maps["flow"]), torch.from_numpy(maps["mask"]),
                          sampler=sampler)[1]
    assert tparts.keys() == jparts.keys()
    for k in jparts:
        assert float(tparts[k]) == pytest.approx(float(jparts[k]), rel=1e-5)


def test_quantized_ap_at_bin_centres():
    """Similarities exactly on bin centres: the clip's upper bound ties there (the
    gradient splits 0.5 / 0.5), |s - c| is 0 (``jnp.abs``'s gradient is +1 there), and
    the neighbouring bins' weights sit on the lower bound. The centres are those whose
    neighbours have the same bits in both packages (XLA's CPU compiler folds the JAX
    package's ``jnp.linspace`` with a reciprocal product and a fused multiply-add, 10
    of 25 centres one ulp off its formula, which the port computes)."""
    rng = np.random.default_rng(82)
    centres = np.float32([1.0, 0.9166666269302368, 0.8333333730697632, 0.75])
    sp = rng.uniform(-1, 1, (4, 4)).astype(np.float32)
    sn = rng.uniform(-1, 1, (4, 9)).astype(np.float32)
    sp[:, 0] = centres
    sn[:, :4] = centres[None]
    res = both(lambda sim_pos, sim_neg: jl._quantized_ap(sim_pos, sim_neg).sum(),
               lambda sim_pos, sim_neg: tl._quantized_ap(sim_pos, sim_neg).sum(),
               {"sim_pos": sp, "sim_neg": sn}, ("sim_pos", "sim_neg"))
    check(*res, ("sim_pos", "sim_neg"))


def test_clip_splits_ties_like_jnp_clip():
    x = np.float32([0.0, 1.0, 0.5, -1.0, 2.0, 1e-8])
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0) * jnp.arange(1.0, 7.0)))(
        jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    (tl._clip(t, 0.0, 1.0) * torch.arange(1.0, 7.0)).sum().backward()
    assert np.array_equal(t.grad.numpy(), jg)
    assert jg[0] == 0.5 and jg[1] == 1.0          # 0.5 x 1 and 0.5 x 2


def test_bilinear_at(maps):
    rng = np.random.default_rng(83)
    xy = rng.uniform(-3, 90, (50, 2)).astype(np.float32)
    xy[:3] = [[0.0, 0.0], [79.0, 63.0], [40.0, 63.0]]
    for img in (maps["rep1"][0], maps["desc1"][0]):
        want = np.asarray(jl._bilinear_at(jnp.asarray(img), jnp.asarray(xy)))
        got = tl._bilinear_at(torch.from_numpy(img)[None], torch.from_numpy(xy)[None])[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
