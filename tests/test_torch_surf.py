"""Port parity: the SURF-style front-end (``features/surf.py``: box-filter Hessian +
upright Haar SURF-64), the JAX package against the port on the same numpy inputs, on
the CPU, at 240 x 320 with 512 keypoints.

Tolerances and their reasons:
- ``hessian_response`` and ``dense_haar_planes``: 1e-5 of the map's largest
  magnitude. The box sums are the same shift-and-add sums in the same order (bit-equal
  to JAX un-jitted), but XLA's jitted CPU fusion contracts multiply-adds.
- ``gather_surf_descriptors`` on the same (JAX-computed) planes and keypoints: every
  bf16 value within 1 ulp (the L2 norm is an fp32 sum in another order, which can move
  a value across a bf16 rounding boundary).
- the extractors: validity exact; the kept keypoints the same set but for a few
  near-tied candidates at the budget's cut (at most 1 % of each frame's set); the
  descriptors of the keypoints both keep within 1 bf16 ulp, but for at most 1 % of
  the rows on the multi-scale extractor's resized levels (within 1e-3: see
  ``_same_features``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.config import RunConfig as JRunConfig
from vo_tpu.features import surf as jsurf
from vo_tpu.features.extractor import OrbLikeExtractor as JOrb
from vo_tpu.features.pyramid import MultiScaleClassicExtractor as JMulti
from vo_tpu.runners import vo_run as jvo_run
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch.config import RunConfig as TRunConfig
from vo_tpu_torch.features import surf as tsurf
from vo_tpu_torch.features.extractor import OrbLikeExtractor as TOrb
from vo_tpu_torch.features.pyramid import MultiScaleClassicExtractor as TMulti
from vo_tpu_torch.runners import vo_run as tvo_run

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
SURF = dict(response="hessian", descriptor="surf")


@pytest.fixture(scope="module")
def frames():
    imgs, _, _ = render_sequence(3, K, H=240, W=320, step=0.8, yaw_rate=0.01)
    return imgs


def _close_scaled(got, ref, rel):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def test_box_sum_and_shift_exact():
    """The helpers against JAX un-jitted: even and odd sizes, both axes, both shift
    directions."""
    x = np.random.default_rng(71).normal(size=(2, 30, 41)).astype(np.float32)
    with jax.disable_jit():
        for size in (2, 3, 4, 9):
            for axis in (1, 2):
                np.testing.assert_array_equal(
                    tsurf._box_sum_1d(torch.from_numpy(x), size, axis).numpy(),
                    np.asarray(jsurf._box_sum_1d(jnp.asarray(x), size, axis)))
        for d in (-3, 0, 2):
            for axis in (1, 2):
                np.testing.assert_array_equal(
                    tsurf._shift(torch.from_numpy(x), d, axis).numpy(),
                    np.asarray(jsurf._shift(jnp.asarray(x), d, axis)))


def test_hessian_response_vs_jax(frames):
    got = tsurf.hessian_response(torch.from_numpy(frames)).numpy()
    _close_scaled(got, np.asarray(jsurf.hessian_response(jnp.asarray(frames))), 1e-5)


def test_dense_haar_planes_vs_jax(frames):
    got = tsurf.dense_haar_planes(torch.from_numpy(frames)).numpy()
    ref = np.asarray(jsurf.dense_haar_planes(jnp.asarray(frames)))
    assert got.shape == ref.shape == frames.shape + (4,)
    _close_scaled(got, ref, 1e-5)


def _rows_beyond_one_ulp(got, ref):
    """Which rows of bf16 values (as fp32) hold a value more than one bf16 ulp off."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    return (np.abs(got - ref) > ulp * 1.0001).any(axis=-1)


def _within_one_ulp(got, ref):
    assert not _rows_beyond_one_ulp(got, ref).any()


def test_gather_surf_descriptors_on_jax_planes(frames):
    feats = JOrb(max_kp=512, **SURF)(jnp.asarray(frames))
    pooled = jsurf.dense_haar_planes(jnp.asarray(frames))
    ref = np.asarray(jsurf.gather_surf_descriptors(pooled, feats.kp, feats.valid),
                     np.float32)
    got = tsurf.gather_surf_descriptors(
        torch.from_numpy(np.asarray(pooled).copy()), torch.from_numpy(np.asarray(feats.kp).copy()),
        torch.from_numpy(np.asarray(feats.valid).copy()))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 512, 64)
    _within_one_ulp(got.float().numpy(), ref)


def _same_features(t, j, resized=False):
    """Validity exact; keypoint sets equal but for near-ties at the cut; the common
    keypoints' descriptors within 1 bf16 ulp. ``resized``: levels resized from the
    frame, whose pixels differ by up to 4.2e-6 of the image's scale
    (``resize_bilinear``'s row sums, ROADMAP section 3); a Haar value is a difference
    of box sums, so a value near 0 can move by more than an ulp there: at most 1 % of
    the rows, each within 1e-3 (measured: 1 row of 1536, 4.9e-4)."""
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    tkp, jkp = t.kp.numpy(), np.asarray(j.kp)
    tdesc, jdesc = t.desc.float().numpy(), np.asarray(j.desc, np.float32)
    for f in range(tkp.shape[0]):
        tk = {tuple(p): i for i, p in enumerate(tkp[f])}
        common = [(tk[tuple(p)], i) for i, p in enumerate(jkp[f]) if tuple(p) in tk]
        assert len(common) >= 0.99 * len(jkp[f]), len(common)
        ti, ji = np.array(common).T
        off = _rows_beyond_one_ulp(tdesc[f, ti], jdesc[f, ji])
        if resized:
            assert off.sum() <= 0.01 * len(ti), off.sum()
            assert np.abs(tdesc[f, ti] - jdesc[f, ji]).max() <= 1e-3
        else:
            assert not off.any(), off.sum()


def test_orb_like_surf_vs_jax(frames):
    j = JOrb(max_kp=512, **SURF)(jnp.asarray(frames))
    t = TOrb(max_kp=512, **SURF)(frames, device="cpu")
    assert t.desc.shape == (3, 512, 64) and t.desc.dtype == torch.bfloat16
    assert t.valid.sum() > 400
    _same_features(t, j)


def test_multiscale_surf_vs_jax(frames):
    j = JMulti(max_kp=512, n_scales=3, **SURF)(jnp.asarray(frames))
    t = TMulti(max_kp=512, n_scales=3, **SURF)(frames, device="cpu")
    assert t.desc.shape == (3, 512, 64)
    _same_features(t, j, resized=True)


@pytest.mark.parametrize("octaves", [1, 2])
def test_build_extractor_surf(frames, octaves, tmp_path):
    """``feature_extractor: surf`` builds the JAX package's extractor (same fields),
    and the config maps it to ``ratio_float`` at 0.85."""
    path = tmp_path / "surf.yaml"
    path.write_text(f"feature_extractor: surf\nmax_keypoints: 256\noctaves: {octaves}\n")
    jcfg, tcfg = JRunConfig.from_yaml(str(path)), TRunConfig.from_yaml(str(path))
    jex, tex = jvo_run.build_extractor(jcfg), tvo_run.build_extractor(tcfg)
    assert type(tex).__name__ == type(jex).__name__
    assert dataclasses.asdict(tex) == dataclasses.asdict(jex)
    assert (tcfg.vo.matcher, tcfg.vo.ratio) == (jcfg.vo.matcher, jcfg.vo.ratio) == (
        "ratio_float", 0.85)
    _same_features(tex(frames, device="cpu"), jex(jnp.asarray(frames)), resized=octaves > 1)
