"""Port parity: the SIFT-config path (DoG + oriented gradhist + the ``ratio_float``
matcher), the JAX package against the port on the same numpy inputs, on the CPU, at
240 x 320 with 512 keypoints and 3 scales.

Tolerances and their reasons:
- ``resize_bilinear`` and ``dog_response``: 1e-5 of the map's largest magnitude. Both
  are fp32 sums in another order (the two resize products are contracted in another
  order than XLA's einsum; XLA fuses the blur chains). Measured: 4.2e-6 and 1.3e-6.
- ``dense_orientation_planes``: 2e-6 of the largest plane value (``atan2`` and ``sqrt``
  from another fp32 library, then summed by the blurs). Measured 2.5e-7.
- gradhist descriptors from the same (JAX-computed) planes and keypoints: every bf16
  value within 1 ulp (the norms are fp32 sums in another order, which can move a
  value across a bf16 rounding boundary).
- the extractors (multi-scale, and single-scale with DoG + gradhist): validity exact;
  the kept keypoints the same set but for a few near-tied candidates at the budget's
  cut (the last bits of the response decide them, and one swap shifts every later
  rank): at most 1 % of each frame's set differs; measured 0-13 of 512. Descriptors of
  the keypoints both keep within 1 bf16 ulp, but for the oriented variant's few rows
  where a turned cell centre lies on a rounding boundary (at most 1 % of the rows).
- the matcher on gradhist-like fp32 descriptors: top-2 similarities 1e-5 (fp32 sums),
  indices equal wherever best - second > 1e-4.
- an 8-frame engine run on the JAX extractor's features: per-frame diagnostics equal,
  n_inliers within 2, poses within 5e-3 m and 1e-3 rad (PERF.md section 2); measured
  1.8e-4 m. The frames are a straight drive: on turning ones (yaw rate 0.01-0.02 rad
  per frame) the matches stay identical, but with ~100-150 of them PnP-RANSAC has
  near-tied solutions on about one frame in eight, where the two packages' fp32 sums
  pick different ones (inlier counts 1-2 apart, that frame 4-11 cm apart; ROADMAP
  section 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.engine import pipeline as jpipe
from vo_tpu.engine.vo import VOConfig as JVOConfig
from vo_tpu.engine.vo import VOEngine as JEngine
from vo_tpu.estimation.pnp import PnPConfig as JPnPConfig
from vo_tpu.features import detect as jdet
from vo_tpu.features import gradhist as jgh
from vo_tpu.features.extractor import OrbLikeExtractor as JOrb
from vo_tpu.features.pyramid import MultiScaleClassicExtractor as JMulti
from vo_tpu.ops import image as jimg
from vo_tpu.ops.pallas_match import top2_mutual_pallas
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch.engine.vo import VOEngine as TEngine
from vo_tpu_torch.features import detect as tdet
from vo_tpu_torch.features import gradhist as tgh
from vo_tpu_torch.features.extractor import OrbLikeExtractor as TOrb
from vo_tpu_torch.features.pyramid import MultiScaleClassicExtractor as TMulti
from vo_tpu_torch.ops import image as timg
from vo_tpu_torch.ops import match as tmatch
from vo_tpu_torch.ops.match_timing import sift_like
from vo_tpu_torch.port_state import config_from_jax

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
SIFT = dict(max_kp=512, n_scales=3, response="dog", descriptor="gradhist", oriented=True)
JCFG = JVOConfig(matcher="ratio_float", ratio=0.85, kf_min_matches=60, kf_min_inliers=30,
                 pnp=JPnPConfig(min_inliers=15, n_hypotheses=256))


@pytest.fixture(scope="module")
def frames():
    imgs, deps, _ = render_sequence(8, K, H=240, W=320, step=0.8, yaw_rate=0.0)
    return imgs, deps


@pytest.fixture(scope="module")
def jax_features(frames):
    """The JAX multi-scale extractor's features and keypoint depths, as numpy."""
    imgs, deps = frames
    feats, kp3d = jpipe.extract_and_backproject(JMulti(**SIFT), jnp.asarray(imgs),
                                                jnp.asarray(deps), jnp.asarray(K))
    return (*(np.asarray(x, np.float32 if x.dtype == jnp.bfloat16 else None)
              for x in feats), np.asarray(kp3d))


@pytest.fixture(scope="module")
def jax_planes(frames):
    return np.asarray(jgh.dense_orientation_planes(jnp.asarray(frames[0][:2])))


def _close(got, ref, rel):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def _bf16_ulps(a, b):
    """|a - b| in bf16 units in the last place, per element (same-sign values)."""
    bits = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)
            .view(torch.int16).numpy().astype(np.int64) for x in (a, b)]
    return np.abs(bits[0] - bits[1])


@pytest.mark.parametrize("hw", [(170, 226), (120, 160), (85, 113)])
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_bilinear_vs_jax(frames, hw, channels):
    x = frames[0][:2] if channels == 0 else np.random.default_rng(91).uniform(
        0, 1, (2, 240, 320, channels)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jimg.resize_bilinear(a, hw))(jnp.asarray(x)))
    got = timg.resize_bilinear(torch.from_numpy(x), hw).numpy()
    assert got.shape == ref.shape
    _close(got, ref, 1e-5)
    _close(timg._resize_matrix(320, hw[1]).numpy(), np.asarray(jimg._resize_matrix(320, hw[1])),
           1e-6)


def test_dog_response_vs_jax(frames):
    x = frames[0][:2]
    got = tdet.dog_response(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(jax.jit(jdet.dog_response)(jnp.asarray(x))), 1e-5)
    _close(got, np.asarray(jdet.dog_response(jnp.asarray(x))), 1e-5)


def test_dense_orientation_planes_vs_jax(frames, jax_planes):
    got = tgh.dense_orientation_planes(torch.from_numpy(frames[0][:2])).numpy()
    assert got.shape == jax_planes.shape == (2, 240, 320, 8)
    _close(got, jax_planes, 2e-6)


@pytest.mark.parametrize("oriented", [False, True], ids=["upright", "oriented"])
def test_gradhist_on_jax_planes(frames, jax_planes, oriented):
    """Both descriptor variants on the JAX package's planes and keypoints."""
    gray = jnp.asarray(frames[0][:2])
    kp, _, valid = jdet.detect_keypoints(jdet.dog_response(gray), max_kp=512, border=21)
    kp, valid = np.asarray(kp), np.asarray(valid)
    if oriented:
        ref = jgh.oriented_gradhist_descriptors(gray, jnp.asarray(kp), jnp.asarray(valid))
        fn = tgh.gather_oriented_gradhist_descriptors
    else:
        ref = jgh.gather_gradhist_descriptors(jnp.asarray(jax_planes), jnp.asarray(kp),
                                              jnp.asarray(valid))
        fn = tgh.gather_gradhist_descriptors
    got = fn(*(torch.from_numpy(x) for x in (jax_planes, kp, valid)))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 512, 128)
    assert _bf16_ulps(got.float().numpy(), np.asarray(ref, np.float32)).max() <= 1
    assert valid.sum() > 800


def _compare_features(t, jkp, jdesc, jvalid, max_far_rows):
    """The port's features against the JAX package's, keypoint by keypoint."""
    np.testing.assert_array_equal(t.valid.numpy(), jvalid)
    tkp, tdesc = t.kp.numpy(), t.desc.float().numpy()
    far = 0
    for f in range(jkp.shape[0]):
        jrows = {tuple(p): r for r, p in enumerate(jkp[f]) if jvalid[f, r]}
        common = [(r, jrows[tuple(p)]) for r, p in enumerate(tkp[f])
                  if jvalid[f, r] and tuple(p) in jrows]
        assert len(jrows) - len(common) <= 0.01 * len(jrows)
        tr, jr = (np.array(x) for x in zip(*common))
        ulps = _bf16_ulps(tdesc[f, tr], jdesc[f, jr]).max(-1)
        far += int((ulps > 1).sum())
    assert far <= max_far_rows


def test_multiscale_extractor_vs_jax(frames, jax_features):
    imgs, _ = frames
    jkp, jdesc, jscore, jvalid, _ = jax_features
    t = TMulti(**SIFT)(imgs, device="cpu")
    assert jvalid.sum() > 3000
    _compare_features(t, jkp, jdesc, jvalid, max_far_rows=0.01 * jvalid.sum())
    np.testing.assert_allclose(t.score.numpy(), jscore, rtol=0,
                               atol=1e-5 * np.abs(jscore).max())


def test_orb_like_dog_gradhist_vs_jax(frames):
    """The single-scale extractor with the options this slice lifts (DoG response,
    upright gradhist)."""
    imgs = frames[0][:2]
    kw = dict(max_kp=512, response="dog", descriptor="gradhist")
    j = JOrb(**kw)(jnp.asarray(imgs))
    t = TOrb(**kw)(imgs, device="cpu")
    assert t.desc.dtype == torch.bfloat16 and np.asarray(j.valid).sum() > 900
    _compare_features(t, np.asarray(j.kp), np.asarray(j.desc, np.float32),
                      np.asarray(j.valid), max_far_rows=0)


def test_top2_plain_vs_pallas_on_gradhist_like():
    a, b, va, vb = sift_like(np.random.default_rng(92), 512, 600)
    nn12, top2, nn21 = tmatch.top2_mutual_plain(
        *(torch.from_numpy(x) for x in (a, b, va, vb)), bf16=False)
    p12, ptop2, p21 = (np.asarray(x) for x in top2_mutual_pallas(
        *(jnp.asarray(x) for x in (a, b, va, vb)), interpret=True, bf16=False))
    np.testing.assert_allclose(top2.numpy(), ptop2, rtol=1e-5, atol=1e-5)
    sure = ptop2[:, 0] - ptop2[:, 1] > 1e-4
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(nn12.numpy()[sure], p12[sure])
    col = np.sort(a @ b.T * va[:, None] * vb[None, :], axis=0)
    col_sure = col[-1] - col[-2] > 1e-4
    np.testing.assert_array_equal(nn21.numpy()[col_sure & vb], p21[col_sure & vb])


def test_ratio_float_engine_vs_jax(jax_features):
    """Both engines on the JAX extractor's features: the port's ``ratio_float``
    matcher goes through ``top2_mutual`` (its plain version on the CPU)."""
    kp, desc, _, valid, kp3d = jax_features
    jposes, jdiag = JEngine(JCFG).run_sequence(
        *(jnp.asarray(x) for x in (kp, desc.astype(jnp.bfloat16), valid, kp3d, K)))
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    assert cfg.matcher == "ratio_float" and cfg.use_match_kernel
    t = [torch.from_numpy(x) for x in (kp, desc, valid, kp3d, K)]
    t[1] = t[1].to(torch.bfloat16)
    tposes, tdiag = TEngine(cfg, device="cpu").run_sequence(*t)
    for f in ("n_matches", "accepted", "promoted_keyframe"):
        np.testing.assert_array_equal(getattr(tdiag, f).numpy(), np.asarray(getattr(jdiag, f)),
                                      err_msg=f)
    assert np.abs(tdiag.n_inliers.numpy().astype(np.int64)
                  - np.asarray(jdiag.n_inliers, np.int64)).max() <= 2
    jposes, tposes = np.asarray(jposes, np.float64), tposes.numpy().astype(np.float64)
    assert np.abs(tposes[:, :3, 3] - jposes[:, :3, 3]).max() < 5e-3
    rot = np.linalg.norm(tposes[:, :3, :3] - jposes[:, :3, :3], axis=(1, 2)) / np.sqrt(2)
    assert rot.max() < 1e-3
    assert np.asarray(jdiag.accepted).all() and np.asarray(jdiag.n_matches).min() > 100
