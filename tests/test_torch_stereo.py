"""Port parity: the true-stereo front-end (``features/stereo.py::stereo_depth_at`` and
``engine/pipeline.py::stereo_extract_and_backproject``), the JAX package against the
port on the same numpy inputs, on the CPU, at 240 x 320.

Tolerances and their reasons:
- window sums (the box sums of each image, its square and the product at every
  disparity): bit-equal to dense box-summed planes read at the keypoints (the port
  sums per-keypoint windows in the same order as the JAX package's planes).
- depth: rtol 1e-4 where both packages report ``ok``. The scores are the same sums,
  but torch's CPU ``sqrt`` is not always correctly rounded where XLA's is, and XLA's
  jitted CPU fusion contracts multiply-adds, so scores differ in the last bits
  (measured 1.5e-8), which move the parabola's sub-pixel step (measured 2.9e-5).
- ``ok`` masks: equal but for at most 2 keypoints whose best score ties the 0.5
  threshold or whose first maximum is a near-tie (measured 0).
- against the JAX function with ``jax.disable_jit`` (no XLA fusion): depth rtol 1e-5
  (measured 3e-7 to 1e-6: ``sqrt`` alone).
- the front-end on 4 frames: features exact (the extractor is the main path's);
  keypoint 3-D points rtol 1e-3 where both have depth (a flat correlation peak
  turns last-bit score differences into sub-pixel steps: the JAX package's own
  jitted and un-jitted runs differ by up to 3.5e-4, the port and the un-jitted run by
  3e-7), depth presence equal but for at most 2 keypoints per frame.
- an 8-frame stereo engine run on the JAX front-end's features, a straight drive:
  accepted flags and match counts equal, inlier counts within 2, poses within 5e-3 m
  and 1e-3 rad (PERF.md section 2) up to the first frame whose inlier count splits,
  and within 0.1 m and 1e-2 after it. Stereo depth is quantised by the disparity, so
  more inliers sit on the threshold than with rendered depth: on frame 5 the two
  packages' fp32 sums pick near-tied PnP solutions (132 against 131 inliers, 6.5 cm
  apart, both within 8.3 cm of the ground truth; ROADMAP section 3, PnP near-ties),
  and the frames after it chain from there. The port's own front-end and engine are
  held to the ground truth (tests/test_stereo.py's end-to-end bar).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_stereo import BASELINE, K as K_PAIR, make_stereo_pair
from vo_tpu.engine import pipeline as jpipe
from vo_tpu.engine.vo import VOConfig as JVOConfig
from vo_tpu.engine.vo import VOEngine as JEngine
from vo_tpu.estimation.pnp import PnPConfig as JPnPConfig
from vo_tpu.features.extractor import OrbLikeExtractor as JOrb
from vo_tpu.features.stereo import stereo_depth_at as jstereo
from vo_tpu.utils.synthetic import render_rgbd, render_sequence
from vo_tpu_torch.engine.pipeline import stereo_extract_and_backproject
from vo_tpu_torch.engine.vo import VOEngine as TEngine
from vo_tpu_torch.features import stereo as tst
from vo_tpu_torch.features.extractor import OrbLikeExtractor as TOrb
from vo_tpu_torch.ops.image import _conv1d, gaussian_blur
from vo_tpu_torch.port_state import config_from_jax

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
JCFG = JVOConfig(matcher="ratio_binary", kf_min_matches=60, kf_min_inliers=30,
                 pnp=JPnPConfig(min_inliers=15, n_hypotheses=256))


@pytest.fixture(scope="module")
def pair():
    left, right, dep = make_stereo_pair()
    feats = JOrb(max_kp=256)(jnp.asarray(left[None]))
    return left, right, dep, np.asarray(feats.kp[0]), np.asarray(feats.valid[0])


@pytest.fixture(scope="module")
def stereo_frames():
    """8 frames of a straight drive, left and right eyes (0.54 m baseline)."""
    imgs, _, traj = render_sequence(8, K, H=240, W=320, step=0.8, yaw_rate=0.0)
    shift = np.eye(4)
    shift[0, 3] = BASELINE
    rights = np.stack([render_rgbd(T @ shift, K, H=240, W=320)[0] for T in traj])
    return imgs, rights, traj


def test_window_sums_equal_dense_planes(pair):
    """The per-keypoint window sums are the dense box-summed planes of the JAX
    formulation (left * roll(right, d), each image and its square), read at the
    keypoints: bit for bit, at every disparity."""
    left, right, _, kp, _ = pair
    D, P = 40, 9
    lg = gaussian_blur(torch.from_numpy(left)[None], 1.0)
    rg = gaussian_blur(torch.from_numpy(right)[None], 1.0)
    xi = torch.tensor(kp[:, 0]).to(torch.int32).clamp(4 + D, 320 - 5).long()[None]
    yi = torch.tensor(kp[:, 1]).to(torch.int32).clamp(4, 240 - 5).long()[None]
    bl, blsq, br, brsq, cross = (x[0] for x in tst._window_sums(lg, rg, xi, yi, D, P))

    def box(img):
        return _conv1d(_conv1d(img, [1.0] * P, axis=1), [1.0] * P, axis=2)[0]

    at = (yi[0], xi[0])
    assert torch.equal(bl, box(lg)[at]) and torch.equal(blsq, box(lg * lg)[at])
    for d in range(D):
        u = D - 1 - d
        assert torch.equal(br[:, u], torch.roll(box(rg), d, dims=1)[at])
        assert torch.equal(brsq[:, u], torch.roll(box(rg * rg), d, dims=1)[at])
        assert torch.equal(cross[:, u], box(lg * torch.roll(rg, d, dims=2))[at])


def _scan(S):
    """The JAX package's scan body (stereo.py:87-101), one disparity at a time."""
    K_n, D = S.shape
    best = np.full(K_n, -np.inf, np.float32)
    bestd = np.zeros(K_n, np.int64)
    sm, sp = np.zeros(K_n, np.float32), np.zeros(K_n, np.float32)
    prev = np.full(K_n, -np.inf, np.float32)
    with np.errstate(invalid="ignore"):
        for d in range(D):
            s = S[:, d]
            sp = np.where(bestd == d - 1, s, sp)
            new = s > best
            sm = np.where(new, prev, sm)
            sp = np.where(new, 0.0, sp)
            bestd = np.where(new, d, bestd)
            best = np.maximum(best, s)
            prev = s
    return best, bestd, sm, sp


def test_scan_reduction_matches_the_scan():
    """First maximum on ties, the neighbours the scan captured, NaN never the best
    (and poisoning the running maximum), endpoints."""
    rng = np.random.default_rng(61)
    S = np.round(rng.uniform(-1, 1, (400, 24)), 1).astype(np.float32)   # many ties
    S[0, 0] = 5.0                                        # peak at d = 0
    S[1, -1] = 5.0                                       # peak at the last d
    S[2, 3] = np.nan
    S[3, 10], S[3, 2] = 5.0, np.nan                      # NaN before the peak
    S[4, 0] = np.nan                                     # NaN first
    S[5, 7], S[5, 8] = 5.0, np.nan                       # NaN right after the peak
    best, bestd, sm, sp = (x.numpy() for x in tst._reduce_scan(torch.from_numpy(S)))
    rbest, rbestd, rsm, rsp = _scan(S)
    np.testing.assert_array_equal(bestd, rbestd)
    np.testing.assert_array_equal(best, rbest)
    inner = (rbestd > 0) & (rbestd < S.shape[1] - 1)     # where the parabola reads them
    np.testing.assert_array_equal(sm[inner], rsm[inner])
    np.testing.assert_array_equal(sp[inner], rsp[inner])
    assert np.isnan(best[[2, 3, 4, 5]]).all() and bestd[3] < 2 and bestd[5] == 7


def test_stereo_depth_at_vs_jax(pair):
    """max_disp 96 on tests/test_stereo.py's pair: depth rtol 1e-4 where both report
    ok, ok masks equal but for at most 2 keypoints, and the depths within
    tests/test_stereo.py's limits against the rendered depth."""
    left, right, dep_gt, kp, valid = pair
    jd, jok = (np.asarray(x) for x in jstereo(jnp.asarray(left), jnp.asarray(right),
                                             jnp.asarray(kp), jnp.asarray(valid),
                                             jnp.asarray(K_PAIR), BASELINE, max_disp=96))
    td, tok = tst.stereo_depth_at(left, right, kp, valid, K_PAIR, BASELINE, max_disp=96,
                                  device="cpu")
    assert td.dtype == torch.float32 and tok.shape == (256,)
    td, tok = td.numpy(), tok.numpy()
    assert (jok != tok).sum() <= 2, (jok != tok).sum()
    both = jok & tok
    assert both.sum() > 40
    np.testing.assert_allclose(td[both], jd[both], rtol=1e-4)
    import jax

    with jax.disable_jit():
        ed, eok = (np.asarray(x) for x in jstereo(
            jnp.asarray(left), jnp.asarray(right), jnp.asarray(kp), jnp.asarray(valid),
            jnp.asarray(K_PAIR), BASELINE, max_disp=96))
    np.testing.assert_array_equal(tok, eok)
    np.testing.assert_allclose(td, ed, rtol=1e-5)
    gt = dep_gt[kp[tok, 1].astype(int), kp[tok, 0].astype(int)]
    rel_err = np.abs(td[tok] - gt) / gt
    assert np.median(rel_err) < 0.05 and (rel_err < 0.15).mean() > 0.8


def test_textureless_pair_has_no_depth():
    flat = np.full((240, 320), 128.0, np.float32)
    kp = np.array([[200.0, 100.0], [250.0, 150.0]], np.float32)
    valid = np.ones(2, bool)
    _, jok = jstereo(jnp.asarray(flat), jnp.asarray(flat), jnp.asarray(kp),
                     jnp.asarray(valid), jnp.asarray(K_PAIR), BASELINE, max_disp=96)
    _, tok = tst.stereo_depth_at(flat, flat, kp, valid, K_PAIR, BASELINE, max_disp=96,
                                 device="cpu")
    assert not np.asarray(jok).any() and not tok.any()


def test_stereo_extract_and_backproject_vs_jax(stereo_frames):
    lefts, rights, _ = stereo_frames
    lefts, rights = lefts[:4], rights[:4]
    jf, jk3 = jpipe.stereo_extract_and_backproject(
        JOrb(max_kp=512), jnp.asarray(lefts), jnp.asarray(rights), jnp.asarray(K),
        BASELINE, max_disp=96)
    tf, tk3 = stereo_extract_and_backproject(TOrb(max_kp=512), lefts, rights, K, BASELINE,
                                             max_disp=96, device="cpu")
    np.testing.assert_array_equal(tf.kp.numpy(), np.asarray(jf.kp))
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    np.testing.assert_array_equal(tf.desc.float().numpy(), np.asarray(jf.desc, np.float32))
    jk3, tk3 = np.asarray(jk3), tk3.numpy()
    jz, tz = jk3[..., 2] > 0, tk3[..., 2] > 0
    assert ((jz != tz).sum(axis=1) <= 2).all(), (jz != tz).sum(axis=1)
    assert (jz & tz).sum(axis=1).min() >= 100
    np.testing.assert_allclose(tk3[jz & tz], jk3[jz & tz], rtol=1e-3, atol=1e-6)


def test_stereo_engine_vs_jax(stereo_frames):
    """8 frames of a straight drive: both engines on the JAX stereo front-end's
    features, then the port's own front-end and engine against the ground truth
    (tests/test_stereo.py's end-to-end bar)."""
    lefts, rights, traj = stereo_frames
    jf, jk3 = jpipe.stereo_extract_and_backproject(
        JOrb(max_kp=512), jnp.asarray(lefts), jnp.asarray(rights), jnp.asarray(K),
        BASELINE, max_disp=96)
    jposes, jdiag = JEngine(JCFG).run_sequence(jf.kp, jf.desc, jf.valid, jk3,
                                               jnp.asarray(K))
    engine = TEngine(config_from_jax(dataclasses.asdict(JCFG)), device="cpu")
    as_t = (lambda x: torch.from_numpy(np.asarray(x, np.float32 if x.dtype == jnp.bfloat16
                                                  else None).copy()))
    tposes, tdiag = engine.run_sequence(as_t(jf.kp), as_t(jf.desc).to(torch.bfloat16),
                                        as_t(jf.valid), as_t(jk3), torch.from_numpy(K))
    jposes, tposes = np.asarray(jposes), tposes.numpy()
    for field in ("accepted", "n_matches"):
        np.testing.assert_array_equal(getattr(tdiag, field).numpy(),
                                      np.asarray(getattr(jdiag, field)))
    assert np.asarray(jdiag.accepted).all()
    inl_t, inl_j = tdiag.n_inliers.numpy(), np.asarray(jdiag.n_inliers)
    assert np.abs(inl_t - inl_j).max() <= 2
    # Up to the first frame whose inlier count splits, the poses agree at 5e-3 m and
    # 1e-3 rad; from there on, both sit on near-tied solutions (measured: frame 5,
    # 132 against 131 inliers, 6.5 cm apart; both within 8.3 cm of the ground truth).
    split = int(np.argmax(inl_t != inl_j)) if (inl_t != inl_j).any() else len(inl_t)
    assert split >= 3
    np.testing.assert_allclose(tposes[:split + 1, :3, 3], jposes[:split + 1, :3, 3],
                               atol=5e-3)
    np.testing.assert_allclose(tposes[:split + 1, :3, :3], jposes[:split + 1, :3, :3],
                               atol=1e-3)
    np.testing.assert_allclose(tposes[:, :3, 3], jposes[:, :3, 3], atol=0.1)
    np.testing.assert_allclose(tposes[:, :3, :3], jposes[:, :3, :3], atol=1e-2)

    tf, tk3 = stereo_extract_and_backproject(TOrb(max_kp=512), lefts, rights, K, BASELINE,
                                             max_disp=96, device="cpu")
    own, diag = engine.run_sequence(tf.kp, tf.desc, tf.valid, tk3, torch.from_numpy(K))
    assert diag.accepted.all()
    assert np.linalg.norm(own.numpy()[-1, :3, 3] - traj[-1, :3, 3]) < 0.5
