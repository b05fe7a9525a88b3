"""Port parity on an adversarial drive: the faults of the JAX bench's adversarial
workload (``bench.py:448-457``), scaled down to a 24-frame straight drive at 240 x 320
(512 keypoints, 256 hypotheses), through both packages' ``run_offline_vo`` on the CPU.

Faults, drawn with rng 8214 in bench.py's order: frames 6-7 textureless (128 plus
noise of sigma 2), then 85 % of the depth pixels dropped on frames 12-15.

Tolerances and their reasons: the accepted flags (the pose-hold path) equal on every
frame; inlier counts within 2; poses within 5e-3 m and 1e-3 rad (PERF.md section 2) up
to the first frame whose inlier count splits, within 5e-2 m and 5e-3 after it. Each
package extracts its own features (exact: the main path's extractor), so the engines
see the same inputs; where PnP-RANSAC has near-tied solutions, the two packages' fp32
sums pick different ones, and the frames after it chain from there (measured: frame
5, 198 against 197 inliers, 1.2 cm apart; at most 4.1 cm on later frames; ROADMAP
section 3, PnP near-ties).
"""

import dataclasses

import numpy as np
import pytest

from vo_tpu.engine.pipeline import run_offline_vo as jrun
from vo_tpu.engine.vo import VOConfig
from vo_tpu.estimation.pnp import PnPConfig
from vo_tpu.features.extractor import OrbLikeExtractor
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch.engine.pipeline import run_offline_vo as trun
from vo_tpu_torch.port_state import config_from_jax

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
CFG = VOConfig(matcher="ratio_binary", kf_min_matches=60, kf_min_inliers=30,
               pnp=PnPConfig(min_inliers=15, n_hypotheses=256))
EXTRACTOR = OrbLikeExtractor(max_kp=512)
TEXTURELESS, DROPOUT = slice(6, 8), slice(12, 16)


@pytest.fixture(scope="module")
def degraded():
    imgs, deps, gt = render_sequence(24, K, H=240, W=320, step=0.8, yaw_rate=0.0)
    rng = np.random.default_rng(8214)
    imgs[TEXTURELESS] = 128.0 + 2.0 * rng.standard_normal(
        imgs[TEXTURELESS].shape).astype(np.float32)
    drop = rng.uniform(size=deps[DROPOUT].shape) < 0.85
    deps[DROPOUT] = np.where(drop, 0.0, deps[DROPOUT])
    return imgs, deps, gt


def test_adversarial_drive_vs_jax(degraded):
    imgs, deps, gt = degraded
    jposes, jdiag = jrun(imgs, deps, K, vo_config=CFG, extractor=EXTRACTOR,
                         extraction_batch=8)
    tposes, tdiag = trun(imgs, deps, K, vo_config=config_from_jax(dataclasses.asdict(CFG)),
                         extractor=config_from_jax(dataclasses.asdict(EXTRACTOR)),
                         extraction_batch=8, device="cpu")
    jposes, accepted = np.asarray(jposes), np.asarray(jdiag.accepted)
    np.testing.assert_array_equal(tdiag.accepted, accepted)
    # The textureless frames are held (pose-hold); the drive recovers after them and
    # through the dropout window.
    assert not accepted[TEXTURELESS.start - 1:TEXTURELESS.stop - 1].any()
    assert 0.8 < accepted.mean() < 1.0
    assert np.linalg.norm(tposes[-1, :3, 3] - gt[-1, :3, 3]) < 0.5

    inl_t, inl_j = tdiag.n_inliers, np.asarray(jdiag.n_inliers)
    assert np.abs(inl_t - inl_j).max() <= 2
    split = int(np.argmax(inl_t != inl_j)) if (inl_t != inl_j).any() else len(inl_t)
    np.testing.assert_allclose(tposes[:split + 1, :3, 3], jposes[:split + 1, :3, 3],
                               atol=5e-3)
    np.testing.assert_allclose(tposes[:split + 1, :3, :3], jposes[:split + 1, :3, :3],
                               atol=1e-3)
    np.testing.assert_allclose(tposes[:, :3, 3], jposes[:, :3, 3], atol=5e-2)
    np.testing.assert_allclose(tposes[:, :3, :3], jposes[:, :3, :3], atol=5e-3)
