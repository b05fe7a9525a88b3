"""Port parity: the monocular engine (``engine/mono.py``), the JAX package against the
port on tests/test_mono_engine.py's 10-frame 240 x 320 drive and config, on the CPU,
both engines on the JAX package's features.

Matches, accepted flags and keyframe promotions must be equal on every frame; inliers
equal up to the first frame whose count splits and within 5 after it; poses within
5e-3 m / 1e-3 rad up to that frame. Measured: the counts split on frame 4 (98 against
101 inliers: the essential polish's fp32 noise floor, tests/test_torch_mono.py); before
it the poses differ by up to 7.3e-4 m; after it by up to 0.16 m and 7.3e-3 rad. Both
engines pass tests/test_mono_engine.py's own limits (end error 0.171 m for JAX, 0.076 m
for the port).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.engine.mono import MonoVOConfig as JMonoConfig
from vo_tpu.engine.mono import MonoVOEngine as JMonoEngine
from vo_tpu.engine.pipeline import extract_and_backproject as jextract
from vo_tpu.estimation import essential as je
from vo_tpu.features import OrbLikeExtractor as JExtractor
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch.engine.mono import MonoVOConfig, MonoVOEngine
from vo_tpu_torch.estimation import essential as te


def _angle(Ra, Rb):
    R = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


K_MONO = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
ESS = dict(min_inliers=15, n_hypotheses=64, polish_starts=4)


@pytest.fixture(scope="module")
def mono_runs():
    """tests/test_mono_engine.py's 10-frame drive and config, through both engines on
    the JAX package's features."""
    imgs, deps, gt = render_sequence(10, K_MONO, H=240, W=320, step=0.8, yaw_rate=0.01)
    feats, kp3d = jextract(JExtractor(max_kp=512), jnp.asarray(imgs), jnp.asarray(deps),
                           jnp.asarray(K_MONO))
    jcfg = JMonoConfig(matcher="ratio_binary", kf_min_matches=60, kf_min_inliers=30,
                       essential=je.EssentialConfig(**ESS))
    jposes, jdiag = JMonoEngine(jcfg).run_sequence(feats.kp, feats.desc, feats.valid, kp3d,
                                                   jnp.asarray(K_MONO))
    tcfg = MonoVOConfig(matcher="ratio_binary", kf_min_matches=60, kf_min_inliers=30,
                        essential=te.EssentialConfig(**ESS))
    args = [torch.from_numpy(np.array(a)) for a in (feats.kp, feats.valid, kp3d)]
    desc = torch.from_numpy(np.array(feats.desc.astype(jnp.float32))).to(torch.bfloat16)
    tposes, tdiag = MonoVOEngine(tcfg, device="cpu").run_sequence(
        args[0], desc, args[1], args[2], torch.from_numpy(K_MONO))
    return gt, (np.asarray(jposes), jdiag), (tposes.numpy(), tdiag)


def test_mono_engine_parity(mono_runs):
    gt, (jp, jd), (tp, td) = mono_runs
    assert tp.shape == (10, 4, 4) and np.isfinite(tp).all()
    for name in ("n_matches", "accepted", "promoted_keyframe"):
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)))
    ji, ti = np.asarray(jd.n_inliers), td.n_inliers.numpy()
    split = int(np.argmax(ji != ti)) if (ji != ti).any() else len(ji)
    assert split >= 3, (ji, ti)                        # frames 1..split equal
    assert np.abs(ji - ti).max() <= 5
    held = slice(0, split + 1)                         # poses 0..split (frame split+1 differs)
    assert np.abs(tp[held, :3, 3] - jp[held, :3, 3]).max() < 5e-3
    assert max(_angle(a[:3, :3], b[:3, :3]) for a, b in zip(jp[held], tp[held])) < 1e-3


def test_mono_engine_limits(mono_runs):
    """tests/test_mono_engine.py's limits, held by both engines."""
    gt, (jp, jd), (tp, td) = mono_runs
    for poses, accept, steps in ((jp, np.asarray(jd.accepted), np.asarray(jd.step_norm)),
                                 (tp, td.accepted.numpy(), td.step_norm.numpy())):
        assert accept.mean() > 0.7
        assert abs(np.median(steps[accept]) - 0.8) < 0.2
        assert np.linalg.norm(poses[-1, :3, 3] - gt[-1, :3, 3]) < 1.0


def test_mono_config_hash_and_matchers():
    a, b = MonoVOConfig(), MonoVOConfig(use_match_kernel=False)
    assert a != b and hash(a) != hash(b)
    assert hash(MonoVOConfig()) == hash(a)
    jfields = set(JMonoConfig.__dataclass_fields__)
    assert set(MonoVOConfig.__dataclass_fields__) == jfields | {"use_match_kernel"}
    assert set(te.EssentialConfig.__dataclass_fields__) == set(
        je.EssentialConfig.__dataclass_fields__)
    for name in jfields - {"essential"}:
        assert getattr(a, name) == getattr(JMonoConfig(), name), name
    with pytest.raises(ValueError, match="unknown matcher"):
        MonoVOEngine(MonoVOConfig(matcher="nope"), device="cpu")._match(
            torch.ones(4, 8), torch.ones(4, 8), torch.ones(4, dtype=torch.bool),
            torch.ones(4, dtype=torch.bool))
