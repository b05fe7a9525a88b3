"""Port parity: oriented BRIEF (``features/brief.py``) and ``OrbLikeExtractor(
oriented=True)``, the JAX package against the port on the same numpy inputs, on the
CPU, at 240 x 320 with 512 keypoints.

Tolerances and their reasons:
- ``brief_offsets``: the same bytes (both draw from numpy's ``default_rng(8214)``).
- ``_extract_patches``: exact (a gather).
- ``_orientation`` on the same patches: the moments are fp32 sums over 41 x 41
  patches whose positive and negative halves cancel, so the order of the sum shows.
  Against the same sums in float64, the port's cos and sin are within 5e-5 (measured
  3.3e-5) and the JAX package's within 6.3e-4 (measured, jitted or not): the two
  packages are held within 1e-3 of each other.
- descriptors: equal on at least 99.9 % of the bits. A bit compares two bilinear
  samples at the pattern turned by that orientation, and XLA's jitted CPU code
  contracts the interpolation's multiply-adds, so two near-equal samples can compare
  the other way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.features import brief as jbrief
from vo_tpu.features.extractor import OrbLikeExtractor as JOrb
from vo_tpu.ops.image import gaussian_blur as jblur
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch.features import brief as tbrief
from vo_tpu_torch.features.extractor import OrbLikeExtractor as TOrb

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def frames():
    imgs, _, _ = render_sequence(3, K, H=240, W=320, step=0.8, yaw_rate=0.02)
    feats = JOrb(max_kp=512)(jnp.asarray(imgs))
    return imgs, np.array(feats.kp), np.array(feats.valid)


def test_brief_offsets_same_bytes():
    for bits, seed in ((256, 8214), (128, 3)):
        ref = jbrief.brief_offsets(bits, seed)
        got = tbrief.brief_offsets(bits, seed)
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


def test_patches_and_orientation_vs_jax(frames):
    imgs, kp, _ = frames
    smoothed = np.asarray(jblur(jnp.asarray(imgs), 2.0))
    jpatch = np.stack([np.asarray(jbrief._extract_patches(jnp.asarray(smoothed[f]),
                                                          jnp.asarray(kp[f]), 20))
                       for f in range(len(imgs))])
    tpatch = tbrief._extract_patches(torch.from_numpy(smoothed), torch.from_numpy(kp), 20)
    np.testing.assert_array_equal(tpatch.numpy(), jpatch)
    jc, js = (np.asarray(x) for x in jax.vmap(jbrief._orientation)(jnp.asarray(jpatch)))
    tc, ts = (x.numpy() for x in tbrief._orientation(tpatch))
    np.testing.assert_allclose(tc, jc, atol=1e-3)
    np.testing.assert_allclose(ts, js, atol=1e-3)
    xs = np.arange(41) - 20.0
    w = jpatch.astype(np.float64) * (xs[None] ** 2 + xs[:, None] ** 2 <= 400.0)
    m10, m01 = (w * xs[None, :]).sum((-2, -1)), (w * xs[:, None]).sum((-2, -1))
    norm = np.sqrt(m10 * m10 + m01 * m01) + 1e-9
    np.testing.assert_allclose(tc, m10 / norm, atol=5e-5)
    np.testing.assert_allclose(ts, m01 / norm, atol=5e-5)


def _bit_agreement(t, j, valid):
    assert set(np.unique(t)) <= {-1.0, 0.0, 1.0}
    assert (t[~valid] == 0).all() and (j[~valid] == 0).all()
    return float((t[valid] == j[valid]).mean())


def test_oriented_brief_descriptors_vs_jax(frames):
    imgs, kp, valid = frames
    ref = np.asarray(jax.vmap(jbrief.oriented_brief_descriptors)(
        jnp.asarray(imgs), jnp.asarray(kp), jnp.asarray(valid)), np.float32)
    got = tbrief.oriented_brief_descriptors(torch.from_numpy(imgs), torch.from_numpy(kp),
                                            torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 512, 256)
    assert _bit_agreement(got.float().numpy(), ref, valid) >= 0.999
    one = tbrief.oriented_brief_descriptors(torch.from_numpy(imgs[0]),
                                            torch.from_numpy(kp[0]),
                                            torch.from_numpy(valid[0]))
    assert torch.equal(one, got[0])


def test_orb_like_oriented_vs_jax(frames):
    imgs, kp, valid = frames
    j = JOrb(max_kp=512, oriented=True)(jnp.asarray(imgs))
    t = TOrb(max_kp=512, oriented=True)(imgs, device="cpu")
    np.testing.assert_array_equal(t.kp.numpy(), np.asarray(j.kp))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert _bit_agreement(t.desc.float().numpy(), np.asarray(j.desc, np.float32),
                          t.valid.numpy()) >= 0.999
    upright = TOrb(max_kp=512)(imgs, device="cpu")
    assert not torch.equal(upright.desc, t.desc)
