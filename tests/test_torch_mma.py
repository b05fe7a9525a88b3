"""The port's MMA harness against the JAX package's on the CPU.

``mma_pair`` on the same features gives the JAX curve (mutual nearest neighbours by
``mutual_nn_match`` on CPU tensors); ``mma_on_warps`` given the JAX harness's warped
images and homographies gives its curve and match counts exactly, with the upright
ORB-like extractor, which both packages compute bit for bit. On CUDA tensors the
harness takes the match kernel instead (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.evalkit import mma as jmma
from vo_tpu.features import OrbLikeExtractor as JOrb
from vo_tpu.train import pairs as jpairs
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch import prng
from vo_tpu_torch.evalkit import mma
from vo_tpu_torch.features.extractor import Features, OrbLikeExtractor
from vo_tpu_torch.matching.matchers import mutual_nn_match

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)


def features(rng, n, d, kp_scale=100.0):
    return (rng.uniform(0, kp_scale, (n, 2)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32), rng.uniform(size=n) > 0.1)


class JF:
    def __init__(self, kp, desc, valid):
        self.kp, self.desc, self.valid = jnp.asarray(kp), jnp.asarray(desc), jnp.asarray(valid)


def TF(kp, desc, valid):
    return Features(torch.from_numpy(kp), torch.from_numpy(desc), None, torch.from_numpy(valid))


def test_mma_pair_on_identical_features():
    rng = np.random.default_rng(100)
    f = features(rng, 64, 16)
    f = (f[0], f[1] / np.linalg.norm(f[1], axis=1, keepdims=True), np.ones(64, bool))
    want = jmma.mma_pair(JF(*f), JF(*f), np.eye(3), (1, 3, 5))
    got = mma.mma_pair(TF(*f), TF(*f), np.eye(3), (1, 3, 5))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, 1.0)


def test_mma_pair_under_a_homography():
    rng = np.random.default_rng(101)
    kp1, d1, v1 = features(rng, 200, 32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    Hm = np.asarray(jpairs.random_homography(jax.random.key(1), 100, 100))
    p = np.concatenate([kp1, np.ones((200, 1), np.float32)], 1) @ Hm.T
    kp2 = (p[:, :2] / p[:, 2:] + rng.normal(0, 2.0, (200, 2))).astype(np.float32)
    d2 = d1 + 0.15 * rng.normal(size=d1.shape).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    v2 = rng.uniform(size=200) > 0.1
    th = tuple(range(1, 11))
    want = jmma.mma_pair(JF(kp1, d1, v1), JF(kp2, d2, v2), Hm, th)
    got = mma.mma_pair(TF(kp1, d1, v1), TF(kp2, d2, v2), Hm, th)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert 0.0 < got[2] < 1.0


def test_mutual_matches_on_the_cpu_are_mutual_nn_match():
    rng = np.random.default_rng(102)
    a, b = rng.normal(size=(80, 16)).astype(np.float32), rng.normal(size=(90, 16)).astype(np.float32)
    b[:40] = a[:40] + 0.01
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    va, vb = rng.uniform(size=80) > 0.2, rng.uniform(size=90) > 0.2
    ta, tb, tva, tvb = map(torch.from_numpy, (a, b, va, vb))
    idx, mask = mma.mutual_matches(ta, tb, tva, tvb)
    ref = mutual_nn_match(ta, tb, tva, tvb, threshold=0.9)
    assert np.array_equal(idx, ref.idx.numpy()) and np.array_equal(mask, ref.mask.numpy())
    assert 10 < mask.sum() <= 40


def test_mma_on_warps_given_the_jax_warps(monkeypatch):
    imgs, _, _ = render_sequence(3, K, H=240, W=320, step=0.5)
    imgs = np.asarray(imgs, np.float32)
    key = jax.random.key(0)
    Hj, img2j = (np.asarray(x) for x in jpairs.warp_eval_batch(key, jnp.asarray(imgs), True))
    monkeypatch.setattr(mma, "warp_eval_batch", lambda key, images, photometric: (
        torch.from_numpy(Hj.copy()), torch.from_numpy(img2j.copy())))
    th = (1, 3, 5, 10)
    jex, tex = JOrb(max_kp=512), OrbLikeExtractor(max_kp=512)
    want = jmma.mma_on_warps(lambda im: jex(im), jnp.asarray(imgs), key, thresholds=th)
    got = mma.mma_on_warps(lambda im: tex(im, device="cpu"), imgs, prng.key(0), thresholds=th,
                           device="cpu")
    assert set(got) == set(want)
    assert got["matches_per_pair"] == want["matches_per_pair"]
    assert got["mean_matches"] > 30
    np.testing.assert_allclose(got["mma"], want["mma"], rtol=0, atol=1e-12)
    assert got["mma@3"] == pytest.approx(want["mma@3"], abs=1e-12)
    np.testing.assert_allclose(got["mma@3_per_pair"], want["mma@3_per_pair"], atol=1e-12)
