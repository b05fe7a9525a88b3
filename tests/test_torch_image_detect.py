"""Port parity: image ops, corner responses, keypoint selection and the extractor.

Inputs are made with numpy from a seed and fed to the JAX package and the port on the
CPU. Op by op (JAX eager) the filters agree bit for bit, because the port sums the
taps in the same order. Under ``jit`` XLA's CPU backend fuses the chains and contracts
multiply-adds, which moves the last bits: those comparisons carry rtol 1e-5, with an
absolute floor of 1e-5 of the map's largest magnitude where det - k tr^2 cancels.
Keypoint selection fed the same response is index-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.features import detect as jdet
from vo_tpu.features.extractor import OrbLikeExtractor as JExtractor
from vo_tpu.ops import image as jimg
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch.features import detect as tdet
from vo_tpu_torch.features.extractor import OrbLikeExtractor as TExtractor
from vo_tpu_torch.ops import image as timg

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def gray():
    # 64 x 96: 2 x 3 = 6 tiles of 32 px, an even count, so the tile median averages
    # the two middle values (jnp.median) -- torch.median would take the lower one.
    return np.random.default_rng(21).uniform(0, 255, size=(3, 64, 96)).astype(np.float32)


def _ops():
    return [
        ("rgb_to_gray", jimg.rgb_to_gray, timg.rgb_to_gray),
        ("blur_1.0", lambda x: jimg.gaussian_blur(x, 1.0), lambda x: timg.gaussian_blur(x, 1.0)),
        ("blur_2.0", lambda x: jimg.gaussian_blur(x, 2.0), lambda x: timg.gaussian_blur(x, 2.0)),
        ("sobel_x", lambda x: jimg.sobel_gradients(x)[0], lambda x: timg.sobel_gradients(x)[0]),
        ("sobel_y", lambda x: jimg.sobel_gradients(x)[1], lambda x: timg.sobel_gradients(x)[1]),
        ("maxpool5", lambda x: jimg.maxpool2d_same(x, 5), lambda x: timg.maxpool2d_same(x, 5)),
        ("harris", jdet.harris_response, tdet.harris_response),
    ]


@pytest.mark.parametrize("name,jf,tf", _ops(), ids=[o[0] for o in _ops()])
def test_image_ops_bit_exact_eager(gray, name, jf, tf):
    x = np.random.default_rng(22).uniform(0, 255, size=(3, 64, 96, 3)).astype(np.float32) \
        if name == "rgb_to_gray" else gray
    np.testing.assert_array_equal(tf(torch.from_numpy(x)).numpy(), np.asarray(jf(jnp.asarray(x))))


def test_gaussian_taps_identical():
    for sigma in (1.0, 1.5, 2.0):
        np.testing.assert_array_equal(np.asarray(timg.gaussian_kernel1d(sigma), np.float32),
                                      np.asarray(jimg.gaussian_kernel1d(sigma)))


@pytest.mark.parametrize("resp", ["harris", "shi_tomasi"])
def test_response_vs_jitted(gray, resp):
    jf = jax.jit(getattr(jdet, f"{resp}_response"))
    tf = getattr(tdet, f"{resp}_response")
    a = np.asarray(jf(jnp.asarray(gray)))
    b = tf(torch.from_numpy(gray)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * np.abs(a).max())


def _detect_both(resp, **kw):
    j = jdet.detect_keypoints(jnp.asarray(resp), **kw)
    t = tdet.detect_keypoints(torch.from_numpy(resp), **kw)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    return t


@pytest.mark.parametrize("max_kp", [64, 200])
def test_detect_same_response_two_stage(gray, max_kp):
    resp = np.array(jdet.harris_response(jnp.asarray(gray)))
    kp, _, valid = _detect_both(resp, max_kp=max_kp, border=8)
    assert valid.sum() > 0


def test_detect_tie_planted():
    """Quantised responses: many equal values, so NMS plateaus, equal cell maxima
    across cells and equal sub-positions inside a cell all occur. lax.top_k and the
    2x2 argmax both resolve ties to the lower index; so must the port."""
    rng = np.random.default_rng(23)
    resp = rng.integers(0, 6, size=(2, 64, 96)).astype(np.float32) * 1e3
    resp[:, 20:30, 40:60] = 5e3                          # one large flat plateau
    kp, _, valid = _detect_both(resp, max_kp=300, border=4, rel_threshold=1e-3)
    assert valid.sum() > 100


def test_detect_flat_topk_and_subpixel():
    """A 24 x 30 image with max_kp > (H/2)(W/2) takes the flat top-k path, which pads
    the budget past H*W; subpixel refinement runs on both paths."""
    rng = np.random.default_rng(24)
    resp = rng.normal(size=(2, 24, 30)).astype(np.float32) ** 2
    _detect_both(resp, max_kp=200, border=2)
    _detect_both(resp, max_kp=800, border=2, subpixel=True)
    big = rng.normal(size=(1, 64, 96)).astype(np.float32) ** 2
    _detect_both(big, max_kp=100, border=4, subpixel=True)


def test_extractor_unported_options_raise():
    """Every option of the JAX extractor is ported now: SURF's Hessian response and
    descriptor and oriented BRIEF (tests/test_torch_surf.py and
    tests/test_torch_oriented_brief.py hold them against JAX), and the SIFT config's
    DoG and gradhist; none raises, and each gives its descriptor's width and type."""
    imgs = np.random.default_rng(63).uniform(0, 255, (1, 96, 128)).astype(np.float32)
    for kw, width in (({"response": "hessian"}, 256), ({"descriptor": "surf"}, 64),
                      ({"oriented": True}, 256),
                      ({"response": "dog", "descriptor": "gradhist"}, 128)):
        feats = TExtractor(max_kp=32, **kw)(imgs, device="cpu")
        assert feats.desc.shape == (1, 32, width) and feats.desc.dtype == torch.bfloat16


@pytest.mark.parametrize("multiscale", [False, True], ids=["orb_like", "multiscale"])
def test_unknown_response_takes_shi_tomasi(multiscale):
    """Any response name other than harris, dog and hessian takes the Shi-Tomasi
    response in both packages: same keypoints on the same frames, and the same as
    naming shi_tomasi."""
    from vo_tpu.features.pyramid import MultiScaleClassicExtractor as JMulti
    from vo_tpu_torch.features.pyramid import MultiScaleClassicExtractor as TMulti

    imgs, _, _ = render_sequence(2, K, H=240, W=320, step=0.8, yaw_rate=0.01)
    jcls, tcls, kw = ((JMulti, TMulti, {"n_scales": 2}) if multiscale
                      else (JExtractor, TExtractor, {}))
    j = jcls(max_kp=256, response="min_eig", **kw)(jnp.asarray(imgs))
    t = tcls(max_kp=256, response="min_eig", **kw)(imgs, device="cpu")
    np.testing.assert_array_equal(t.kp.numpy(), np.asarray(j.kp))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert t.valid.sum() > 200
    st = tcls(max_kp=256, response="shi_tomasi", **kw)(imgs, device="cpu")
    np.testing.assert_array_equal(t.kp.numpy(), st.kp.numpy())


@pytest.mark.parametrize("response", ["harris", "shi_tomasi"])
def test_extractor_on_rendered_frames(response):
    """Full extractor (jitted in the JAX package) on rendered frames: keypoints,
    validity and descriptors exact. Scores differ in the last bits under XLA's fused
    multiply-adds (measured: 0 of 2048 keypoints moved), so they carry the
    response tolerance."""
    imgs, _, _ = render_sequence(4, K, H=240, W=320, step=0.8, yaw_rate=0.01)
    j = JExtractor(max_kp=512, response=response)(jnp.asarray(imgs))
    t = TExtractor(max_kp=512, response=response)(imgs, device="cpu")
    np.testing.assert_array_equal(t.kp.numpy(), np.asarray(j.kp))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.desc.float().numpy(), np.asarray(j.desc, np.float32))
    assert t.desc.dtype == torch.bfloat16
    s = np.asarray(j.score)
    np.testing.assert_allclose(t.score.numpy(), s, rtol=1e-5, atol=1e-5 * np.abs(s).max())
    assert t.valid.sum() > 1000
