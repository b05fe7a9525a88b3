"""The port's training draws and pair synthesis against the JAX package's on the CPU.

Same keys on both sides (``prng`` is ``jax.random``'s threefry). Tolerances:
``prng.uniform`` over a range bit-exact; ``prng.normal`` within 1e-6 (both evaluate
Giles' fp32 erfinv polynomial; they differ in the last bits of log1p); textures,
homographies, warps and flows within 1e-4 of their scale (XLA fuses the jitted
arithmetic, the port rounds each op); masks equal except on pixels whose
correspondence lies within 1e-4 px of the border; the patchnet's initial weights from
a key within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.models import patchnet as jpatchnet
from vo_tpu.train import pairs as jpairs
from vo_tpu_torch import prng
from vo_tpu_torch.models import patchnet
from vo_tpu_torch.port_state import patchnet_params_from_jax
from vo_tpu_torch.train import pairs


def close(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1.0))


def border_free(xy, H, W, eps=1e-4):
    """Pixels whose (..., 2) correspondence is not within eps of the image border."""
    x, y = np.asarray(xy[..., 0], np.float64), np.asarray(xy[..., 1], np.float64)
    return ((np.abs(x) > eps) & (np.abs(x - (W - 1)) > eps)
            & (np.abs(y) > eps) & (np.abs(y - (H - 1)) > eps))


def sampled_inside(Hm, H, W):
    """Pixels of the warped image whose source (JAX's H^-1 p) is not within 1e-4 of
    the border: there in_src and the bilinear weights agree between packages."""
    grid = np.stack(np.meshgrid(np.arange(W, dtype=np.float32),
                                np.arange(H, dtype=np.float32)), -1)
    src = np.asarray(jpairs._apply_h(jnp.linalg.inv(jnp.asarray(Hm)), jnp.asarray(grid)))
    return border_free(src, H, W)


def batch_homographies(key, B, H, W):
    """The JAX package's per-image homographies of a batch drawn from ``key``."""
    keys = jax.random.split(key, B)
    return np.asarray(jax.vmap(lambda k: jpairs.random_homography(k, H, W))(keys))


@pytest.mark.parametrize("lo,hi", [(0.02, 0.35), (0.0, 2 * np.pi), (-0.35, 0.35),
                                   (-3e-4, 3e-4), (-20.0, 20.0), (0.0, 1.0), (-0.15, 0.15)])
def test_uniform_over_a_range_is_bit_exact(lo, hi):
    for seed in (0, 8214):
        want = np.asarray(jax.random.uniform(jax.random.key(seed), (7, 300), minval=lo,
                                             maxval=hi))
        got = prng.uniform(prng.key(seed), (7, 300), lo, hi).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want)
    keys = jax.random.split(jax.random.key(3), 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (5,), minval=lo,
                                                            maxval=hi))(keys))
    assert np.array_equal(prng.uniform(prng.split(prng.key(3), 4), (5,), lo, hi).numpy(), want)


def test_normal_within_1e6():
    for seed in (0, 1, 8214):
        want = np.asarray(jax.random.normal(jax.random.key(seed), (200, 500)))
        got = prng.normal(prng.key(seed), (200, 500)).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-6
        assert np.abs(want).max() > 4.0            # the tails are in the sample


def test_procedural_texture():
    want = np.asarray(jpairs.procedural_texture(jax.random.key(5), 3, 40, 56))
    got = pairs.procedural_texture(prng.key(5), 3, 40, 56).numpy()
    close(got, want)
    assert got.min() >= 0 and got.max() <= 255


def test_random_homography_batched_keys():
    keys = jax.random.split(jax.random.key(9), 6)
    want = np.asarray(jax.vmap(lambda k: jpairs.random_homography(k, 96, 128))(keys))
    got = pairs.random_homography(prng.split(prng.key(9), 6), 96, 128).numpy()
    for g, w in zip(got, want):
        close(g, w)
    single = pairs.random_homography(prng.key(4), 64, 64).numpy()
    close(single, jpairs.random_homography(jax.random.key(4), 64, 64))


@pytest.mark.parametrize("case", ["random", "identity"])
def test_warp_pair(case):
    rng = np.random.default_rng(71)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    if case == "identity":
        Hm = np.eye(3, dtype=np.float32)
    else:
        Hm = np.asarray(jpairs.random_homography(jax.random.key(12), 48, 64))
    want = [np.asarray(x) for x in jpairs.warp_pair(jnp.asarray(img), jnp.asarray(Hm))]
    got = [x.numpy() for x in pairs.warp_pair(torch.from_numpy(img), torch.from_numpy(Hm))]
    inner = sampled_inside(Hm, 48, 64)
    close(got[0][inner], want[0][inner])
    close(got[1], want[1])
    sure = border_free(want[1], 48, 64)
    assert np.array_equal(got[2][sure], want[2][sure])
    if case == "identity":
        assert np.array_equal(got[2], want[2]) and got[2].all()


@pytest.mark.parametrize("photometric", [False, True])
def test_synthetic_pair_batch(photometric):
    want = [np.asarray(x) for x in
            jpairs.synthetic_pair_batch(jax.random.key(3), 2, 64, 80, photometric)]
    got = [x.numpy() for x in pairs.synthetic_pair_batch(prng.key(3), 2, 64, 80, photometric)]
    close(got[0], want[0])
    close(got[2], want[2])
    sure = border_free(want[2], 64, 80)
    assert np.array_equal(got[3][sure], want[3][sure])
    assert got[3].dtype == np.bool_ and 0.3 < got[3].mean() < 1.0
    Hm = batch_homographies(jax.random.split(jax.random.key(3), 3)[1], 2, 64, 80)
    for b in range(2):
        inner = sampled_inside(Hm[b], 64, 80)
        close(got[1][b][inner], want[1][b][inner])


def test_photometric_augment_single_and_batch():
    rng = np.random.default_rng(72)
    img = rng.uniform(0, 255, (40, 48)).astype(np.float32)
    close(pairs.photometric_augment(prng.key(0), torch.from_numpy(img)).numpy(),
          jpairs.photometric_augment(jax.random.key(0), jnp.asarray(img)))
    imgs = rng.uniform(0, 255, (3, 40, 48)).astype(np.float32)
    close(pairs.photometric_augment_batch(prng.key(6), torch.from_numpy(imgs)).numpy(),
          jpairs.photometric_augment_batch(jax.random.key(6), jnp.asarray(imgs)))


def test_pair_batch_from_images_and_warp_eval_batch():
    rng = np.random.default_rng(73)
    imgs = rng.uniform(0, 255, (2, 48, 64)).astype(np.float32)
    want = [np.asarray(x) for x in jpairs.pair_batch_from_images(jax.random.key(2), imgs)]
    got = [x.numpy() for x in pairs.pair_batch_from_images(prng.key(2), imgs)]
    assert np.array_equal(got[0], want[0])
    close(got[2], want[2])
    sure = border_free(want[2], 48, 64)
    assert np.array_equal(got[3][sure], want[3][sure])
    Hm = batch_homographies(jax.random.split(jax.random.key(2))[0], 2, 48, 64)
    for b in range(2):
        inner = sampled_inside(Hm[b], 48, 64)
        close(got[1][b][inner], want[1][b][inner])

    Hj, img2j = (np.asarray(x) for x in jpairs.warp_eval_batch(jax.random.key(4), imgs))
    Ht, img2t = (x.numpy() for x in pairs.warp_eval_batch(prng.key(4), imgs))
    for b in range(2):
        close(Ht[b], Hj[b])
        inner = sampled_inside(Hj[b], 48, 64)
        close(img2t[b][inner], img2j[b][inner])


def test_pairs_stay_on_the_key_device():
    out = pairs.synthetic_pair_batch(prng.key(1), 1, 16, 16, photometric=True)
    assert all(x.device.type == "cpu" for x in out)
    assert out[0].dtype == torch.float32 and out[3].dtype == torch.bool


@pytest.mark.parametrize("name", ["fast", "quad"])
def test_patchnet_init_from_a_key(name):
    """``init_patchnet_params`` from a prng key draws the JAX package's weights."""
    jspec = {"fast": jpatchnet.FAST_QUAD_L2NET_CONFCFS, "quad": jpatchnet.QUAD_L2NET_CONFCFS}[name]
    tspec = {"fast": patchnet.FAST_QUAD_L2NET_CONFCFS, "quad": patchnet.QUAD_L2NET_CONFCFS}[name]
    want = patchnet_params_from_jax(
        jax.tree.map(np.asarray, jpatchnet.init_patchnet_params(jax.random.key(5), jspec)),
        device="cpu")
    got = patchnet.init_patchnet_params(prng.key(5), tspec)
    for gl, wl in zip(got["convs"] + [got["clf"], got["sal"]],
                      want["convs"] + [want["clf"], want["sal"]]):
        assert gl.keys() == wl.keys()
        for k in gl:
            assert gl[k].shape == wl[k].shape
            assert float((gl[k] - wl[k]).abs().max()) <= 1e-6, k
