"""Port parity: threefry keys and uniform draws are bit-identical to ``jax.random``
(the installed jax runs threefry in its partitionable mode, whose bit layout the port
reproduces)."""

import jax
import numpy as np
import pytest
import torch

from vo_tpu_torch import prng


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_partitionable_mode_is_the_reference():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 8214, 2**31 - 1, -5])
def test_key_and_fold_in(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(), _kd(jax.random.key(seed)))
    ids = np.array([0, 1, 7, 159, 100_000], np.int32)
    tk = prng.fold_in(prng.key(seed), torch.from_numpy(ids))
    for i, fid in enumerate(ids):
        ref = _kd(jax.random.fold_in(jax.random.key(seed), int(fid)))
        np.testing.assert_array_equal(tk[i].numpy(), ref)
        np.testing.assert_array_equal(prng.fold_in(prng.key(seed), int(fid)).numpy(), ref)


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split(num):
    for seed, fid in ((8214, 1), (8214, 42), (3, 9)):
        jk = jax.random.fold_in(jax.random.key(seed), fid)
        tk = prng.fold_in(prng.key(seed), fid)
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      _kd(jax.random.split(jk, num)))


@pytest.mark.parametrize("shape", [(384, 3), (128, 6), (7,), (5, 4, 3)])
def test_uniform(shape):
    for seed, fid in ((8214, 1), (8214, 158), (11, 0)):
        jk = jax.random.fold_in(jax.random.key(seed), fid)
        tk = prng.fold_in(prng.key(seed), fid)
        for jsub, tsub in zip(jax.random.split(jk), prng.split(tk)):
            ref = np.asarray(jax.random.uniform(jsub, shape))
            got = prng.uniform(tsub, shape)
            assert got.dtype == torch.float32 and tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


def test_batched_keys_draw_like_single_keys():
    keys = prng.fold_in(prng.key(8214), torch.arange(4))
    batched = prng.uniform(keys, (10, 3))
    for i in range(4):
        np.testing.assert_array_equal(batched[i].numpy(),
                                      prng.uniform(keys[i], (10, 3)).numpy())


@pytest.mark.parametrize("span", [1, 3, 4, 7, 2048, 2**20 + 3])
@pytest.mark.parametrize("shape", [(256, 4), (7,), (3, 5, 2)])
def test_randint(span, shape):
    """``jax.random.randint`` bit for bit (int32), spans that are and are not powers
    of 2, with and without an offset."""
    for seed, fid, lo in ((8214, 1, 0), (8214, 158, -5), (11, 0, 100)):
        jk = jax.random.fold_in(jax.random.key(seed), fid)
        tk = prng.fold_in(prng.key(seed), fid)
        ref = np.asarray(jax.random.randint(jk, shape, lo, lo + span))
        got = prng.randint(tk, shape, lo, lo + span)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("lo,hi", [(7, 3), (5, 5), (-2**31, 2**31 - 1), (0, 2**31 - 1)])
def test_randint_edges(lo, hi):
    """maxval <= minval gives minval; the full int32 range wraps as jax's uint32 span."""
    jk, tk = jax.random.key(3), prng.key(3)
    np.testing.assert_array_equal(prng.randint(tk, (64,), lo, hi).numpy(),
                                  np.asarray(jax.random.randint(jk, (64,), lo, hi)))


def test_randint_array_bounds():
    jk, tk = jax.random.key(1), prng.key(1)
    lo, hi = np.array([0, 5, 9]), np.array([3, 2**20, 10])
    np.testing.assert_array_equal(
        prng.randint(tk, (4, 3), torch.from_numpy(lo), torch.from_numpy(hi)).numpy(),
        np.asarray(jax.random.randint(jk, (4, 3), lo, hi)))
