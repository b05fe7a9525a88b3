"""Port parity: dense packed BRIEF. Offsets, packed words and the +-1 bf16 descriptors
are bit-exact with the JAX package (the port's int32 words hold the same bit pattern
as the JAX package's uint32 words)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.features import dense_brief as jb
from vo_tpu_torch.features import dense_brief as tb


def test_offsets_identical():
    np.testing.assert_array_equal(tb.dense_brief_offsets(), jb.dense_brief_offsets())
    np.testing.assert_array_equal(tb.dense_brief_offsets(64, seed=3),
                                  jb.dense_brief_offsets(64, seed=3))


def test_bf16_rounding_matches():
    """The blurred image is rounded to bf16 before the compares: torch's conversion
    must round to nearest even exactly as XLA's does, ties included."""
    rng = np.random.default_rng(31)
    x = rng.uniform(0, 255, size=100_000).astype(np.float32)
    # Exact ties between two bf16 neighbours (low 16 bits 0x8000), both parities.
    ties = (np.arange(1000, dtype=np.uint32) << 16 | 0x8000).view(np.float32) + 0
    x = np.concatenate([x, ties.astype(np.float32)])
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def gray():
    rng = np.random.default_rng(32)
    g = rng.uniform(0, 255, size=(2, 48, 80)).astype(np.float32)
    g[:, 10:20, 10:30] = 128.0      # flat patch: equal compares, bit = 0 on both sides
    return g


def test_packed_words_bit_exact(gray):
    j = np.asarray(jb.dense_packed_brief(jnp.asarray(gray)))
    t = tb.dense_packed_brief(torch.from_numpy(gray))
    assert t.dtype == torch.int32 and t.shape == j.shape
    np.testing.assert_array_equal(t.numpy().view(np.uint32), j)
    assert (j >> 31).any()         # bit 31 in use: the int32 sign bit is exercised


def test_descriptors_bit_exact(gray):
    rng = np.random.default_rng(33)
    kp = np.stack([rng.uniform(-3, 83, size=(2, 200)),
                   rng.uniform(-3, 51, size=(2, 200))], axis=-1).astype(np.float32)
    valid = rng.uniform(size=(2, 200)) > 0.2
    j = jb.upright_brief_descriptors(jnp.asarray(gray), jnp.asarray(kp), jnp.asarray(valid))
    t = tb.upright_brief_descriptors(torch.from_numpy(gray), torch.from_numpy(kp),
                                     torch.from_numpy(valid))
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (2, 200, 256)
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(j).view(np.int16))
    assert (t[torch.from_numpy(~valid)] == 0).all()


def _keypoints(rng, B, K, H, W):
    """Keypoints over and beyond the frame: on the 13 px border margin, on the edges and
    past them (clamped as the gather clamps), fractional ones (truncated), 20 % invalid."""
    kp = np.stack([rng.uniform(-3, W + 3, size=(B, K)),
                   rng.uniform(-3, H + 3, size=(B, K))], axis=-1).astype(np.float32)
    edge = np.array([[0, 0], [W - 1, H - 1], [12.9, 13.0], [W - 13.5, H - 13.2],
                     [-0.7, 5.5], [W + 40, -40], [W / 2, 0.99]], np.float32)
    kp[:, :len(edge)] = edge
    valid = rng.uniform(size=(B, K)) > 0.2
    valid[:, :len(edge)] = True
    return kp, valid


@pytest.mark.parametrize("bits", [256, 512, 64])
def test_keypoint_path_equals_the_dense_path_and_jax(gray, bits):
    """``upright_brief_descriptors`` (on the CPU the plain keypoint path of
    ``ops/brief.py``) gives the bits of the dense path, ``dense_packed_brief`` then
    ``gather_brief_descriptors``, and of the JAX package's, for every table size."""
    kp, valid = _keypoints(np.random.default_rng(34), 2, 300, *gray.shape[1:])
    g, k, v = torch.from_numpy(gray), torch.from_numpy(kp), torch.from_numpy(valid)
    got = tb.upright_brief_descriptors(g, k, v, bits=bits)
    dense = tb.gather_brief_descriptors(tb.dense_packed_brief(g, bits=bits), k, v, bits=bits)
    j = jb.upright_brief_descriptors(jnp.asarray(gray), jnp.asarray(kp), jnp.asarray(valid),
                                     bits=bits)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 300, bits)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  dense.view(torch.int16).numpy())
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(j).view(np.int16))
    assert (got[torch.from_numpy(~valid)].view(torch.int16) == 0).all()   # +0, not -0


def _operands(B=2, K=5, H=40, W=50, bits=64):
    rng = np.random.default_rng(35)
    return (torch.from_numpy(rng.uniform(0, 255, (B, H, W)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 40, (B, K, 2)).astype(np.float32)),
            torch.ones((B, K), dtype=torch.bool),
            torch.from_numpy(tb.dense_brief_offsets(bits)))


REFUSALS = {
    "bits_not_a_multiple_of_32": lambda s, k, v, o: (s, k, v, o[:48]),
    "no_bits": lambda s, k, v, o: (s, k, v, o[:0]),
    "bits_past_the_table_limit": lambda s, k, v, o: (s, k, v, o.repeat(64, 1, 1)),
    "fp64_image": lambda s, k, v, o: (s.double(), k, v, o),
    "image_without_a_batch": lambda s, k, v, o: (s[0], k, v, o),
    "int_keypoints": lambda s, k, v, o: (s, k.long(), v, o),
    "keypoints_of_another_batch": lambda s, k, v, o: (s, k[:1], v, o),
    "uint8_validity": lambda s, k, v, o: (s, k, v.to(torch.uint8), o),
    "validity_of_another_shape": lambda s, k, v, o: (s, k, v[:, :4], o),
    "int64_table": lambda s, k, v, o: (s, k, v, o.long()),
    "table_of_another_shape": lambda s, k, v, o: (s, k, v, o.reshape(-1, 4)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_keypoint_brief_refuses_what_the_kernel_does_not_take(case):
    """The wrapper raises, on any device, on operands the kernel does not take; and the
    kernel's own entry refuses a CPU tensor."""
    from vo_tpu_torch.ops import brief

    args = REFUSALS[case](*_operands())
    with pytest.raises(ValueError):
        brief.keypoint_brief(*args)
    with pytest.raises(ValueError, match="runs on cuda"):
        brief.launch_brief(*_operands())
    assert brief.keypoint_brief(*_operands()).shape == (2, 5, 64)
