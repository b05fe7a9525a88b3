"""Port parity: the fused matcher (``ops/match.py``) and the plain matchers.

``top2_mutual_plain`` is held against the Pallas kernel run in interpret mode and
against the JAX XLA matchers. Binary +-1 descriptors give integer similarities, so
indices and values are exact there; float unit vectors carry rtol = atol = 1e-5 on the
similarities (fp32 products summed in another order). The CUDA kernels themselves are
held against the plain version in tests/test_torch_cuda.py, which needs a card; here the
wrapper's grid arithmetic and the column-key order the kernels rely on are checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.matching import matchers as jm
from vo_tpu.ops.pallas_match import (ratio_match_pallas, ratio_mutual_nn_match_pallas,
                                     top2_mutual_pallas)
from vo_tpu_torch.matching import matchers as tm
from vo_tpu_torch.ops import match as tmatch

TOL = dict(rtol=1e-5, atol=1e-5)


def _float_descs(rng, na=300, nb=280, d=128):
    """The cases of tests/test_pallas_kernels.py: planted correspondences, ~10 %
    invalid on both sides."""
    a = rng.normal(size=(na, d)).astype(np.float32)
    b = rng.normal(size=(nb, d)).astype(np.float32)
    n = min(100, na, nb)
    b[:n] = a[:n] + 0.05 * rng.normal(size=(n, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    return a, b, rng.uniform(size=na) > 0.1, rng.uniform(size=nb) > 0.1


def _binary_descs(rng, na=600, nb=700, d=256, dup=True):
    """+-1 descriptors with planted near-copies and exact duplicate rows and columns,
    so equal similarities (ties) occur in rows, columns and as best == second."""
    a = np.sign(rng.normal(size=(na, d))).astype(np.float32)
    b = np.sign(rng.normal(size=(nb, d))).astype(np.float32)
    n = min(300, na, nb)
    b[:n] = np.roll(a, 7, axis=0)[:n]
    b[:n][rng.uniform(size=(n, d)) < 0.05] *= -1.0
    if dup:
        b[400:450] = b[100:150]          # duplicate columns: best == second
        a[500:540] = a[200:240]          # duplicate rows: column ties
    return a, b, rng.uniform(size=na) > 0.1, rng.uniform(size=nb) > 0.1


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


CASES = {
    "float_300x280x128": (lambda r: _float_descs(r), False),
    "float_600x700x64": (lambda r: _float_descs(r, 600, 700, 64), False),
    "binary_600x700x256_ties": (lambda r: _binary_descs(r), True),
    "binary_300x1100x256": (lambda r: _binary_descs(r, 300, 1100, dup=False), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_top2_mutual_plain_vs_pallas_and_xla(case):
    make, bf16 = CASES[case]
    a, b, va, vb = make(np.random.default_rng(41))
    nn12, top2, nn21 = tmatch.top2_mutual_plain(*_t(a, b, va, vb), bf16=bf16)
    p12, ptop2, p21 = top2_mutual_pallas(*_j(a, b, va, vb), interpret=True, bf16=bf16)
    sim = jm.similarity_matrix(*_j(a, b, va, vb))
    x12, xtop2 = jm._top2(sim)
    x21 = jnp.argmax(sim, axis=0)
    assert nn12.dtype == torch.int32 and nn21.dtype == torch.int32
    for ref12, reftop2, ref21 in ((p12, ptop2, p21), (x12, xtop2, x21)):
        np.testing.assert_array_equal(nn12.numpy(), np.asarray(ref12))
        np.testing.assert_array_equal(nn21.numpy(), np.asarray(ref21))
        if bf16:
            np.testing.assert_array_equal(top2.numpy(), np.asarray(reftop2))
        else:
            np.testing.assert_allclose(top2.numpy(), np.asarray(reftop2), **TOL)


def test_plain_matchers_vs_jax():
    a, b, va, vb = _float_descs(np.random.default_rng(42))
    ta, tb_, tva, tvb = _t(a, b, va, vb)
    ja, jb_, jva, jvb = _j(a, b, va, vb)
    np.testing.assert_allclose(tm.similarity_matrix(ta, tb_, tva, tvb).numpy(),
                               np.asarray(jm.similarity_matrix(ja, jb_, jva, jvb)), **TOL)
    for tf, jf, kw in ((tm.ratio_mutual_nn_match, jm.ratio_mutual_nn_match, {}),
                       (tm.ratio_match, jm.ratio_match, {}),
                       (tm.mutual_nn_match, jm.mutual_nn_match, {"threshold": 0.5})):
        got, ref = tf(ta, tb_, tva, tvb, **kw), jf(ja, jb_, jva, jvb, **kw)
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
        np.testing.assert_allclose(got.sim.numpy(), np.asarray(ref.sim), **TOL)
        assert got.mask.sum() >= 50


def test_ratio_match_binary_fused_vs_pallas_and_xla():
    a, b, va, vb = _binary_descs(np.random.default_rng(43))
    got = tmatch.ratio_match_fused(*_t(a, b, va, vb), ratio=0.85, binary_dim=256)
    plain = tm.ratio_match(*_t(a, b, va, vb), ratio=0.85, binary_dim=256)
    pal = ratio_match_pallas(*_j(a, b, va, vb), ratio=0.85, binary_dim=256, interpret=True)
    xla = jm.ratio_match(*_j(a, b, va, vb), ratio=0.85, binary_dim=256)
    for ref in (pal, xla, plain):
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
        np.testing.assert_array_equal(got.sim.numpy(), np.asarray(ref.sim))
    assert got.mask.sum() > 150


def test_ratio_mutual_fused_vs_pallas_and_xla():
    a, b, va, vb = _float_descs(np.random.default_rng(44))
    got = tmatch.ratio_mutual_nn_match_fused(*_t(a, b, va, vb))
    pal = ratio_mutual_nn_match_pallas(*_j(a, b, va, vb), interpret=True)
    xla = jm.ratio_mutual_nn_match(*_j(a, b, va, vb))
    for ref in (pal, xla):
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
        np.testing.assert_allclose(got.sim.numpy(), np.asarray(ref.sim), **TOL)
    assert got.mask.sum() >= 50


def test_fused_mutual_drops_all_invalid_columns():
    """The one known divergence: with every B column invalid the fused wrapper (like
    the Pallas one) matches nothing, while matchers.ratio_mutual_nn_match keeps rows
    whose best hit is masked. The port follows the fused wrapper."""
    a, b, va, _ = _float_descs(np.random.default_rng(45), na=40, nb=30)
    vb = np.zeros(30, bool)
    got = tmatch.ratio_mutual_nn_match_fused(*_t(a, b, va, vb))
    pal = ratio_mutual_nn_match_pallas(*_j(a, b, va, vb), interpret=True)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(pal.mask))
    assert not got.mask.any()


def test_wrapper_rejects_bad_operands():
    a = torch.ones(8, 16)
    with pytest.raises(ValueError):
        tmatch.top2_mutual(a, torch.ones(8, 32))
    with pytest.raises(TypeError):
        tmatch.top2_mutual(a.to(torch.float64), a)
    with pytest.raises(ValueError):
        tmatch.top2_mutual(a, a, torch.ones(8), None)
    with pytest.raises(ValueError):
        tmatch.top2_mutual(a[None], a)


def test_cpu_tensors_take_plain_version_without_launch():
    a, b, va, vb = _binary_descs(np.random.default_rng(46), 64, 80, dup=False)
    before = (tmatch.launch_wgmma.launches, tmatch.launch_simt.launches)
    for bf16 in (True, False):
        got = tmatch.top2_mutual(*_t(a, b, va, vb), bf16=bf16)
        ref = tmatch.top2_mutual_plain(*_t(a, b, va, vb), bf16=bf16)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert (tmatch.launch_wgmma.launches, tmatch.launch_simt.launches) == before


GRID_SHAPES = [(2048, 2048, 256, 132), (1, 1, 256, 132), (63, 65, 100, 132),
               (129, 257, 64, 132), (2048, 20000, 256, 132), (5000, 300, 7, 114),
               (77, 1001, 256, 8), (2048, 2048, 128, 132), (300, 280, 130, 132)]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("na,nb,d,sms", GRID_SHAPES)
def test_match_grid_covers_every_column_once(na, nb, d, sms, bf16):
    """The kernels' cut of a call: each column in exactly one split, no split empty,
    every row in a row tile, the blocks within what fills the SMs (one per SM), and a
    width padded to TMA's 16-byte stride rule (8 bf16 or 4 fp32 elements)."""
    g = tmatch.match_grid(na, nb, d, bf16, sms)
    covered = np.zeros(nb, np.int64)
    for s in range(g.splits):
        lo, hi = s * g.cols_per_split, min(nb, (s + 1) * g.cols_per_split)
        assert hi > lo
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert (g.n_row_tiles - 1) * g.bm < na <= g.n_row_tiles * g.bm
    assert g.n_col_tiles == -(-nb // g.bn) and g.cols_per_split % g.bn == 0
    assert g.n_row_tiles * g.splits <= max(sms, g.n_row_tiles)
    assert g.bm == g.bn == 128
    step, elem = (8, 2) if bf16 else (4, 4)
    assert g.d_pad % step == 0 and d <= g.d_pad < d + step and (g.d_pad * elem) % 16 == 0


def test_match_grid_main_path_shape():
    """2048 x 2048 x 256 on 132 SMs: 16 row tiles x 8 splits of 2 column tiles."""
    g = tmatch.match_grid(2048, 2048, 256, True, 132)
    assert (g.n_row_tiles, g.splits, g.tiles_per_split, g.d_pad) == (16, 8, 2, 256)


@pytest.mark.parametrize("d", [128, 256])
def test_match_grid_fp32_path_shapes(d):
    """fp32 at the SIFT path's 2048 x 2048 x 128 and the main path's width: the same
    16 row tiles x 8 splits of 2 column tiles, 128 blocks on 132 SMs."""
    g = tmatch.match_grid(2048, 2048, d, False, 132)
    assert (g.n_row_tiles, g.splits, g.tiles_per_split, g.d_pad) == (16, 8, 2, d)


def test_col_key_orders_values_then_lower_rows():
    """The packed key the kernels reduce with atomicMax: value order first (-1e30 the
    least, -0 equal to +0), then the lower row; no masked (-1e30) key beats the initial
    one, which decodes to row 0 and fits the int64 scratch."""
    key = tmatch._col_key
    init = tmatch._col_key_init()
    assert init == key(-1e30, 0) and init < 2**63
    assert 0xFFFFFFFF - (init & 0xFFFFFFFF) == 0
    vals = [-1e30, -256.0, -1.5, -1e-3, 0.0, 1e-3, 1.0, 255.0, 256.0]
    keys = [key(v, 7) for v in vals]
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    assert key(-0.0, 7) == key(0.0, 7)
    assert key(3.0, 5) > key(3.0, 6) > key(2.0, 0)
    assert all(key(-1e30, r) <= init for r in (0, 1, 2047, 2**31 - 1))
    assert key(-256.0, 2**31 - 1) > init


@pytest.mark.parametrize("seed", range(4))
def test_col_key_max_is_xla_argmax(seed):
    """Over a column with ties, -1e30 masks and signed zeros, the largest key decodes
    to torch.argmax's row (the first of the largest values), as the kernels rely on."""
    rng = np.random.default_rng(seed)
    col = rng.integers(-3, 4, size=200).astype(np.float32)
    col[rng.uniform(size=200) < 0.3] = -1e30
    col[rng.uniform(size=200) < 0.1] = -0.0
    if seed == 3:
        col[:] = -1e30                         # all-invalid: row 0
    best = max(tmatch._col_key(float(v), r) for r, v in enumerate(col))
    assert 0xFFFFFFFF - (best & 0xFFFFFFFF) == int(torch.argmax(torch.from_numpy(col)))
