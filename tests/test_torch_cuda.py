"""The CUDA match kernels against their plain PyTorch version, on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX). Without a card every test
here skips. bf16 cases go through the wgmma kernel (``launch_wgmma``), fp32 cases
through the SIMT kernel (``launch_simt``). Binary +-1 descriptors, in bf16 or fp32,
give integer similarities: nn12, nn21 and top2 must be exactly equal. Float unit
vectors sum fp32 products in another order: top2 within 1e-5, nn12 equal wherever
best - second > 1e-4.
"""

import numpy as np
import pytest
import torch

from vo_tpu_torch.ops import match
from vo_tpu_torch.ops.match_timing import sift_like


def _binary(rng, na, nb, d=256):
    a = np.sign(rng.normal(size=(na, d))).astype(np.float32)
    b = np.sign(rng.normal(size=(nb, d))).astype(np.float32)
    n = min(na, nb) // 2
    b[:n] = np.roll(a, 7, axis=0)[:n]
    b[:n][rng.uniform(size=(n, d)) < 0.05] *= -1.0
    b[n:n + 32] = b[:32]                 # duplicate columns: best == second
    a[n:n + 32] = a[:32]                 # duplicate rows: column ties
    return a, b, rng.uniform(size=na) > 0.1, rng.uniform(size=nb) > 0.1


def _float(rng, na, nb, d):
    a = rng.normal(size=(na, d)).astype(np.float32)
    b = rng.normal(size=(nb, d)).astype(np.float32)
    n = min(na, nb) // 3
    b[:n] = a[:n] + 0.05 * rng.normal(size=(n, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    return a, b, rng.uniform(size=na) > 0.1, rng.uniform(size=nb) > 0.1


CASES = {
    "binary_2048x2048x256": (lambda r: _binary(r, 2048, 2048), True),
    "binary_ragged_77x1001x256": (lambda r: _binary(r, 77, 1001), True),
    "binary_2048x20000x256": (lambda r: _binary(r, 2048, 20000), True),
    "binary_1x1x256": (lambda r: _binary(r, 1, 1), True),
    "binary_63x65x256": (lambda r: _binary(r, 63, 65), True),
    "binary_129x257x256": (lambda r: _binary(r, 129, 257), True),
    "binary_300x280x100": (lambda r: _binary(r, 300, 280, 100), True),
    "binary_500x600x64": (lambda r: _binary(r, 500, 600, 64), True),
    "float_1000x1200x128": (lambda r: _float(r, 1000, 1200, 128), False),
    "float_300x280x100": (lambda r: _float(r, 300, 280, 100), False),
    "float_as_bf16_500x600x64": (lambda r: _float(r, 500, 600, 64), True),
    # fp32: the SIFT path's descriptors, widths that need padding, ragged and tiny
    # shapes and a long B, the last ones as exact +-1 values.
    "sift_like_2048x2048x128": (lambda r: sift_like(r, 2048, 2048), False),
    "float_300x280x130": (lambda r: _float(r, 300, 280, 130), False),
    "binary_as_fp32_2048x2048x256": (lambda r: _binary(r, 2048, 2048), False),
    "binary_as_fp32_1x1x256": (lambda r: _binary(r, 1, 1), False),
    "binary_as_fp32_63x65x256": (lambda r: _binary(r, 63, 65), False),
    "binary_as_fp32_129x257x256": (lambda r: _binary(r, 129, 257), False),
    "binary_as_fp32_2048x20000x256": (lambda r: _binary(r, 2048, 20000), False),
    "binary_as_fp32_300x280x100": (lambda r: _binary(r, 300, 280, 100), False),
}


def _check(got, ref, exact):
    (nn12, top2, nn21), (r12, rtop2, r21) = ([x.cpu().numpy() for x in t] for t in (got, ref))
    if exact:
        np.testing.assert_array_equal(nn12, r12)
        np.testing.assert_array_equal(nn21, r21)
        np.testing.assert_array_equal(top2, rtop2)
    else:
        np.testing.assert_allclose(top2, rtop2, rtol=1e-5, atol=1e-5)
        sure = rtop2[:, 0] - rtop2[:, 1] > 1e-4
        np.testing.assert_array_equal(nn12[sure], r12[sure])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the match kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_vs_plain(cuda_device, case):
    make, bf16 = CASES[case]
    a, b, va, vb = (torch.from_numpy(x).to(cuda_device)
                    for x in make(np.random.default_rng(71)))
    before = (match.launch_wgmma.launches, match.launch_simt.launches)
    got = match.top2_mutual(a, b, va, vb, bf16=bf16)
    torch.cuda.synchronize()
    after = (match.launch_wgmma.launches, match.launch_simt.launches)
    assert after == ((before[0] + 1, before[1]) if bf16 else (before[0], before[1] + 1))
    ref = match.top2_mutual_plain(a, b, va, vb, bf16=bf16)
    _check(got, ref, exact="binary" in case)


DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                                 ids=["bf16", "fp32"])


@pytest.mark.cuda
@DTYPES
def test_repeated_calls_reset_scratch(cuda_device, dtype):
    """Each kernel resets its cached column keys and tickets itself (and they share
    them): calls in a row on new inputs, growing and shrinking, are each exact."""
    rng = np.random.default_rng(73)
    bf16 = dtype == torch.bfloat16
    for na, nb, d in ((2048, 2048, 256), (2048, 2048, 256), (300, 5000, 256),
                      (129, 257, 64), (2048, 2048, 256)):
        a, b, va, vb = (torch.from_numpy(x).to(cuda_device) for x in _binary(rng, na, nb, d))
        a, b = a.to(dtype), b.to(dtype)
        got = match.top2_mutual(a, b, va, vb, bf16=bf16)
        torch.cuda.synchronize()
        _check(got, match.top2_mutual_plain(a, b, va, vb, bf16=bf16), exact=True)


def _misaligned(cuda_device, dtype):
    """TMA needs 16-byte aligned operands: a view that starts one element into its
    storage is copied by the wrapper, and the result is still exact."""
    rng = np.random.default_rng(74)
    a, b, va, vb = (torch.from_numpy(x).to(cuda_device) for x in _binary(rng, 300, 400))
    flat = torch.zeros(a.numel() + 1, dtype=dtype, device=cuda_device)
    a_view = flat[1:].view(a.shape)
    a_view.copy_(a)
    assert a_view.data_ptr() % 16 != 0
    b = b.to(dtype)
    bf16 = dtype == torch.bfloat16
    got = match.top2_mutual(a_view, b, va, vb, bf16=bf16)
    torch.cuda.synchronize()
    _check(got, match.top2_mutual_plain(a_view, b, va, vb, bf16=bf16), exact=True)


@pytest.mark.cuda
def test_wgmma_takes_misaligned_views(cuda_device):
    _misaligned(cuda_device, torch.bfloat16)


@pytest.mark.cuda
def test_simt_takes_misaligned_views(cuda_device):
    _misaligned(cuda_device, torch.float32)


@pytest.mark.cuda
@DTYPES
def test_all_invalid_and_single_column(cuda_device, dtype):
    """Edge masks: no valid column at all (every index 0, as XLA's argmax of an
    all -1e30 column or row gives) and a single valid column (second = -1e30)."""
    rng = np.random.default_rng(72)
    a, b, va, _ = (torch.from_numpy(x).to(cuda_device) for x in _binary(rng, 200, 150))
    a, b = a.to(dtype), b.to(dtype)
    bf16 = dtype == torch.bfloat16
    for vb in (torch.zeros(150, dtype=torch.bool, device=cuda_device),
               torch.arange(150, device=cuda_device) == 77):
        got = match.top2_mutual(a, b, va, vb, bf16=bf16)
        ref = match.top2_mutual_plain(a, b, va, vb, bf16=bf16)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    a = torch.ones(64, 512, device=cuda_device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        match.top2_mutual(a, a.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("transfer", ["sparse", "float32"])
def test_native_loader_streaming_equals_in_memory(cuda_device, tmp_path, transfer):
    """16 frames written in the bench's format (gray PNG + uint16 millimetre npy), read
    by the native loader as the CLI reads them (gray + u16mm in sparse mode, RGB + fp32
    otherwise) and streamed on the card: the poses of ``run_offline_vo`` on the decoded
    frames, one wgmma launch per tracked frame."""
    from vo_tpu_torch.engine.pipeline import run_offline_vo, run_offline_vo_streaming
    from vo_tpu_torch.engine.vo import VOConfig
    from vo_tpu_torch.estimation.pnp import PnPConfig
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.io.dataset import write_gray_u16mm_dir
    from vo_tpu_torch.io.native import NativeRGBDSequence
    from vo_tpu_torch.utils.synthetic import render_sequence

    n = 16
    K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
    imgs, deps, _ = render_sequence(n, K, H=240, W=320, step=0.8, yaw_rate=0.01)
    write_gray_u16mm_dir(str(tmp_path), imgs, deps)
    cfg = VOConfig(matcher="ratio_binary", kf_min_matches=60, kf_min_inliers=30,
                   pnp=PnPConfig(min_inliers=15, n_hypotheses=256))
    ex = OrbLikeExtractor(max_kp=512)
    sparse = transfer == "sparse"
    seq = NativeRGBDSequence.try_open(str(tmp_path))
    before = match.launch_wgmma.launches
    stats = {}
    poses, diag, _ = run_offline_vo_streaming(
        seq.iter_batches(4, gray=sparse, depth="u16mm" if sparse else "f32"), n, K,
        vo_config=cfg, extractor=ex, transfer_depth=transfer, device=cuda_device,
        stats=stats)
    seq.close()
    assert match.launch_wgmma.launches - before == n - 1
    assert stats["chunks"] == 4

    gray = np.clip(imgs, 0, 255).astype(np.uint8)
    if not sparse:
        gray = np.repeat(gray[..., None], 3, axis=-1)
    metres = np.round(np.clip(deps, 0.0, 65.535) * 1000.0).astype(np.uint16)
    ref, ref_diag = run_offline_vo(gray, metres.astype(np.float32) * 1e-3, K,
                                   vo_config=cfg, extractor=ex, extraction_batch=4,
                                   device=cuda_device)
    assert np.abs(poses - ref).max() <= 1e-5
    np.testing.assert_array_equal(diag.n_matches, ref_diag.n_matches)
