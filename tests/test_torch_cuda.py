"""The CUDA match kernels against their plain PyTorch version, and the refinement
layer's solvers and pair verification against the CPU, on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py configures JAX). Without a card every test
here skips. bf16 cases go through the wgmma kernel (``launch_wgmma``), fp32 cases
through the SIMT kernel (``launch_simt``). Binary +-1 descriptors, in bf16 or fp32,
give integer similarities: nn12, nn21 and top2 must be exactly equal. Float unit
vectors sum fp32 products in another order: top2 within 1e-5, nn12 equal wherever
best - second > 1e-4. Bundle adjustment and the pose graph sum their blocks in a fixed
order (``ba/segment.py``): two calls on the card give identical bits; against the CPU
they are held within rtol 1e-4 of each array's scale. The front-ends (stereo, SURF,
oriented BRIEF) on the card are held to their CPU runs, and the 44-frame depth-dropout
drive of tests/test_engine_e2e.py to its assertions. The R2D2 patchnet on the card is
held to its CPU run (fp32 within 1e-4, bf16 at tests/test_torch_r2d2_model.py's
tolerances), its extraction must repeat bit for bit, and its matcher
(``ratio_mutual_nn`` at 2048 x 2048 x 128) and a 16-frame R2D2 engine run go through
the SIMT kernel. A training step on the card is held to its CPU run, two training runs
repeat bit for bit, and the MMA harness's matches go through the SIMT kernel.
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
    "surf_like_2048x2048x64": (lambda r: _float(r, 2048, 2048, 64), False),
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


def _ba_arrays(rng, P=6, L=120, M=80):
    """Cameras on an arc over a point cloud (tests/test_ba.py), noisy start, rgbd depth."""
    from vo_tpu_torch.geometry.se3 import se3_exp

    def pose(xi):
        return se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()

    K = np.array([[400.0, 0.0, 320.0], [0.0, 400.0, 180.0], [0.0, 0.0, 1.0]], np.float32)
    pts = np.stack([rng.uniform(-8, 8, L), rng.uniform(-4, 4, L),
                    rng.uniform(8, 25, L)], -1).astype(np.float32)
    gt = np.stack([pose([-0.5 * p, 0.02 * p, 0.1 * p, 0.0, 0.04 * p, 0.0]) for p in range(P)])
    obs_lm = np.stack([rng.choice(L, M, replace=False) for _ in range(P)]).astype(np.int32)
    Y = np.einsum("pij,pmj->pmi", gt[:, :3, :3], pts[obs_lm]) + gt[:, None, :3, 3]
    uv = Y[..., :2] / Y[..., 2:] * K[0, 0] + K[:2, 2] + rng.normal(0, 0.3, (P, M, 2))
    init = gt.copy()
    for p in range(1, P):
        init[p] = pose(np.concatenate([rng.normal(0, 0.1, 3), rng.normal(0, 0.02, 3)])) @ gt[p]
    return dict(poses=init, points=pts + rng.normal(0, 0.05, (L, 3)).astype(np.float32),
                obs_lm=obs_lm, obs_uv=uv.astype(np.float32), obs_valid=Y[..., 2] > 0, K=K,
                obs_z=Y[..., 2].astype(np.float32))


def _close(got, ref, rtol=1e-4):
    got, ref = (np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float64) for x in (got, ref))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-6))


@pytest.mark.cuda
def test_bundle_adjust_and_pose_graph_match_the_cpu(cuda_device):
    from vo_tpu_torch.ba import BAConfig, bundle_adjust, optimize_pose_graph
    from vo_tpu_torch.geometry.se3 import se3_exp
    from vo_tpu_torch.port_state import ba_problem_from_numpy

    arrays = _ba_arrays(np.random.default_rng(81))
    cpu = bundle_adjust(ba_problem_from_numpy(arrays, "cpu"), BAConfig(), device="cpu")
    gpu = bundle_adjust(ba_problem_from_numpy(arrays, cuda_device), BAConfig(),
                        device=cuda_device)
    assert gpu[0].device.type == cuda_device.type
    for g, c in zip(gpu[:2], cpu[:2]):
        _close(g, c)
    for k in ("costs", "final_cost", "mean_reproj"):
        _close(gpu[2][k], cpu[2][k])

    # a 40-node chain with a loop edge, isotropic and (E, 6) weights
    rng = np.random.default_rng(82)
    N = 40
    steps = np.tile(np.eye(4, dtype=np.float32), (N - 1, 1, 1))
    steps[:, 2, 3] = 1.0
    noise = rng.normal(0, [0.05] * 3 + [0.01] * 3, (N - 1, 6))
    zs = list(se3_exp(torch.tensor(noise, dtype=torch.float32)).numpy() @ steps)
    init = [np.eye(4, dtype=np.float32)]
    for z in zs:
        init.append(init[-1] @ z)
    gt_end = np.eye(4, dtype=np.float32)
    gt_end[2, 3] = N - 1
    zs.append(gt_end)
    edges = np.array([(i, i + 1) for i in range(N - 1)] + [(0, N - 1)])
    w6 = np.ones((N, 6))
    w6[:-1, 3:] = 1000.0
    w6[-1] = 20.0
    for w in (np.r_[np.ones(N - 1), 20.0], w6):
        args = (np.stack(init), edges, np.stack(zs), w.astype(np.float32))
        opt_c, cost_c = optimize_pose_graph(*args, device="cpu")
        opt_g, cost_g = optimize_pose_graph(*args, device=cuda_device)
        _close(opt_g, opt_c)
        _close(cost_g[:10], cost_c[:10])


@pytest.mark.cuda
def test_singular_solves_give_nan_without_raising(cuda_device):
    """No valid observation and no damping (BA), a node without edges (pose graph):
    the solve is singular, its step non-finite and rejected, and nothing raises."""
    from vo_tpu_torch.ba import BAConfig, bundle_adjust, optimize_pose_graph
    from vo_tpu_torch.ba.pose_graph import PoseGraphConfig
    from vo_tpu_torch.port_state import ba_problem_from_numpy

    arrays = _ba_arrays(np.random.default_rng(83), P=4, L=20, M=8)
    arrays["obs_valid"][:] = False
    poses, _, info = bundle_adjust(ba_problem_from_numpy(arrays, cuda_device),
                                   BAConfig(iterations=3, damping_init=0.0),
                                   device=cuda_device)
    costs = info["costs"].cpu().numpy()
    assert not np.isfinite(costs[:, 1]).any()
    np.testing.assert_array_equal(poses.cpu().numpy(), arrays["poses"])

    init = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    init[:, 2, 3] = [0.0, 1.0, 2.0]
    rel = np.eye(4, dtype=np.float32)
    rel[2, 3] = 1.1
    opt, costs = optimize_pose_graph(init, np.array([[0, 1]]), rel[None],
                                     np.ones(1, np.float32),
                                     PoseGraphConfig(iterations=3, damping=0.0),
                                     device=cuda_device)
    np.testing.assert_array_equal(opt.cpu().numpy(), init)
    assert np.isfinite(costs.cpu().numpy()).all()


@pytest.mark.cuda
def test_pair_verification_runs_the_wgmma_kernel(cuda_device):
    """One pair verification of rendered frames: one wgmma launch; the kernel's matches
    equal the plain matcher's, and the verified inliers the CPU run's count."""
    from vo_tpu_torch.engine import refine
    from vo_tpu_torch.engine.pipeline import extract_and_backproject
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.matching.matchers import ratio_match
    from vo_tpu_torch.utils.synthetic import render_sequence

    K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
    imgs, deps, _ = render_sequence(3, K, H=240, W=320, step=0.8, yaw_rate=0.01)
    feats, kp3d = extract_and_backproject(
        OrbLikeExtractor(max_kp=512), torch.from_numpy(imgs).to(cuda_device),
        torch.from_numpy(deps).to(cuda_device), torch.from_numpy(K).to(cuda_device))
    kv = feats.valid & (kp3d[..., 2] > 0.1) & (kp3d[..., 2] < 80.0)
    args = (feats.kp, feats.desc, feats.valid, kp3d, kv, K, refine.RefineConfig())
    before = (match.launch_wgmma.launches, match.launch_simt.launches)
    idx, mask, _, n_in = refine.verify_row_pairs([0], [2], *args, device=cuda_device)
    assert (match.launch_wgmma.launches - before[0], match.launch_simt.launches) == \
        (1, before[1])
    plain = ratio_match(feats.desc[0], feats.desc[2], feats.valid[0], feats.valid[2],
                        ratio=0.9, binary_dim=256)
    kern = refine._match(feats.desc[0], feats.desc[2], feats.valid[0], feats.valid[2],
                         refine.RefineConfig())
    assert torch.equal(kern.idx, plain.idx) and torch.equal(kern.mask, plain.mask)
    np.testing.assert_array_equal(idx[0], plain.idx.cpu().numpy())
    cpu = refine.verify_row_pairs([0], [2], *(a.cpu() if torch.is_tensor(a) else a
                                              for a in args[:5]), K, args[6], device="cpu")
    assert abs(int(n_in[0]) - int(cpu[3][0])) <= 2 and n_in[0] > 100


@pytest.mark.cuda
def test_solvers_repeat_bit_for_bit_on_the_card(cuda_device):
    """Two calls of bundle_adjust and of optimize_pose_graph on the same problem give
    identical bits on the card (fixed-order segment sums, no atomics)."""
    from vo_tpu_torch.ba import BAConfig, bundle_adjust, optimize_pose_graph
    from vo_tpu_torch.port_state import ba_problem_from_numpy

    arrays = _ba_arrays(np.random.default_rng(84))
    prob = ba_problem_from_numpy(arrays, cuda_device)
    runs = [bundle_adjust(prob, BAConfig(), device=cuda_device) for _ in range(2)]
    for a, b in zip(runs[0][:2], runs[1][:2]):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][2]["costs"], runs[1][2]["costs"])
    N = 60
    rng = np.random.default_rng(85)
    init = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    init[:, :3, 3] = np.cumsum(rng.normal(0, 1, (N, 3)), axis=0)
    edges = np.array([(i, i + 1) for i in range(N - 1)] + [(0, N - 1), (5, 40), (10, 50)])
    zs = np.stack([np.linalg.inv(init[i]) @ init[j] for i, j in edges]).astype(np.float32)
    zs[:, :3, 3] += rng.normal(0, 0.05, (len(edges), 3)).astype(np.float32)
    w = np.ones(len(edges), np.float32)
    (o1, c1), (o2, c2) = (optimize_pose_graph(init, edges, zs, w, device=cuda_device)
                          for _ in range(2))
    assert torch.equal(o1, o2) and torch.equal(c1, c2)


def _render_stereo(n, K, H=240, W=320):
    from vo_tpu_torch.utils.synthetic import render_rgbd, render_sequence

    imgs, deps, traj = render_sequence(n, K, H=H, W=W, step=0.8, yaw_rate=0.0)
    shift = np.eye(4)
    shift[0, 3] = 0.54
    rights = np.stack([render_rgbd(T @ shift, K, H=H, W=W)[0] for T in traj])
    return imgs, rights, deps


K_SMALL = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)


@pytest.mark.cuda
def test_stereo_front_end_on_the_card_matches_the_cpu(cuda_device):
    from vo_tpu_torch.engine.pipeline import stereo_extract_and_backproject
    from vo_tpu_torch.features.extractor import OrbLikeExtractor

    lefts, rights, _ = _render_stereo(4, K_SMALL)
    out = {dev: stereo_extract_and_backproject(OrbLikeExtractor(max_kp=512), lefts, rights,
                                               K_SMALL, 0.54, max_disp=96, device=dev)
           for dev in ("cpu", cuda_device)}
    (fc, kc), (fg, kg) = out["cpu"], out[cuda_device]
    assert kg.device.type == "cuda"
    np.testing.assert_array_equal(fg.kp.cpu().numpy(), fc.kp.numpy())
    zc, zg = kc[..., 2].numpy() > 0, kg[..., 2].cpu().numpy() > 0
    assert ((zc != zg).sum(axis=1) <= 2).all()
    assert (zc & zg).sum(axis=1).min() >= 100
    _close(kg.cpu().numpy()[zc & zg], kc.numpy()[zc & zg], rtol=1e-3)


@pytest.mark.cuda
def test_stereo_depth_on_the_card_within_the_jax_tests_limits(cuda_device):
    """tests/test_stereo.py's pair (frame 2 of a drive, fx 300, the right eye 0.54 m
    to the side) on the card: the depths at the ok keypoints within that test's limits
    against the rendered depth."""
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.features.stereo import stereo_depth_at
    from vo_tpu_torch.utils.synthetic import drive_trajectory, render_rgbd

    K = np.array([[300.0, 0.0, 160.0], [0.0, 300.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
    T_wl = drive_trajectory(3, step=0.8)[2]
    T_wr = T_wl.copy()
    T_wr[:3, 3] += T_wl[:3, :3] @ np.array([0.54, 0.0, 0.0])
    left, dep_gt = render_rgbd(T_wl, K, H=240, W=320)
    right, _ = render_rgbd(T_wr, K, H=240, W=320)
    feats = OrbLikeExtractor(max_kp=256)(left[None], device=cuda_device)
    depth, ok = stereo_depth_at(left, right, feats.kp[0], feats.valid[0], K, 0.54,
                                max_disp=96, device=cuda_device)
    depth, ok, kp = depth.cpu().numpy(), ok.cpu().numpy(), feats.kp[0].cpu().numpy()
    assert ok.sum() > 40
    gt = dep_gt[kp[ok, 1].astype(int), kp[ok, 0].astype(int)]
    rel_err = np.abs(depth[ok] - gt) / gt
    assert np.median(rel_err) < 0.05 and (rel_err < 0.15).mean() > 0.8


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(oriented=True),
                                dict(response="hessian", descriptor="surf")],
                         ids=["oriented_brief", "surf"])
def test_front_end_extractors_on_the_card_match_the_cpu(cuda_device, kw):
    from vo_tpu_torch.features.extractor import OrbLikeExtractor

    imgs, _, _ = _render_stereo(2, K_SMALL)
    ex = OrbLikeExtractor(max_kp=512, **kw)
    c, g = ex(imgs, device="cpu"), ex(imgs, device=cuda_device)
    assert g.desc.device.type == "cuda" and g.desc.dtype == torch.bfloat16
    np.testing.assert_array_equal(g.valid.cpu().numpy(), c.valid.numpy())
    same_kp = (g.kp.cpu() == c.kp).all(-1).numpy()
    assert same_kp.mean() >= 0.99
    gd, cd = g.desc.float().cpu().numpy()[same_kp], c.desc.float().numpy()[same_kp]
    if kw.get("oriented"):
        assert (gd == cd).mean() >= 0.999
    else:
        np.testing.assert_allclose(gd, cd, atol=1e-2)


@pytest.mark.cuda
def test_depth_dropout_window_recovers_on_the_card(cuda_device):
    """tests/test_engine_e2e.py's 44-frame depth-dropout case, with the port on the
    card and the same assertions."""
    from vo_tpu_torch.engine.pipeline import run_offline_vo
    from vo_tpu_torch.engine.vo import VOConfig
    from vo_tpu_torch.estimation.pnp import PnPConfig
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.utils.synthetic import render_sequence, slalom_trajectory

    F = 44
    traj = slalom_trajectory(F, step=0.8)
    imgs, deps, gt = render_sequence(F, K_SMALL, H=240, W=320, traj=traj)
    rng = np.random.default_rng(8214)
    drop = rng.uniform(size=deps[20:27].shape) < 0.85
    deps[20:27] = np.where(drop, 0.0, deps[20:27])
    cfg = VOConfig(matcher="ratio_binary", pnp=PnPConfig(n_hypotheses=256))
    before = match.launch_wgmma.launches
    poses, diag = run_offline_vo(imgs, deps, K_SMALL, vo_config=cfg,
                                 extractor=OrbLikeExtractor(max_kp=1024),
                                 extraction_batch=16, device=cuda_device)
    assert match.launch_wgmma.launches - before == F - 1
    err = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert err[-1] < 1.0, f"dropout window corrupted trajectory: {err[-1]:.2f} m"
    assert diag.accepted.mean() > 0.85


@pytest.mark.cuda
def test_randint_on_the_card_equals_the_cpu(cuda_device):
    from vo_tpu_torch import prng

    for span in (1, 3, 7, 2048, 2**20 + 3):
        keys = prng.fold_in(prng.key(8214), torch.arange(4))
        got = prng.randint(keys.to(cuda_device), (256, 4), -3, span - 3)
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      prng.randint(keys, (256, 4), -3, span - 3).numpy())


@pytest.mark.cuda
def test_homography_ransac_on_the_card_matches_the_cpu(cuda_device):
    """A plane-induced correspondence set with 30 % outliers: the same key and inputs
    give the CPU's inliers on the card, and H within 1e-4 of its scale of the CPU's
    (the card's eigh is another algorithm than LAPACK's) and of the truth."""
    from vo_tpu_torch import prng
    from vo_tpu_torch.estimation.homography import (apply_homography, homography_from_plane,
                                                    homography_ransac)
    from vo_tpu_torch.geometry.so3 import so3_exp

    rng = np.random.default_rng(75)
    K = torch.tensor([[300.0, 0.0, 320.0], [0.0, 300.0, 240.0], [0.0, 0.0, 1.0]])
    H = homography_from_plane(K, so3_exp(torch.tensor([0.02, -0.03, 0.01])),
                              torch.tensor([0.2, 0.0, 0.4]), torch.tensor([0.0, 1.0, 0.0]), 1.5)
    H = H / H[2, 2]
    src = torch.from_numpy(rng.uniform([100, 260], [540, 470], (400, 2)).astype(np.float32))
    dst = apply_homography(H, src)
    out = torch.from_numpy(rng.uniform(size=400) < 0.3)
    dst[out] += torch.from_numpy(rng.uniform(20, 100, (int(out.sum()), 2)).astype(np.float32))
    valid = torch.ones(400, dtype=torch.bool)
    cpu = homography_ransac(prng.key(5), src, dst, valid)
    gpu = homography_ransac(prng.key(5).to(cuda_device), src.to(cuda_device),
                            dst.to(cuda_device), valid.to(cuda_device))
    assert gpu.H.device.type == "cuda"
    np.testing.assert_array_equal(gpu.inliers.cpu().numpy(), cpu.inliers.numpy())
    scale = float(H.abs().max())
    np.testing.assert_allclose(gpu.H.cpu().numpy(), cpu.H.numpy(), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(gpu.H.cpu().numpy(), H.numpy(), rtol=0, atol=1e-4 * scale)
    assert not (gpu.inliers.cpu() & out).any() and gpu.inliers.cpu()[~out].float().mean() > 0.95


@pytest.mark.cuda
def test_essential_ransac_on_the_card_matches_the_cpu(cuda_device):
    """A clean two-view set: the card's inliers and cheirality choice are the CPU's;
    the pose agrees within the polish's fp32 noise floor (tests/test_torch_mono.py)."""
    from vo_tpu_torch import prng
    from vo_tpu_torch.estimation.essential import essential_ransac
    from vo_tpu_torch.geometry.so3 import so3_exp

    rng = np.random.default_rng(76)
    K = np.array([[700.0, 0.0, 320.0], [0.0, 700.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
    X = np.stack([rng.uniform(-10, 10, 400), rng.uniform(-3, 3, 400),
                  rng.uniform(5, 40, 400)], -1).astype(np.float32)
    R = so3_exp(torch.tensor([0.01, 0.05, 0.0])).numpy()
    X2 = X @ R.T + np.array([1.2, 0.1, 0.6], np.float32)
    uv1 = X[:, :2] / X[:, 2:] * 700.0 + K[:2, 2] + rng.normal(0, 0.3, (400, 2))
    uv2 = X2[:, :2] / X2[:, 2:] * 700.0 + K[:2, 2] + rng.normal(0, 0.3, (400, 2))
    args = [torch.from_numpy(a.astype(np.float32)) for a in (uv1, uv2)]
    valid = torch.ones(400, dtype=torch.bool)
    cpu = essential_ransac(prng.key(0), *args, valid, torch.from_numpy(K))
    gpu = essential_ransac(prng.key(0).to(cuda_device), *(a.to(cuda_device) for a in args),
                           valid.to(cuda_device), torch.from_numpy(K).to(cuda_device))
    np.testing.assert_array_equal(gpu.inliers.cpu().numpy(), cpu.inliers.numpy())
    Tg, Tc = gpu.pose.cpu().numpy().astype(np.float64), cpu.pose.numpy().astype(np.float64)
    np.testing.assert_allclose(Tg[:3, 3], Tc[:3, 3], atol=1e-3)
    cos = (np.trace(Tg[:3, :3].T @ Tc[:3, :3]) - 1.0) / 2.0
    assert np.arccos(np.clip(cos, -1.0, 1.0)) < 0.02


@pytest.mark.cuda
def test_mono_engine_on_the_card(cuda_device):
    """tests/test_mono_engine.py's drive and config on the card: one wgmma launch per
    tracked frame, the plain matcher's poses exactly, and that test's limits."""
    import dataclasses

    from vo_tpu_torch.engine.mono import MonoVOConfig, MonoVOEngine
    from vo_tpu_torch.engine.pipeline import extract_and_backproject
    from vo_tpu_torch.estimation.essential import EssentialConfig
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.utils.synthetic import render_sequence

    imgs, deps, gt = render_sequence(10, K_SMALL, H=240, W=320, step=0.8, yaw_rate=0.01)
    Kd = torch.from_numpy(K_SMALL).to(cuda_device)
    feats, kp3d = extract_and_backproject(OrbLikeExtractor(max_kp=512),
                                          torch.from_numpy(imgs).to(cuda_device),
                                          torch.from_numpy(deps).to(cuda_device), Kd)
    cfg = MonoVOConfig(matcher="ratio_binary", kf_min_matches=60, kf_min_inliers=30,
                       essential=EssentialConfig(min_inliers=15, n_hypotheses=64,
                                                 polish_starts=4))
    args = (feats.kp, feats.desc, feats.valid, kp3d, Kd)
    before = (match.launch_wgmma.launches, match.launch_simt.launches)
    poses, diag = MonoVOEngine(cfg, device=cuda_device).run_sequence(*args)
    torch.cuda.synchronize()
    assert (match.launch_wgmma.launches - before[0], match.launch_simt.launches) == (9, before[1])
    plain, _ = MonoVOEngine(dataclasses.replace(cfg, use_match_kernel=False),
                            device=cuda_device).run_sequence(*args)
    assert torch.equal(plain, poses)
    poses, accept = poses.cpu().numpy(), diag.accepted.cpu().numpy()
    assert np.isfinite(poses).all() and accept.mean() > 0.7
    assert abs(np.median(diag.step_norm.cpu().numpy()[accept]) - 0.8) < 0.2
    assert np.linalg.norm(poses[-1, :3, 3] - gt[-1, :3, 3]) < 1.0


def _syncs_by_file(fn):
    """Run ``fn`` under the CUDA sync-debug mode -> {file of the port: synchronising
    calls made from it} (torch's own calls, such as leaving the mode, are not the
    engine's)."""
    import os
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out: dict = {}
    for w in caught:
        if "synchronizing" in str(w.message) and "vo_tpu_torch" in w.filename:
            name = os.path.basename(w.filename)
            out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.cuda
def test_engine_steps_make_no_host_sync_of_their_own(cuda_device):
    """The RGB-D engine's steps make no host sync; the mono engine's only the SVD's
    status check in ``triangulate`` (ROADMAP queue 2 item 8)."""
    from vo_tpu_torch.engine.mono import MonoVOConfig, MonoVOEngine
    from vo_tpu_torch.engine.pipeline import extract_and_backproject
    from vo_tpu_torch.engine.vo import VOConfig, VOEngine
    from vo_tpu_torch.estimation.essential import EssentialConfig
    from vo_tpu_torch.estimation.pnp import PnPConfig
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.utils.synthetic import render_sequence

    imgs, deps, _ = render_sequence(6, K_SMALL, H=240, W=320, step=0.8, yaw_rate=0.01)
    Kd = torch.from_numpy(K_SMALL).to(cuda_device)
    feats, kp3d = extract_and_backproject(OrbLikeExtractor(max_kp=512),
                                          torch.from_numpy(imgs).to(cuda_device),
                                          torch.from_numpy(deps).to(cuda_device), Kd)
    args = (feats.kp, feats.desc, feats.valid, kp3d, Kd)
    rgbd = VOEngine(VOConfig(pnp=PnPConfig(n_hypotheses=256)), device=cuda_device)
    rgbd.run_sequence(*args)                                   # warm-up
    assert _syncs_by_file(lambda: rgbd.run_sequence(*args)) == {}
    mono = MonoVOEngine(MonoVOConfig(kf_min_matches=60, kf_min_inliers=30,
                                     essential=EssentialConfig(n_hypotheses=64)),
                        device=cuda_device)
    mono.run_sequence(*args)
    syncs = _syncs_by_file(lambda: mono.run_sequence(*args))
    assert set(syncs) == {"triangulation.py"} and syncs["triangulation.py"] <= 2 * 5, syncs


K_R2D2 = np.array([[200.0, 0.0, 120.0], [0.0, 200.0, 90.0], [0.0, 0.0, 1.0]], np.float32)


def _seeded_patchnet(arch, seed=8214):
    """Full-width parameters drawn from a torch generator, He-initialised, with perturbed
    BatchNorm statistics (the published weights are not in the repository)."""
    from vo_tpu_torch.models import patchnet

    spec = {"fast": patchnet.FAST_QUAD_L2NET_CONFCFS, "quad": patchnet.QUAD_L2NET_CONFCFS}[arch]
    g = torch.Generator().manual_seed(seed)
    convs = []
    for cs in spec.convs:
        he = torch.sqrt(torch.tensor(2.0 / (cs.k * cs.k * cs.in_ch))).item()
        convs.append({"w": torch.randn(cs.out_ch, cs.in_ch, cs.k, cs.k, generator=g) * he,
                      "b": torch.zeros(cs.out_ch)})
    d = spec.out_dim
    params = {"convs": convs,
              "clf": {"w": torch.randn(2, d, 1, 1, generator=g) * 0.05, "b": torch.zeros(2)},
              "sal": {"w": torch.randn(1, d, 1, 1, generator=g) * 0.05, "b": torch.zeros(1)}}
    for cs, layer in zip(spec.convs, convs):
        if cs.bn:
            layer["bn_mean"] = 0.1 * torch.randn(cs.out_ch, generator=g)
            layer["bn_var"] = 0.5 + 1.5 * torch.rand(cs.out_ch, generator=g)
    return spec, params


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["fast", "quad"])
def test_patchnet_on_the_card_matches_the_cpu(cuda_device, arch):
    """cuDNN's convolutions against the CPU's on the same parameters and input: fp32
    (TF32 off) within 1e-4; a bf16 trunk within tests/test_torch_r2d2_model.py's bf16
    tolerances (each side rounds near-ties its own way)."""
    from vo_tpu_torch.device import use_fp32_geometry
    from vo_tpu_torch.models.patchnet import apply_patchnet, params_to

    use_fp32_geometry()
    spec, params = _seeded_patchnet(arch)
    x = torch.randn(2, 96, 128, 3, generator=torch.Generator().manual_seed(1))
    gparams = params_to(params, cuda_device)
    for dtype, tol, mean_tol in (("float32", {"descriptors": 1e-4, "reliability": 1e-4,
                                              "repeatability": 1e-4}, 1e-5),
                                 ("bfloat16", {"descriptors": 1e-2, "reliability": 6e-2,
                                               "repeatability": 6e-2}, 2.0 ** -8)):
        cpu = apply_patchnet(params, spec, x, dtype)
        gpu = apply_patchnet(gparams, spec, x.to(cuda_device), dtype)
        for k, t in tol.items():
            d = (gpu[k].cpu() - cpu[k]).abs()
            assert float(d.max()) <= t and float(d.mean()) <= mean_tol, (dtype, k)


@pytest.mark.cuda
def test_r2d2_extraction_repeats_bit_for_bit(cuda_device):
    """Two extractions of the same frames on the card give the same bits (default bf16
    trunk), and an fp32 trunk keeps the CPU's keypoints but for near ties at the cut."""
    from vo_tpu_torch.models.r2d2_extractor import R2D2Extractor
    from vo_tpu_torch.utils.synthetic import render_sequence

    spec, params = _seeded_patchnet("fast")
    imgs, _, _ = render_sequence(4, K_R2D2, H=180, W=240, step=0.8, yaw_rate=0.01)
    kw = dict(max_kp=512, rel_thr=0.0, rep_thr=0.0, score_thr=0.0)
    ex = R2D2Extractor.from_params(spec, params, **kw)
    a, b = ex(imgs, device=cuda_device), ex(imgs, device=cuda_device)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ex32 = R2D2Extractor.from_params(spec, params, compute_dtype="float32", **kw)
    gpu, cpu = ex32(imgs, device=cuda_device), ex32(imgs, device="cpu")
    for f in range(len(imgs)):
        g = {tuple(p) for p in gpu.kp[f].cpu().numpy().tolist()}
        c = {tuple(p) for p in cpu.kp[f].numpy().tolist()}
        assert len(g & c) >= 0.98 * len(c)


@pytest.mark.cuda
def test_ratio_mutual_nn_kernel_on_unit_descriptors(cuda_device):
    """R2D2's matcher at its shape (2048 x 2048 x 128, unit-norm real descriptors stored
    as bf16) through the SIMT kernel against the plain matcher: one launch, the same
    matches wherever best and second differ by more than 1e-4 and the ratio is more than
    1e-4 from its threshold."""
    from vo_tpu_torch.matching.matchers import _unit_dist, ratio_mutual_nn_match
    from vo_tpu_torch.ops.match import ratio_mutual_nn_match_fused

    a, b, va, vb = (torch.from_numpy(x).to(cuda_device)
                    for x in _float(np.random.default_rng(81), 2048, 2048, 128))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    before = (match.launch_wgmma.launches, match.launch_simt.launches)
    got = ratio_mutual_nn_match_fused(a, b, va, vb, ratio=0.9)
    torch.cuda.synchronize()
    assert (match.launch_wgmma.launches, match.launch_simt.launches) == \
        (before[0], before[1] + 1)
    ref = ratio_mutual_nn_match(a.float(), b.float(), va, vb, ratio=0.9)
    _, top2, _ = match.top2_mutual_plain(a, b, va, vb)
    dist = _unit_dist(top2)
    sure = ((top2[:, 0] - top2[:, 1] > 1e-4)
            & ((dist[:, 0] / (dist[:, 1] + 1e-8) - 0.9).abs() > 1e-4)).cpu()
    assert int(got.mask.sum()) > 300
    assert torch.equal(got.mask.cpu()[sure], ref.mask.cpu()[sure])
    assert torch.equal(got.idx.cpu()[sure & ref.mask.cpu()], ref.idx.cpu()[sure & ref.mask.cpu()])


@pytest.mark.cuda
def test_r2d2_engine_on_the_card(cuda_device):
    """16 frames through ``run_offline_vo`` with R2D2 features (seeded weights,
    thresholds 0) and ``ratio_mutual_nn`` at 0.9: one SIMT launch per tracked frame and
    no wgmma launch; the plain matcher's poses up to its first differing match count."""
    import dataclasses

    from vo_tpu_torch.engine.pipeline import run_offline_vo
    from vo_tpu_torch.engine.vo import VOConfig, VOEngine
    from vo_tpu_torch.estimation.pnp import PnPConfig
    from vo_tpu_torch.models.r2d2_extractor import R2D2Extractor
    from vo_tpu_torch.utils.synthetic import render_sequence

    spec, params = _seeded_patchnet("fast")
    imgs, deps, gt = render_sequence(16, K_R2D2, H=180, W=240, step=0.8, yaw_rate=0.01)
    ex = R2D2Extractor.from_params(spec, params, max_kp=512, rel_thr=0.0, rep_thr=0.0,
                                   score_thr=0.0)
    cfg = VOConfig(matcher="ratio_mutual_nn", ratio=0.9, kf_min_matches=60,
                   kf_min_inliers=30, pnp=PnPConfig(min_inliers=12, n_hypotheses=256))
    before = (match.launch_wgmma.launches, match.launch_simt.launches)
    poses, diag, (feats, kp3d) = run_offline_vo(imgs, deps, K_R2D2, vo_config=cfg,
                                                extractor=ex, extraction_batch=8,
                                                return_features=True, device=cuda_device)
    assert (match.launch_wgmma.launches - before[0],
            match.launch_simt.launches - before[1]) == (0, 15)
    assert np.isfinite(poses).all() and diag.accepted.mean() > 0.8
    assert np.linalg.norm(poses[-1, :3, 3] - gt[-1, :3, 3]) < 3.0
    plain, pdiag = VOEngine(dataclasses.replace(cfg, use_match_kernel=False),
                            device=cuda_device).run_sequence(
        feats.kp, feats.desc, feats.valid, kp3d, torch.from_numpy(K_R2D2).to(cuda_device))
    pm = pdiag.n_matches.cpu().numpy()
    split = int(np.argmax(pm != diag.n_matches)) if (pm != diag.n_matches).any() else len(pm)
    np.testing.assert_allclose(plain.cpu().numpy()[:split + 1], poses[:split + 1], atol=5e-3)


def _narrow_train(seed=0):
    from vo_tpu_torch.models import patchnet
    from vo_tpu_torch.train import trainer

    spec = patchnet.PatchNetSpec("narrow", patchnet._fast_quad_specs(2, 64), out_dim=64,
                                 upsample=2)
    return spec, trainer.TrainConfig(batch=4, height=96, width=96)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One ``train_step_batch`` from the same state and batch. In fp64 the card's
    gradients (Adam's first moment, 0.1 g) equal the CPU's within 1e-6 of each leaf's
    largest value (of the network's for the conv biases that train-mode BatchNorm
    follows, whose gradient is rounding noise). In fp32 the loss is within 1e-4
    relative and the parameters within 2.5 lr (Adam's first step is +-lr per weight);
    fp32 gradients of this step are 1e-3-1e-2 of a leaf from the fp64 ones on either
    device, so chip_smoke.py's phase 14 holds them at full width, not here."""
    from vo_tpu_torch import prng
    from vo_tpu_torch.train import trainer
    from vo_tpu_torch.train.pairs import synthetic_pair_batch

    spec, cfg = _narrow_train()
    state = trainer.create_train_state(spec, cfg, device="cpu")
    batch = synthetic_pair_batch(prng.key(3), cfg.batch, cfg.height, cfg.width)

    def step(device, dtype):
        b = tuple(x.to(device, dtype) if x.is_floating_point() else x.to(device) for x in batch)
        return trainer.train_step_batch(trainer.state_to(state, device, dtype), b, spec, cfg)

    (g64, _), (c64, _) = step(cuda_device, torch.float64), step("cpu", torch.float64)
    bn = {("convs", i, "b") for i, l in enumerate(state.params["convs"]) if "bn_mean" in l}
    mu_g = [t.cpu() for t in trainer._leaves(g64.opt_state.mu)]
    mu_c = trainer._leaves(c64.opt_state.mu)
    net = max(float(m.abs().max()) for m in mu_c)
    errs = {p: float((a - b).abs().max()) / (net if p in bn else float(b.abs().max()))
            for p, a, b in zip(trainer.leaf_paths(state.params), mu_g, mu_c)
            if float(b.abs().max()) > 0}
    assert max(errs.values()) <= 1e-6, sorted(errs.items(), key=lambda kv: -kv[1])[:3]

    (g1, gm), (c1, cm) = step(cuda_device, torch.float32), step("cpu", torch.float32)
    assert float(gm["total"]) == pytest.approx(float(cm["total"]), rel=1e-4)
    for a, b in zip(trainer._leaves(g1.params), trainer._leaves(c1.params)):
        assert float((a.cpu() - b).abs().max()) <= 2.5 * cfg.lr


@pytest.mark.cuda
def test_training_repeats_bit_for_bit_on_the_card(cuda_device):
    """Two 4-step runs from one seed give identical parameters and optimizer state."""
    from vo_tpu_torch import prng
    from vo_tpu_torch.train import trainer

    spec, cfg = _narrow_train()
    runs = []
    for _ in range(2):
        state = trainer.create_train_state(spec, cfg, device=cuda_device)
        key = prng.key(5, cuda_device)
        for _ in range(4):
            key, sub = prng.split(key).unbind(-2)
            state, _ = trainer.train_step(state, sub, spec, cfg)
        runs.append(trainer._state_leaves(state))
    for (n, a), (_, b) in zip(*runs):
        assert torch.equal(a, b), n


@pytest.mark.cuda
def test_mma_takes_the_simt_kernel(cuda_device):
    """``evalkit.mma.mutual_matches`` on CUDA tensors: one SIMT launch, the result of
    ``mutual_nn_match`` on the same tensors."""
    from vo_tpu_torch.evalkit.mma import mutual_matches
    from vo_tpu_torch.matching.matchers import mutual_nn_match

    a, b, va, vb = (torch.from_numpy(x).to(cuda_device)
                    for x in _float(np.random.default_rng(84), 1024, 1100, 128))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    before = (match.launch_wgmma.launches, match.launch_simt.launches)
    idx, mask = mutual_matches(a, b, va, vb)
    assert (match.launch_wgmma.launches, match.launch_simt.launches) == \
        (before[0], before[1] + 1)
    ref = mutual_nn_match(a, b, va, vb, threshold=0.9)
    assert np.array_equal(mask, ref.mask.cpu().numpy()) and mask.sum() > 100
    assert np.array_equal(idx[mask], ref.idx.cpu().numpy()[mask])
