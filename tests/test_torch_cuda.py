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
drive of tests/test_engine_e2e.py to its assertions.
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
