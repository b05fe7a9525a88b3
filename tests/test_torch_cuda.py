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
repeat bit for bit, and the MMA harness's matches go through the SIMT kernel. The
distributed layer runs over a one-rank NCCL group (the card's machine has one GPU):
the sharded BA against ``bundle_adjust``, the data-parallel step against the plain
one, and the dry run's CLI. The benchmark (``runners/bench.py``) runs at a small size
through both kernels. The RGB-D engine's CUDA graph: replayed steps equal ``_step``'s
eager steps bit for bit (wgmma, SIMT and plain matchers), one capture per input
signature across engines (not per seed; per engine class) in one shared memory pool,
``OnlineVO`` and a capture inside a stream replaying, the match counters counting
replays and not the capture and the device trace showing one match kernel per replayed
step, and no host sync either way. PnP's Gauss-Newton kernel against its plain version
(poses, inliers and the sum w >= 4 gate, any N and schedule length), bit-identical in a
graph, and its launches in the streaming entry's stats. PnP's hypothesis-bank kernel
against ``_sample_indices`` (the draws, bit for bit) and the plain bank (each
hypothesis, the counts, the pick), on edge cases (no valid point, 1 and 5 valid
points, a DLT-only bank, 256 hypotheses, ragged N, a planar scene, sample sizes 8 and
16), and captured in a graph. The keypoint BRIEF kernel against the dense path and its
plain version bit for bit at the replay's size (256 and 512 bits, invalid rows,
keypoints on the border margin and past the frame); ``OrbLikeExtractor``'s CUDA graph
against its eager body bit for bit (upright BRIEF, SURF, oriented BRIEF), and one
capture per signature over a 10-chunk streaming run, its ``stats`` counting the replays.
"""

import time

import numpy as np
import pytest
import torch

from vo_tpu_torch.ops import kernels, match
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
    from vo_tpu_torch.utils import profiling
    from vo_tpu_torch.utils.synthetic import render_sequence

    imgs, deps, _ = render_sequence(6, K_SMALL, H=240, W=320, step=0.8, yaw_rate=0.01)
    Kd = torch.from_numpy(K_SMALL).to(cuda_device)
    feats, kp3d = extract_and_backproject(OrbLikeExtractor(max_kp=512),
                                          torch.from_numpy(imgs).to(cuda_device),
                                          torch.from_numpy(deps).to(cuda_device), Kd)
    args = (feats.kp, feats.desc, feats.valid, kp3d, Kd)
    rgbd = VOEngine(VOConfig(pnp=PnPConfig(n_hypotheses=256)), device=cuda_device)
    rgbd.run_sequence(*args)                                   # warm-up (the capture)
    assert _syncs_by_file(lambda: rgbd.run_sequence(*args)) == {}
    profiling.start()                                          # the spans add none
    try:
        assert _syncs_by_file(lambda: rgbd.run_sequence(*args)) == {}
    finally:
        spans = profiling.stop()
    steps = [s for s in spans if s.name == "engine.step"]
    assert [s.attrs.get("graph") for s in steps] == [True] * 5
    assert "pnp.ransac" not in [s.name for s in spans]         # recorded at the capture
    state = rgbd.initial_state(*(a[0] for a in args[:4]))
    eager = lambda: _eager_chunk(rgbd, state, *(a[1:] for a in args[:4]), range(1, 6),  # noqa: E731
                                 Kd)
    profiling.start()                                          # the same run, eagerly
    try:
        assert _syncs_by_file(eager) == {}
    finally:
        spans = profiling.stop()
    assert [s.name for s in spans].count("pnp.ransac") == 5
    mono = MonoVOEngine(MonoVOConfig(kf_min_matches=60, kf_min_inliers=30,
                                     essential=EssentialConfig(n_hypotheses=64)),
                        device=cuda_device)
    mono.run_sequence(*args)
    syncs = _syncs_by_file(lambda: mono.run_sequence(*args))
    assert set(syncs) == {"triangulation.py"} and syncs["triangulation.py"] <= 2 * 5, syncs


def _eager_chunk(engine, state, kp, desc, valid, kp3d, frames, K):
    """``VOEngine.run_chunk`` with each step through ``_step`` on the current stream."""
    from vo_tpu_torch import prng
    from vo_tpu_torch.engine.vo import VOStepDiagnostics

    kp3d_valid = engine._depth_valid(valid, kp3d)
    frame_ids = torch.arange(frames.start, frames.stop, dtype=torch.int32,
                             device=kp.device)
    keys = prng.fold_in(prng.key(engine.config.seed, device=kp.device), frame_ids)
    poses, diags = [], []
    for i in range(kp.shape[0]):
        state, pose, diag = engine._step(K, state, kp[i], desc[i], valid[i], kp3d[i],
                                         kp3d_valid[i], frame_ids[i], keys[i])
        poses.append(pose)
        diags.append(diag)
    return state, torch.stack(poses), VOStepDiagnostics(*(torch.stack(x) for x in zip(*diags)))


def _graph_drive(cuda_device, n=10, max_kp=512):
    """Features of a 240 x 320 drive whose frame 5, if it has one, is destroyed (noise,
    no depth), so that the engine rejects a frame and promotes keyframes; the card's K."""
    from vo_tpu_torch.engine.pipeline import extract_and_backproject
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.utils.synthetic import render_sequence

    imgs, deps, _ = render_sequence(n, K_SMALL, H=240, W=320, step=0.8, yaw_rate=0.01)
    if n > 5:
        imgs[5] = np.random.default_rng(0).uniform(0, 255, imgs[5].shape)
        deps[5] = 0.0
    Kd = torch.from_numpy(K_SMALL).to(cuda_device)
    feats, kp3d = extract_and_backproject(OrbLikeExtractor(max_kp=max_kp),
                                          torch.from_numpy(imgs).to(cuda_device),
                                          torch.from_numpy(deps).to(cuda_device), Kd)
    return [feats.kp, feats.desc, feats.valid, kp3d], Kd


@pytest.fixture
def fresh_graphs(monkeypatch):
    """An empty cache of the step's graphs and a new capture stream and memory pool, so
    that the test's first step captures into a pool of its own; the test's graphs are
    dropped at its end."""
    from vo_tpu_torch.engine import vo

    monkeypatch.setattr(vo, "_graphs", {})
    monkeypatch.setattr(vo, "_capture_home", {})


def _kernel_runs(fn) -> dict:
    """-> {kernel name: executions} of ``fn()``'s match kernels in the device trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    runs = {"top2_wgmma_kernel": 0, "top2_simt_kernel": 0}
    for e in prof.profiler.kineto_results.events():
        for name in runs:
            if e.device_type() == torch.autograd.DeviceType.CUDA and name in e.name():
                runs[name] += 1
    return runs


def _graph_config(matcher="ratio_binary", seed=8214, use_match_kernel=True):
    """tests/test_torch_streaming.py's engine."""
    from vo_tpu_torch.engine.vo import VOConfig
    from vo_tpu_torch.estimation.pnp import PnPConfig

    return VOConfig(matcher=matcher, kf_min_matches=60, kf_min_inliers=30, seed=seed,
                    pnp=PnPConfig(min_inliers=15, n_hypotheses=256),
                    use_match_kernel=use_match_kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("matcher, kernel", [("ratio_binary", True), ("ratio_float", True),
                                             ("mutual_nn", False), ("ratio_binary", False)])
def test_replayed_steps_equal_eager_steps_bit_for_bit(cuda_device, fresh_graphs, matcher,
                                                      kernel):
    """Two chunks through the CUDA graph against the same steps through ``_step``:
    poses, diagnostics and carried state identical, on a drive with a rejected frame
    and promoted keyframes; the state handed back is a copy, which the next chunk's
    replays leave as it was. ``ratio_float`` takes the SIMT kernel (unit fp32
    descriptors), ``ratio_binary`` the wgmma kernel or, without it, the plain ratio
    matcher; ``mutual_nn`` is plain torch."""
    from vo_tpu_torch.engine.vo import VOEngine, step_counts

    arrs, Kd = _graph_drive(cuda_device)
    if matcher == "ratio_float":
        arrs[1] = arrs[1].float() / 16.0
    eng = VOEngine(_graph_config(matcher, seed=101, use_match_kernel=kernel),
                   device=cuda_device)
    s0 = eng.initial_state(*(a[0] for a in arrs))
    n = arrs[0].shape[0]
    before = dict(step_counts)
    sa, pa, da = eng.run_chunk(s0, *(a[1:6] for a in arrs), range(1, 6), Kd)
    kept = [t.clone() for t in sa]
    sb, pb, db = eng.run_chunk(sa, *(a[6:] for a in arrs), range(6, n), Kd)
    assert step_counts["graph_replays"] - before["graph_replays"] == n - 2
    assert all(torch.equal(a, b) for a, b in zip(sa, kept))
    ea = _eager_chunk(eng, s0, *(a[1:6] for a in arrs), range(1, 6), Kd)
    eb = _eager_chunk(eng, ea[0], *(a[6:] for a in arrs), range(6, n), Kd)
    for got, want in (((sa, pa, da), ea), ((sb, pb, db), eb)):
        for g, w in zip((*got[0], got[1], *got[2]), (*want[0], want[1], *want[2])):
            assert g.dtype == w.dtype and torch.equal(g, w)
    accepted = torch.cat([da.accepted, db.accepted]).cpu()
    promoted = torch.cat([da.promoted_keyframe, db.promoted_keyframe]).cpu()
    assert not accepted.all() and accepted.float().mean() > 0.5 and promoted.any()


@pytest.mark.cuda
def test_engines_share_one_capture_per_signature(cuda_device, fresh_graphs):
    """Two engines with one config capture once between them and give the same bits; a
    new keypoint budget (a new shape) captures anew."""
    from vo_tpu_torch.engine import vo

    arrs, Kd = _graph_drive(cuda_device, n=5)
    cfg = _graph_config(seed=102)
    before = dict(vo.step_counts)
    p1, d1 = vo.VOEngine(cfg, device=cuda_device).run_sequence(*arrs, Kd)
    p2, d2 = vo.VOEngine(cfg, device=cuda_device).run_sequence(*arrs, Kd)
    counts = {k: vo.step_counts[k] - before[k] for k in ("graph_captures",
                                                          "graph_replays", "eager_steps")}
    assert counts == {"graph_captures": 1, "graph_replays": 7, "eager_steps": 1}
    assert len(vo._graphs) == 1 and vo.step_counts["capture_s"] > 0.0
    assert torch.equal(p1, p2) and all(torch.equal(a, b) for a, b in zip(d1, d2))
    small, Kd = _graph_drive(cuda_device, n=3, max_kp=256)
    vo.VOEngine(cfg, device=cuda_device).run_sequence(*small, Kd)
    assert vo.step_counts["graph_captures"] - before["graph_captures"] == 2
    assert len(vo._graphs) == 2


@pytest.mark.cuda
def test_graph_key_leaves_out_the_seed_and_keeps_the_class(cuda_device, fresh_graphs):
    """Configs that differ in the seed and the depth limits share a graph, and each
    engine's replays equal its own eager steps (its keys and its depth mask are inputs);
    another ratio, or a subclass of the engine, captures a graph of its own, which
    reuses the shared pool's memory: its capture reserves far less than the first."""
    import dataclasses

    from vo_tpu_torch.engine import vo

    arrs, Kd = _graph_drive(cuda_device, n=6)
    cfg = _graph_config(seed=106)
    other = dataclasses.replace(cfg, seed=107, min_point_depth=0.5, max_point_depth=30.0)

    class Sub(vo.VOEngine):
        pass

    grown = []
    for engine, captures in ((vo.VOEngine(cfg, device=cuda_device), 1),
                             (vo.VOEngine(other, device=cuda_device), 0),
                             (vo.VOEngine(dataclasses.replace(cfg, ratio=0.8),
                                          device=cuda_device), 1),
                             (Sub(cfg, device=cuda_device), 1)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved, before = torch.cuda.memory_reserved(), dict(vo.step_counts)
        s0 = engine.initial_state(*(a[0] for a in arrs))
        got = engine.run_chunk(s0, *(a[1:] for a in arrs), range(1, 6), Kd)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert vo.step_counts["graph_captures"] - before["graph_captures"] == captures
        assert vo.step_counts["graph_replays"] - before["graph_replays"] == 5 - captures
        if captures:
            grown.append(torch.cuda.memory_reserved() - reserved)
        want = _eager_chunk(engine, s0, *(a[1:] for a in arrs), range(1, 6), Kd)
        for g, w in zip((*got[0], got[1], *got[2]), (*want[0], want[1], *want[2])):
            assert torch.equal(g, w)
    assert len(vo._graphs) == 3
    print(f"memory reserved by each capture: {grown}")
    assert max(grown[1:]) < grown[0] / 2, grown


@pytest.mark.cuda
@pytest.mark.parametrize("matcher, kernel", [("ratio_binary", "launch_wgmma"),
                                             ("ratio_float", "launch_simt")])
def test_match_counters_count_replays_and_not_the_capture(cuda_device, fresh_graphs, matcher,
                                                          kernel):
    """One match-kernel launch per step, eager or replayed; none for the capture; and in
    the device trace one execution of the kernel per replayed step."""
    from vo_tpu_torch.engine import vo

    arrs, Kd = _graph_drive(cuda_device, n=6)
    if matcher == "ratio_float":
        arrs[1] = arrs[1].float() / 16.0
    counter = getattr(match, kernel)
    other = match.launch_simt if counter is match.launch_wgmma else match.launch_wgmma
    cfg = _graph_config(matcher, seed=103)
    for captures in (1, 0):
        before, n0, m0 = dict(vo.step_counts), counter.launches, other.launches
        runs = _kernel_runs(lambda: vo.VOEngine(cfg, device=cuda_device).run_sequence(
            *arrs, Kd))
        assert vo.step_counts["graph_captures"] - before["graph_captures"] == captures
        assert vo.step_counts["graph_replays"] - before["graph_replays"] == 5 - captures
        assert counter.launches - n0 == 5 and other.launches == m0
        name = "top2_wgmma_kernel" if kernel == "launch_wgmma" else "top2_simt_kernel"
        assert runs == {"top2_wgmma_kernel": 0, "top2_simt_kernel": 0, name: 5}, runs


@pytest.mark.cuda
def test_online_vo_replays(cuda_device, fresh_graphs):
    """``OnlineVO`` steps through the graph: its poses are the eager steps' on its own
    features, and each frame after the first capture is a replay."""
    from vo_tpu_torch.engine import vo
    from vo_tpu_torch.engine.online import OnlineVO
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.utils.synthetic import render_sequence

    imgs, deps, _ = render_sequence(6, K_SMALL, H=240, W=320, step=0.8, yaw_rate=0.01)
    online = OnlineVO(K_SMALL, config=_graph_config(seed=104),
                      extractor=OrbLikeExtractor(max_kp=512), device=cuda_device)
    before = dict(vo.step_counts)
    got = np.stack([online.process_frame(imgs[i], deps[i], i) for i in range(6)])
    assert vo.step_counts["graph_replays"] - before["graph_replays"] == 4
    assert vo.step_counts["eager_steps"] - before["eager_steps"] == 1
    feats = [online._extract(imgs[i], deps[i]) for i in range(6)]
    arrs = [torch.stack(x) for x in zip(*feats)]
    state = online.engine.initial_state(*(a[0] for a in arrs))
    _, poses, diag = _eager_chunk(online.engine, state, *(a[1:] for a in arrs),
                                  range(1, 6), online.K)
    np.testing.assert_array_equal(got[1:], poses.cpu().numpy())
    for a, b in zip(online.last_diagnostics, diag):
        np.testing.assert_array_equal(a, b[-1].cpu().numpy())


@pytest.mark.cuda
def test_capture_inside_a_stream_while_the_loader_uploads(cuda_device, fresh_graphs):
    """The capture made in the streaming entry's first chunk, while its producer thread
    stages the next batches: the same poses as a second run that only replays, and the
    entry's step counts."""
    from vo_tpu_torch.engine.pipeline import run_offline_vo_streaming
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.utils.synthetic import render_sequence

    imgs, deps, _ = render_sequence(12, K_SMALL, H=240, W=320, step=0.8, yaw_rate=0.01)

    def run():
        stats: dict = {}
        batches = ((s, imgs[s:s + 4], deps[s:s + 4]) for s in range(0, 12, 4))
        poses, _, _ = run_offline_vo_streaming(
            batches, 12, K_SMALL, vo_config=_graph_config(seed=105),
            extractor=OrbLikeExtractor(max_kp=512), prefetch=2, transfer_depth="float32",
            device=cuda_device, stats=stats)
        return poses, stats

    (p1, s1), (p2, s2) = run(), run()
    assert (s1["eager_steps"], s1["graph_replays"]) == (1, 10)
    assert (s2["eager_steps"], s2["graph_replays"]) == (0, 11)
    np.testing.assert_array_equal(p1, p2)


def _gn_problem(n, case, seed=5):
    """A PnP solve of ``n`` points (K is the cells' KITTI camera): keyframe points X,
    their pixels under a known motion with 0.5 px noise and 30 % gross outliers, a valid
    mask and the start pose. ``case``: "mixed" (10 % invalid, 5 % of the points behind
    the camera), "all_invalid" (no valid point), "far" (the start pose 0.12 rad and
    2.3 m from the motion)."""
    rng = np.random.default_rng([seed, n])
    K = np.array([[721.53, 0.0, 609.55], [0.0, 721.53, 172.85], [0.0, 0.0, 1.0]],
                 np.float32)
    X = np.stack([rng.uniform(-20, 20, n), rng.uniform(-3, 3, n), rng.uniform(4, 60, n)], 1)
    behind = rng.uniform(size=n) < (0.05 if case == "mixed" else 0.0)
    X[behind, 2] *= -1.0
    ang = 0.04
    R = np.array([[np.cos(ang), 0.0, np.sin(ang)], [0.0, 1.0, 0.0],
                  [-np.sin(ang), 0.0, np.cos(ang)]])
    Y = X @ R.T + np.array([0.2, -0.05, 0.8])
    x = K[:2, :2] @ (Y[:, :2] / np.abs(Y[:, 2:])).T + K[:2, 2:]
    x = x.T + rng.normal(0.0, 0.5, (n, 2))
    out = rng.uniform(size=n) < 0.3
    x[out] += rng.uniform(-100, 100, (int(out.sum()), 2))
    valid = rng.uniform(size=n) > 0.1
    if case == "all_invalid":
        valid[:] = False
    pose0 = np.eye(4)
    if case == "far":
        a = 0.12
        pose0[:3, :3] = [[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                         [0.0, 0.0, 1.0]]
        pose0[:3, 3] = [1.5, -0.8, 1.5]
    elif case == "mixed":
        pose0[:3, :3], pose0[:3, 3] = R, [0.23, -0.04, 0.78]
    return [torch.tensor(a, dtype=torch.float32) for a in (pose0, X, x)] + [
        torch.from_numpy(valid), torch.from_numpy(K)]


def _gn_schedules():
    from vo_tpu_torch.estimation.pnp import PnPConfig

    cfg = PnPConfig()
    return cfg, {"anneal": list(cfg.anneal) + [cfg.reproj_threshold] * 4,
                 "refine": [cfg.reproj_threshold] * cfg.gn_iterations}


def _gn_gate_open(pose, X, x_px, valid, K, cfg, thr) -> bool:
    """Sigma w >= 4 at ``pose``, w as ``_gn_refine_plain`` weighs its points."""
    Y = X @ pose[:3, :3].T + pose[:3, 3]
    z_ok = Y[:, 2] > cfg.min_depth
    z = torch.where(z_ok, Y[:, 2], torch.ones_like(Y[:, 2]))
    u = K[0, 0] * Y[:, 0] / z + K[0, 2]
    v = K[1, 1] * Y[:, 1] / z + K[1, 2]
    res = torch.sqrt((u - x_px[:, 0]) ** 2 + (v - x_px[:, 1]) ** 2)
    return int((valid & z_ok & (res < thr)).sum()) >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 2048, 2049, 4096])
@pytest.mark.parametrize("schedule", ["anneal", "refine"])
@pytest.mark.parametrize("case", ["mixed", "all_invalid", "far"])
def test_gn_kernel_matches_the_plain_version(cuda_device, n, schedule, case):
    """One launch of the Gauss-Newton kernel per solve, against ``_gn_refine_plain`` on
    the card: the pose within 1e-5 m and 1e-5 rad, the same inliers at the final pose,
    and the same Sigma w >= 4 decision at every iteration (the kernel's pose stays put
    exactly where the plain version's gate is shut). No valid point: the pose comes
    back as it went in.

    Both sum in fp32, in different orders, and the kernel is also held within 1e-5 of
    the plain version run in fp64. One case fits a handful of points: the far start
    under the tight schedule at N = 4096 (4 outliers land within 1.5 px). There the
    plain version does not reproduce itself to 1e-5 when only its summation order
    changes (the points permuted: 1.5e-5 m on the card; its CPU run lies 1.7e-5 m
    away), so the bound against it is twice that distance wherever that is the larger.
    """
    from vo_tpu_torch.estimation.pnp import _gn_refine, _gn_refine_plain, _reproject_residuals
    from vo_tpu_torch.ops.pnp_gn import launch_gn

    cfg, schedules = _gn_schedules()
    thr = schedules[schedule]
    pose0, X, x_px, valid, K = (t.to(cuda_device) for t in _gn_problem(n, case))
    before = launch_gn.launches
    got = _gn_refine(pose0, X, x_px, valid, K, cfg, thresholds=thr)
    torch.cuda.synchronize()
    assert launch_gn.launches - before == 1
    want = _gn_refine_plain(pose0, X, x_px, valid, K, cfg, thr)
    exact = _gn_refine_plain(*(t.double() for t in (pose0, X, x_px)), valid, K.double(),
                             cfg, thr)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    reordered = _gn_refine_plain(pose0, X[perm], x_px[perm], valid[perm], K, cfg, thr)
    g, w, e, o = (p.double().cpu().numpy() for p in (got, want, exact, reordered))

    def gaps(a, b):
        """(largest translation gap in m, rotation gap in rad)"""
        return (np.abs(a[:3, 3] - b[:3, 3]).max(),
                np.linalg.norm(a[:3, :3] - b[:3, :3]) / np.sqrt(2.0))

    bounds = [max(1e-5, 2.0 * x) for x in gaps(w, o)]
    assert all(x < b for x, b in zip(gaps(g, w), bounds)), (gaps(g, w), gaps(w, o), g, w)
    assert max(gaps(g, e)) < 1e-5, (gaps(g, e), g, e)
    np.testing.assert_array_equal(g[3], [0.0, 0.0, 0.0, 1.0])
    inl = [(r < cfg.reproj_threshold) & (z > cfg.min_depth) & valid
           for r, z in (_reproject_residuals(p, X, x_px, K) for p in (got, want))]
    assert torch.equal(inl[0], inl[1])
    if case == "all_invalid":
        assert torch.equal(got, pose0)
    # The gate, iteration by iteration: the kernel on each prefix of the schedule
    # against the plain version stepped alone; where the gate is shut the kernel's
    # pose stays exactly as it was.
    p_gpu, p_plain = pose0, pose0
    for k in range(len(thr)):
        gate = _gn_gate_open(p_plain, X, x_px, valid, K, cfg, thr[k])
        assert _gn_gate_open(p_gpu, X, x_px, valid, K, cfg, thr[k]) == gate, k
        nxt = launch_gn(pose0, X, x_px, valid, K, thr[:k + 1], cfg.min_depth)
        assert gate or torch.equal(nxt, p_gpu), k
        p_gpu = nxt
        p_plain = _gn_refine_plain(p_plain, X, x_px, valid, K, cfg, thr[k:k + 1])


@pytest.mark.cuda
def test_gn_kernel_takes_any_schedule_length(cuda_device):
    """An empty schedule launches nothing; 130 iterations take three launches that hand
    the pose on, and land where the plain version does; N = 0 points leaves the pose."""
    from vo_tpu_torch.estimation.pnp import _gn_refine_plain
    from vo_tpu_torch.ops.pnp_gn import launch_gn

    cfg, _ = _gn_schedules()
    pose0, X, x_px, valid, K = (t.to(cuda_device) for t in _gn_problem(2048, "mixed"))
    before = launch_gn.launches
    assert torch.equal(launch_gn(pose0, X, x_px, valid, K, [], cfg.min_depth), pose0)
    thr = [16.0, 4.0] + [1.5] * 128
    got = launch_gn(pose0, X, x_px, valid, K, thr, cfg.min_depth)
    assert launch_gn.launches - before == 3
    want = _gn_refine_plain(pose0, X, x_px, valid, K, cfg, thr)
    assert (got - want).abs().max().item() < 1e-5
    empty = launch_gn(pose0, X[:0], x_px[:0], valid[:0], K, thr[:10], cfg.min_depth)
    assert torch.equal(empty, pose0)


@pytest.mark.cuda
def test_gn_kernel_in_a_graph_repeats_bit_for_bit(cuda_device):
    """The solve captured into a CUDA graph: a launch at the capture goes to the
    capture's tally, each replay counts one, and two replays and the eager call give
    identical bits (a fixed reduction tree, no atomics)."""
    from vo_tpu_torch.estimation.pnp import _gn_refine
    from vo_tpu_torch.ops.pnp_gn import launch_gn

    cfg, schedules = _gn_schedules()
    pose0, X, x_px, valid, K = (t.to(cuda_device) for t in _gn_problem(2048, "far"))
    eager = _gn_refine(pose0, X, x_px, valid, K, cfg, thresholds=schedules["anneal"])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    kernels.begin_capture(cuda_device, stream.cuda_stream)
    before = launch_gn.launches
    with torch.cuda.graph(graph, stream=stream):
        out = _gn_refine(pose0, X, x_px, valid, K, cfg, thresholds=schedules["anneal"])
    capture = kernels.end_capture(cuda_device, stream.cuda_stream)
    assert capture.launches["gn"] == 1 and launch_gn.launches == before
    reps = []
    for _ in range(2):
        graph.replay()
        capture.replayed()
        reps.append(out.clone())
    torch.cuda.synchronize()
    assert launch_gn.launches - before == 2
    assert torch.equal(reps[0], reps[1]) and torch.equal(reps[0], eager)


@pytest.mark.cuda
def test_streaming_stats_time_the_replays_and_count_the_solves(cuda_device, fresh_graphs):
    """The streaming entry asked for ``stats``: the device seconds of its replays
    (events read after its syncs, each replay a positive time below its chunk's wall
    time) and two kernel solves per engine step, eager or replayed."""
    from vo_tpu_torch.engine.pipeline import run_offline_vo_streaming
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.utils.synthetic import render_sequence

    imgs, deps, _ = render_sequence(12, K_SMALL, H=240, W=320, step=0.8, yaw_rate=0.01)
    for _ in range(2):
        stats: dict = {}
        t0 = time.perf_counter()
        batches = ((s, imgs[s:s + 4], deps[s:s + 4]) for s in range(0, 12, 4))
        run_offline_vo_streaming(
            batches, 12, K_SMALL, vo_config=_graph_config(seed=108),
            extractor=OrbLikeExtractor(max_kp=512), prefetch=2, transfer_depth="sparse",
            device=cuda_device, stats=stats)
        wall = time.perf_counter() - t0
        steps = stats["graph_replays"] + stats["eager_steps"]
        assert steps == 11 and stats["gn_kernel_solves"] == 2 * steps
        assert stats["bank_kernel_calls"] == steps
        assert 0.0 < stats["engine_device_s"] < wall


def _bank_problem(n, case, seed=11):
    """A frame's bank on the cells' KITTI camera: keyframe points X, their pixels under a
    known motion (0.5 px noise, 30 % gross outliers), a valid mask (10 % off), the
    current frame's points (2 cm noise) and their mask (15 % off), and the threefry key.
    ``case``: "mixed"; "dlt_only" (no current points); "no_valid"; "valid_<k>" (k valid
    points); "planar" (every keyframe point on one plane: degenerate DLT sets)."""
    from vo_tpu_torch import prng

    rng = np.random.default_rng([seed, n])
    K = np.array([[721.53, 0.0, 609.55], [0.0, 721.53, 172.85], [0.0, 0.0, 1.0]],
                 np.float32)
    X = np.stack([rng.uniform(-20, 20, n), rng.uniform(-3, 3, n), rng.uniform(4, 60, n)], 1)
    if case == "planar":
        X[:, 1] = 1.6
    ang = 0.04
    R = np.array([[np.cos(ang), 0.0, np.sin(ang)], [0.0, 1.0, 0.0],
                  [-np.sin(ang), 0.0, np.cos(ang)]])
    Y = X @ R.T + np.array([0.2, -0.05, 0.8])
    x = (K[:2, :2] @ (Y[:, :2] / Y[:, 2:]).T + K[:2, 2:]).T + rng.normal(0.0, 0.5, (n, 2))
    out = rng.uniform(size=n) < 0.3
    x[out] += rng.uniform(-100, 100, (int(out.sum()), 2))
    valid = rng.uniform(size=n) > 0.1
    if case == "no_valid":
        valid[:] = False
    elif case.startswith("valid_"):
        valid[:] = False
        valid[rng.permutation(n)[:int(case.split("_")[1])]] = True
    f32 = (lambda a: torch.tensor(a, dtype=torch.float32))
    Yc, valid_cur = f32(Y + rng.normal(0.0, 0.02, Y.shape)), torch.from_numpy(
        rng.uniform(size=n) > 0.15)
    if case == "dlt_only":
        Yc = valid_cur = None
    return (prng.fold_in(prng.key(8214), int(seed)), f32(X), f32(x), torch.from_numpy(valid),
            torch.from_numpy(K), Yc, valid_cur)


def _bank_on(dev, n, case, n_hyp=512, m=6):
    """The problem on ``dev`` and its PnPConfig."""
    from vo_tpu_torch.estimation.pnp import PnPConfig

    return ([None if t is None else t.to(dev) for t in _bank_problem(n, case)],
            PnPConfig(n_hypotheses=n_hyp, sample_size=m))


BANK_CASES = [(2048, "mixed", 512, 6), (2049, "mixed", 512, 6), (1000, "dlt_only", 512, 6),
              (2048, "mixed", 256, 6), (37, "mixed", 512, 6), (2048, "no_valid", 512, 6),
              (2048, "valid_1", 512, 6), (2048, "valid_5", 512, 6), (500, "planar", 512, 6),
              (777, "mixed", 128, 16), (2048, "dlt_only", 256, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("n, case, n_hyp, m", BANK_CASES)
def test_bank_kernel_draws_exactly_the_plain_sets(cuda_device, n, case, n_hyp, m):
    """The kernel's minimal sets are ``_sample_indices``' bit for bit: the Kabsch bank
    from split(key)[0] over valid & valid_cur, the DLT bank from split(key)[1] over
    valid, or the DLT bank alone from the key; with no valid point every set is point
    0. One call, two launches, one count."""
    from vo_tpu_torch import prng
    from vo_tpu_torch.estimation.pnp import _sample_indices
    from vo_tpu_torch.ops.pnp_bank import launch_bank

    (key, X, x, valid, K, Xc, vc), cfg = _bank_on(cuda_device, n, case, n_hyp, m)
    before = launch_bank.launches
    bank = launch_bank(key, X, x, valid, K, n_hyp, m, cfg.reproj_threshold, cfg.min_depth,
                       Xc, vc)
    torch.cuda.synchronize()
    assert launch_bank.launches - before == 1
    idx = bank.idx.long()
    if Xc is None:
        assert torch.equal(idx, _sample_indices(key, valid, n_hyp, m))
        return
    n_kab = 3 * n_hyp // 4
    k1, k2 = prng.split(key)
    assert torch.equal(idx[:n_kab, :3], _sample_indices(k1, valid & vc, n_kab, 3))
    assert bool((idx[:n_kab, 3:] == -1).all())
    assert torch.equal(idx[n_kab:], _sample_indices(k2, valid, n_hyp - n_kab, m))
    if case == "no_valid":
        assert int(idx.clamp(min=0).max()) == 0


def _same(a, b) -> bool:
    """Equal bit for bit, NaN where NaN."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n, case, n_hyp, m", BANK_CASES)
def test_bank_kernel_matches_the_plain_bank(cuda_device, n, case, n_hyp, m):
    """Every hypothesis against ``_hypotheses`` on the same CUDA tensors, the counts
    against the plain inlier rule on those poses, and the pick against ``_bank_plain``.

    The kernel repeats the plain version's operations with each rounding where
    PyTorch's CUDA kernels put it (csrc/pnp_bank.cu), so the stated tolerance is none:
    every pose is equal bit for bit (NaN where the plain version's is NaN, as for the
    DLT sets of one repeated point), every count equals the rule's, and the pick is the
    first maximum (``torch.argmax``) with its pose, its count as int64 and its mask."""
    from vo_tpu_torch.estimation.pnp import (_bank, _bank_plain, _hypotheses,
                                             _reproject_residuals)
    from vo_tpu_torch.ops.pnp_bank import launch_bank

    (key, X, x, valid, K, Xc, vc), cfg = _bank_on(cuda_device, n, case, n_hyp, m)
    bank = launch_bank(key, X, x, valid, K, n_hyp, m, cfg.reproj_threshold, cfg.min_depth,
                       Xc, vc)
    plain = _hypotheses(key, X, x, valid, K, cfg, Xc, vc)
    assert _same(bank.poses, plain)
    res, z = _reproject_residuals(plain, X, x, K)
    rule = (res < cfg.reproj_threshold) & (z > cfg.min_depth) & valid
    assert torch.equal(bank.counts.long(), rule.sum(-1))
    best = int(torch.argmax(bank.counts))
    assert torch.equal(bank.pose, bank.poses[best]) and torch.equal(bank.inliers, rule[best])
    assert bank.count.dtype == torch.int64 and int(bank.count) == int(bank.counts.max())
    for a, b in zip(bank[:3], _bank_plain(key, X, x, valid, K, cfg, Xc, vc)):
        assert _same(a, b) and a.dtype == b.dtype
    if not bool(valid.any()):
        assert int(bank.count) == 0 and best == 0
    for a, b in zip(_bank(key, X, x, valid, K, cfg, Xc, vc), bank[:3]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bank_kernel_in_a_graph_counts_one_call_per_replay(cuda_device):
    """The bank captured into a CUDA graph: the capture's tally holds one call, each
    replay counts one, and two replays and the eager call give the same bits."""
    from vo_tpu_torch.estimation.pnp import _bank
    from vo_tpu_torch.ops.pnp_bank import launch_bank

    (key, X, x, valid, K, Xc, vc), cfg = _bank_on(cuda_device, 2048, "mixed")
    eager = _bank(key, X, x, valid, K, cfg, Xc, vc)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    kernels.begin_capture(cuda_device, stream.cuda_stream)
    before = launch_bank.launches
    with torch.cuda.graph(graph, stream=stream):
        out = _bank(key, X, x, valid, K, cfg, Xc, vc)
    capture = kernels.end_capture(cuda_device, stream.cuda_stream)
    assert capture.launches["bank"] == 1 and launch_bank.launches == before
    reps = []
    for _ in range(2):
        graph.replay()
        capture.replayed()
        reps.append([t.clone() for t in out])
    torch.cuda.synchronize()
    assert launch_bank.launches - before == 2
    for a, b, c in zip(reps[0], reps[1], eager):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_device_spans_and_the_profilers_clock(cuda_device):
    """A device span times its work with CUDA events and records none while its stream
    is captured; on the profiler's clock (CUPTI's runtime calls in a CUDA-only trace)
    a span holds its own kernel's launch and not the next one's."""
    from torch.profiler import ProfilerActivity, profile

    from vo_tpu_torch.utils import profiling

    a = torch.randn(2048, 2048, device=cuda_device)
    (a @ a + 1).sum()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiling.start()
        try:
            with profiling.span("mm", device=True):
                b = a @ a
            time.sleep(0.002)
            c = b + 1
            torch.cuda.synchronize()
        finally:
            spans = profiling.stop()
    (mm,) = spans
    assert mm.device_ms > 0.0 and mm.end_ns > mm.start_ns
    calls = [e for e in prof.profiler.kineto_results.events()
             if e.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                             "cuLaunchKernelEx")]
    inside = [mm.start_ns <= e.start_ns() <= mm.end_ns for e in calls]
    assert inside.count(True) >= 1 and inside.count(False) >= 1, inside
    assert inside == sorted(inside, reverse=True)   # the mm's launches, then the add's

    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        c = a * 2 + 1                                # warm-up off the default stream
    torch.cuda.current_stream().wait_stream(side)
    profiling.start()
    try:
        with torch.cuda.graph(g):
            with profiling.span("captured", device=True):
                c = a * 2 + 1
        g.replay()
        torch.cuda.synchronize()
    finally:
        (cap,) = profiling.stop()
    assert cap.name == "captured" and cap.device_ms is None
    assert torch.equal(c, a * 2 + 1)


@pytest.mark.cuda
def test_streaming_spans_on_the_card(cuda_device):
    """The streaming entry's readback waits as spans, ``stats["sync_wait_s"]`` their sum,
    the extraction's device time, and the poses unchanged by the recorder."""
    from vo_tpu_torch.engine.pipeline import run_offline_vo_streaming
    from vo_tpu_torch.engine.vo import VOConfig
    from vo_tpu_torch.estimation.pnp import PnPConfig
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.utils import profiling
    from vo_tpu_torch.utils.synthetic import render_sequence

    imgs, deps, _ = render_sequence(12, K_SMALL, H=240, W=320, step=0.8, yaw_rate=0.01)
    cfg = VOConfig(kf_min_matches=60, kf_min_inliers=30,
                   pnp=PnPConfig(min_inliers=15, n_hypotheses=256))

    def run(stats):
        batches = ((s, imgs[s:s + 4], deps[s:s + 4]) for s in range(0, 12, 4))
        return run_offline_vo_streaming(batches, 12, K_SMALL, vo_config=cfg,
                                        extractor=OrbLikeExtractor(max_kp=512),
                                        transfer_depth="sparse", device=cuda_device,
                                        stats=stats)

    plain = run({})
    stats: dict = {}
    profiling.start()
    try:
        traced = run(stats)
    finally:
        spans = profiling.stop()
    np.testing.assert_array_equal(plain[0], traced[0])
    waits = [s for s in spans if s.name == "stream.sync_wait"]
    assert [s.attrs["what"] for s in waits] == ["readback"] * 3 + ["flush"]
    assert stats["sync_wait_s"] == pytest.approx(
        sum((s.end_ns - s.start_ns) * 1e-9 for s in waits), rel=1e-12, abs=1e-15)
    ext = [s for s in spans if s.name == "stream.extract"]
    assert len(ext) == 3 and all(s.device_ms > 0.0 for s in ext)
    assert all(s.device_ms is None for s in spans if s.name != "stream.extract")


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
        cpu = apply_patchnet(params, spec, x, compute_dtype=dtype)
        gpu = apply_patchnet(gparams, spec, x.to(cuda_device), compute_dtype=dtype)
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


def _gradient_leaf_errors(got, want) -> dict:
    """{path: error / the leaf's largest |g|} of Adam's first moment (0.1 g) of two
    states one step from the same state; the network's largest |g| for the conv biases
    that train-mode BatchNorm follows, whose gradient is rounding noise. Leaves with no
    gradient are left out."""
    from vo_tpu_torch.train import trainer

    params = want.params
    bn = {("convs", i, "b") for i, l in enumerate(params["convs"]) if "bn_mean" in l}
    mu_g = [t.cpu() for t in trainer._leaves(got.opt_state.mu)]
    mu_w = [t.cpu() for t in trainer._leaves(want.opt_state.mu)]
    net = max(float(m.abs().max()) for m in mu_w)
    return {p: float((a - b).abs().max()) / (net if p in bn else float(b.abs().max()))
            for p, a, b in zip(trainer.leaf_paths(params), mu_g, mu_w)
            if float(b.abs().max()) > 0}


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
    errs = _gradient_leaf_errors(g64, c64)
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


@pytest.mark.cuda
def test_one_rank_nccl_sharded_ba_matches_bundle_adjust(cuda_device):
    """``bundle_adjust_sharded`` over a one-rank NCCL group (every collective on CUDA
    tensors through NCCL) against ``bundle_adjust`` on the card within rtol 1e-4, and
    repeatable bit for bit."""
    from vo_tpu_torch.ba import BAConfig, bundle_adjust
    from vo_tpu_torch.ba.distributed import bundle_adjust_sharded
    from vo_tpu_torch.parallel import launch, make_mesh_1d
    from vo_tpu_torch.port_state import ba_problem_from_numpy

    prob = ba_problem_from_numpy(_ba_arrays(np.random.default_rng(85), P=7), cuda_device)

    def solve(rank):
        mesh = make_mesh_1d("kf")
        return [bundle_adjust_sharded(prob, mesh, BAConfig(), "kf") for _ in range(2)]

    (p1, pt1, i1), (p2, pt2, i2) = launch.run_one_rank(solve, "nccl", "cuda")
    ref = bundle_adjust(prob, BAConfig(), device=cuda_device)
    assert p1.device.type == "cuda"
    for got, want in zip((p1, pt1, i1["costs"], i1["final_cost"]),
                         (ref[0], ref[1], ref[2]["costs"], ref[2]["final_cost"])):
        _close(got, want)
    assert torch.equal(p1, p2) and torch.equal(pt1, pt2) and torch.equal(i1["costs"], i2["costs"])


# The data-parallel step over one NCCL rank against the plain step: the bound on a
# gradient leaf, as a share of its largest |g| (the card reads 2.4e-6, PERF.md §6). A
# zero, doubled or wrong-signed gradient is 1.0 or more.
DP_GRAD_TOL = 5e-5


@pytest.mark.cuda
def test_one_rank_nccl_training_step_matches_the_plain_step(cuda_device):
    """The data-parallel ``train_step_batch`` over a one-rank NCCL group (BatchNorm
    moments, the gradient and the metrics through NCCL) against the step with no
    group: the loss within 1e-4 relative, each gradient leaf (Adam's first moment) within
    DP_GRAD_TOL of its scale, the parameters within 2.5 lr."""
    import torch.distributed as dist

    from vo_tpu_torch import prng
    from vo_tpu_torch.parallel import launch
    from vo_tpu_torch.train import trainer
    from vo_tpu_torch.train.pairs import synthetic_pair_batch

    spec, cfg = _narrow_train()
    state = trainer.create_train_state(spec, cfg, device=cuda_device)
    batch = synthetic_pair_batch(prng.key(3, cuda_device), cfg.batch, cfg.height, cfg.width)
    dp, dm = launch.run_one_rank(
        lambda rank: trainer.train_step_batch(state, batch, spec, cfg,
                                              group=dist.group.WORLD), "nccl", "cuda")
    one, om = trainer.train_step_batch(state, batch, spec, cfg)
    assert float(dm["total"]) == pytest.approx(float(om["total"]), rel=1e-4)
    errs = _gradient_leaf_errors(dp, one)
    print(f"worst gradient leaves: {sorted(errs.items(), key=lambda kv: -kv[1])[:3]}")
    assert max(errs.values()) <= DP_GRAD_TOL
    for a, b in zip(trainer._leaves(dp.params), trainer._leaves(one.params)):
        assert float((a - b).abs().max()) <= 2.5 * cfg.lr


@pytest.mark.cuda
def test_dryrun_cli_over_one_nccl_rank(cuda_device, tmp_path):
    """``python -m vo_tpu_torch.runners.dryrun --nprocs 1 --backend nccl`` as a user
    runs it: exit 0 and a report from the card."""
    import json
    import pathlib
    import subprocess
    import sys

    out = tmp_path / "dryrun.json"
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-m", "vo_tpu_torch.runners.dryrun", "--nprocs",
                           "1", "--backend", "nccl", "--out", str(out)],
                          cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(out.read_text())
    assert report["device"].startswith("cuda") and report["backend"] == "nccl"
    assert report["ba_window"]["final_cost"] == pytest.approx(
        report["ba_window"]["final_cost_one"], rel=1e-4)


_TWO_RANKS_ON_ONE_GPU = """
import os, sys, tempfile
import torch, torch.distributed as dist, torch.multiprocessing as mp


def rank_main(rank, path):
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + path, rank=rank, world_size=2)
    try:
        dist.all_reduce(torch.ones(4, device="cuda"))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(os.path.join(tempfile.mkdtemp(), "store"),), nprocs=2)
"""


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_gpu(cuda_device, tmp_path):
    """Why the card runs the distributed code over one rank: NCCL refuses a
    communicator whose ranks share a GPU, at the first collective."""
    import subprocess
    import sys

    script = tmp_path / "two_ranks.py"
    script.write_text(_TWO_RANKS_ON_ONE_GPU)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "Duplicate GPU detected" in proc.stdout + proc.stderr


@pytest.mark.cuda
def test_bench_on_the_card(cuda_device, monkeypatch, tmp_path, capsys):
    """``runners/bench.py`` at tests/test_torch_bench.py's small size on the card: the
    wgmma kernel agrees with the plain matcher, the I/O run reads through the native
    loader, and both kernels ran (the main path's and the SIFT config's)."""
    import json

    from vo_tpu_torch.runners import bench

    sx, sy = 400 / 1232, 120 / 376
    K = np.array([[721.53 * sx, 0.0, 609.55 * sx], [0.0, 721.53 * sx, 172.85 * sy],
                  [0.0, 0.0, 1.0]], np.float32)
    for name, value in dict(H=120, W=400, K=K, EXTRACT_BATCH=2, STEREO_BATCH=2,
                            MAX_KP=256, N_HYPOTHESES=64, N_PASSES=1, LOOP_OUT_FRAMES=2,
                            LOOP_TURN_FRAMES=2, PROCESSES=2).items():
        monkeypatch.setattr(bench, name, value)
    assert bench.main(["--dir", str(tmp_path), "--frames", "4"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["pallas_parity"] is True and line["io_loader"] == "native"
    assert line["device"].startswith("NVIDIA") and line["trajectory_sane"] is True
    assert match.launch_wgmma.launches >= 1 and match.launch_simt.launches >= 1


def _d2net_cell():
    """The ``d2net_ms.extract`` cell's configuration, traffic and driver (the benchmark's
    harness on the path), its seed's weights and frames on the card."""
    import os
    import sys

    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from vobench import d2net_extract, harness

    w = harness.workload("d2net_ms.extract")
    return w["config"], w["traffic"], d2net_extract


@pytest.mark.cuda
def test_d2net_batch_at_kitti_size_within_the_cells_limits(cuda_device):
    """One batch of 8 frames at 376 x 1232 through ``extract_d2net`` against the plain
    reference (``ref_d2net``, frame by frame) with the cell's judge and limits; no
    level's budget drops a keypoint."""
    from vo_tpu_torch.models import d2net

    config, traffic, drv = _d2net_cell()
    inputs = drv.make_inputs(config, traffic, 2 ** 31 + 77, cuda_device)
    stats = {}
    got = drv.call(inputs, traffic, drv.program(config), cuda_device, 1, stats)
    assert got["desc"].shape[-1] == 512 and int(got["valid"].sum()) > 8 * 1000
    numbers = drv.judge(inputs, {1: got}, config, traffic, cuda_device)
    limits = config["correctness"]["limits"]
    assert all(numbers[k] <= v for k, v in limits.items()), numbers
    assert d2net.read_counts(stats)["budget"] == [0, 0, 0]


@pytest.mark.cuda
def test_d2net_counters_make_no_host_sync(cuda_device):
    """``extract_d2net`` on frames already on the card, with its counters gathered,
    makes no host sync; reading them afterwards does."""
    from vo_tpu_torch.models import d2net

    config, traffic, drv = _d2net_cell()
    inputs = drv.make_inputs(config, traffic, 2 ** 31 + 78, cuda_device)
    frames = torch.from_numpy(inputs["rgb"][:2]).to(cuda_device)
    cfg, stats = drv.program(config), {}
    d2net.extract_d2net(inputs["params"], frames, cfg, device=cuda_device)   # warm
    syncs = _syncs_by_file(lambda: [d2net.extract_d2net(inputs["params"], frames, cfg,
                                                        device=cuda_device, stats=stats)
                                    for _ in range(2)])
    assert syncs.get("d2net.py", 0) == 0, syncs
    counts = d2net.read_counts(stats)
    assert all(len(v) == 3 for v in counts.values()) and sum(counts["kept"]) > 0


def _brief_case(dev, B=16, H=376, W=1232, K=2048, seed=23):
    """A batch of noise frames with flat patches (equal compares), keypoints over the
    whole frame and past it, on the 13 px border margin and on the edges, 20 % invalid."""
    rng = np.random.default_rng(seed)
    gray = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    gray[:, 100:140, 200:300] = 77.0
    kp = np.stack([rng.uniform(-3, W + 3, (B, K)), rng.uniform(-3, H + 3, (B, K))],
                  axis=-1).astype(np.float32)
    edge = np.array([[0, 0], [W - 1, H - 1], [12.9, 13.0], [W - 13.5, H - 13.2],
                     [-0.7, 5.5], [W + 40, -40], [250.5, 120.5]], np.float32)
    kp[:, :len(edge)] = edge
    valid = rng.uniform(size=(B, K)) > 0.2
    valid[:, :len(edge)] = True
    return (torch.from_numpy(gray).to(dev), torch.from_numpy(kp).to(dev),
            torch.from_numpy(valid).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [256, 512])
def test_brief_kernel_equals_the_dense_path(cuda_device, bits):
    """The keypoint BRIEF kernel at the replay's size (16 frames of 376 x 1232, 2,048
    keypoints) gives the dense path's bits (``dense_packed_brief`` then
    ``gather_brief_descriptors``) and its plain version's on the same tensors, in one
    launch."""
    from vo_tpu_torch.features import dense_brief
    from vo_tpu_torch.ops import brief
    from vo_tpu_torch.ops.image import gaussian_blur

    gray, kp, valid = _brief_case(cuda_device)
    before = brief.launch_brief.launches
    got = dense_brief.upright_brief_descriptors(gray, kp, valid, bits=bits)
    torch.cuda.synchronize()
    assert brief.launch_brief.launches == before + 1
    dense = dense_brief.gather_brief_descriptors(
        dense_brief.dense_packed_brief(gray, bits=bits), kp, valid, bits=bits)
    offsets = dense_brief._offsets_on(bits, gray.device)
    plain = brief.keypoint_brief_plain(gaussian_blur(gray, 2.0), kp, valid, offsets)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (16, 2048, bits)
    assert torch.equal(got.view(torch.int16), dense.view(torch.int16))
    assert torch.equal(got.view(torch.int16), plain.view(torch.int16))
    assert (got[~valid].view(torch.int16) == 0).all()


@pytest.fixture
def fresh_extract_graphs(monkeypatch):
    """An empty cache of the extraction's graphs, a new capture stream and memory pool."""
    from vo_tpu_torch.features import extractor

    monkeypatch.setattr(extractor, "_graphs", {})
    monkeypatch.setattr(extractor, "_capture_home", {})
    monkeypatch.setattr(extractor, "_last_replay", {})


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(response="hessian", descriptor="surf"),
                                dict(oriented=True)],
                         ids=["harris_brief", "surf", "oriented_brief"])
def test_replayed_extraction_equals_the_eager_one(cuda_device, fresh_extract_graphs, kw):
    """``OrbLikeExtractor`` on the card: the first call of a signature captures its graph
    and gives the eager features; each later call replays it and gives the same bits as
    the body run eagerly, in tensors of its own (not the graph's); numpy input and RGB
    frames take the graph too, one capture per signature."""
    from vo_tpu_torch.features import extractor
    from vo_tpu_torch.ops import brief

    imgs, _, _ = _render_stereo(4, K_SMALL)
    ex = extractor.OrbLikeExtractor(max_kp=512, **kw)
    counts0 = dict(extractor.extract_counts)
    gray = torch.from_numpy(imgs).to(cuda_device)
    eager = ex._extract(gray)
    first = ex(gray)
    brief0 = brief.launch_brief.launches
    reps = [ex(gray), ex(imgs)]
    torch.cuda.synchronize()
    (g,) = extractor._graphs.values()
    for out in (first, *reps):
        for a, b, own in zip(out, eager, g.features):
            assert a.dtype == b.dtype and torch.equal(a, b)
            assert a.data_ptr() != own.data_ptr()
    uses_kernel = not kw                        # only upright BRIEF runs the kernel
    assert brief.launch_brief.launches - brief0 == (2 if uses_kernel else 0)
    rgb = torch.from_numpy(np.repeat(imgs[..., None], 3, axis=-1)).to(cuda_device)
    assert torch.equal(ex(rgb).desc, ex(rgb).desc)
    assert {k: extractor.extract_counts[k] - counts0[k] for k in counts0} == {
        "graph_captures": 2, "graph_replays": 3, "eager_calls": 2}


@pytest.mark.cuda
def test_streaming_extraction_captures_once_and_replays(cuda_device, fresh_extract_graphs):
    """A 10-chunk streaming run captures the extraction once (the first chunk, eager)
    and replays it for the other 9, as its ``stats`` count; a second run replays all 10
    and gives the same features and poses; the BRIEF kernel runs once a chunk."""
    from vo_tpu_torch.engine.pipeline import run_offline_vo_streaming
    from vo_tpu_torch.features import extractor
    from vo_tpu_torch.ops import brief
    from vo_tpu_torch.utils.synthetic import render_sequence

    imgs, deps, _ = render_sequence(40, K_SMALL, H=240, W=320, step=0.8, yaw_rate=0.01)
    runs = []
    for _ in range(2):
        stats: dict = {}
        captures0, brief0 = extractor.extract_counts["graph_captures"], brief.launch_brief.launches
        batches = ((s, imgs[s:s + 4], deps[s:s + 4]) for s in range(0, 40, 4))
        poses, _, (feats, _, _) = run_offline_vo_streaming(
            batches, 40, K_SMALL, vo_config=_graph_config(seed=108),
            extractor=extractor.OrbLikeExtractor(max_kp=512), prefetch=2,
            transfer_depth="sparse", device=cuda_device, stats=stats)
        torch.cuda.synchronize()
        runs.append((poses, feats, stats, extractor.extract_counts["graph_captures"] - captures0,
                     brief.launch_brief.launches - brief0))
    (p0, f0, s0, c0, b0), (p1, f1, s1, c1, b1) = runs
    assert s0["chunks"] == s1["chunks"] == 10 and (c0, c1) == (1, 0) and b0 == b1 == 10
    assert (s0["extract_eager_calls"], s0["extract_graph_replays"]) == (1, 9)
    assert (s1["extract_eager_calls"], s1["extract_graph_replays"]) == (0, 10)
    assert np.array_equal(p0, p1)
    assert all(torch.equal(a, b) for a, b in zip(f0, f1))
