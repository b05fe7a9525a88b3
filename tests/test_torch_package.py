"""Package rules of the port: it imports nothing of JAX or the JAX package, and its
entry points run on the GPU unless the caller asks for the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from vo_tpu_torch.engine.pipeline import run_offline_vo
from vo_tpu_torch.engine.vo import VOEngine
from vo_tpu_torch.features.extractor import OrbLikeExtractor
from vo_tpu_torch.features.pyramid import MultiScaleClassicExtractor

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((ROOT / "vo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {f"vo_tpu_torch/{m}.py" for m in (
        "models/__init__", "models/patchnet", "models/port_weights", "models/r2d2_extractor",
        "models/multiscale", "runners/extract", "utils/viz", "evalkit/plotting",
        "train/__init__", "train/pairs", "train/losses", "train/trainer", "train/datasets",
        "runners/train_r2d2", "runners/retrain_parity", "evalkit/mma", "utils/seg",
        "utils/profiling", "utils/debug", "prng", "models/patchnet", "port_state",
        "parallel/__init__", "parallel/mesh", "parallel/comm", "parallel/launch",
        "ba/distributed", "runners/dryrun", "runners/bench")} <= names
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "vo_tpu", "flax", "optax"), \
                f"{path.relative_to(ROOT)} imports {mod}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(no_cuda):
    imgs = np.zeros((2, 64, 64), np.float32)
    K = np.eye(3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_offline_vo(imgs, imgs, K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VOEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OrbLikeExtractor(max_kp=16)(imgs)


def test_streaming_online_and_cli_raise_without_gpu(no_cuda, tmp_path):
    """The streaming runner, the per-frame API and the CLI default to the GPU too, and
    raise before reading a frame."""
    from vo_tpu_torch.engine.online import OnlineVO
    from vo_tpu_torch.engine.pipeline import run_offline_vo_streaming
    from vo_tpu_torch.runners import synthetic_demo, vo_run

    K = np.eye(3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OnlineVO(K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_offline_vo_streaming(iter(()), 4, K)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"image_path: {tmp_path}\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vo_run.main(["--config", str(cfg)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_demo.main(["--frames", "2"])
    assert OnlineVO(K, device="cpu").device.type == "cpu"


def test_distributed_entry_points_raise_without_gpu(no_cuda):
    """The dry run and the launcher default to NCCL on the card, and raise before
    starting a process without one."""
    from vo_tpu_torch.parallel import launch
    from vo_tpu_torch.runners import dryrun

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--nprocs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(print, 2, "nccl", "cuda")


def test_multiscale_extractor_gpu_default_and_unported_options(no_cuda):
    """The SIFT config's extractor runs on the GPU unless asked for the CPU; its SURF
    options (ported now) do the same."""
    imgs = np.random.default_rng(62).uniform(0, 255, (2, 96, 128)).astype(np.float32)
    ex = MultiScaleClassicExtractor(max_kp=32, n_scales=2, response="dog",
                                    descriptor="gradhist", oriented=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex(imgs)
    feats = ex(imgs, device="cpu")
    assert feats.desc.shape == (2, 32, 128) and feats.desc.dtype == torch.bfloat16
    surf = MultiScaleClassicExtractor(max_kp=32, n_scales=2, response="hessian",
                                      descriptor="surf")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        surf(imgs)
    assert surf(imgs, device="cpu").desc.shape == (2, 32, 64)


def test_front_ends_default_to_gpu(no_cuda):
    """The stereo front-end and the oriented-BRIEF and SURF extractors raise without a
    GPU, and run when asked for the CPU."""
    from vo_tpu_torch.engine.pipeline import stereo_extract_and_backproject
    from vo_tpu_torch.features.stereo import stereo_depth_at

    rng = np.random.default_rng(64)
    imgs = rng.uniform(0, 255, (2, 96, 200)).astype(np.float32)
    K = np.array([[100.0, 0, 100], [0, 100, 48], [0, 0, 1]], np.float32)
    kp, valid = np.array([[150.0, 40.0]], np.float32), np.ones(1, bool)
    calls = [lambda **kw: stereo_depth_at(imgs[0], imgs[1], kp, valid, K, 0.5,
                                          max_disp=32, **kw),
             lambda **kw: stereo_extract_and_backproject(
                 OrbLikeExtractor(max_kp=16), imgs, imgs, K, 0.5, max_disp=32, **kw),
             lambda **kw: OrbLikeExtractor(max_kp=16, oriented=True)(imgs, **kw),
             lambda **kw: OrbLikeExtractor(max_kp=16, response="hessian",
                                           descriptor="surf")(imgs, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")


def test_refinement_and_solvers_default_to_gpu(no_cuda):
    """``refine_full``, ``refine_trajectory``, the loop-closure functions and both
    solvers raise without a GPU, and run when asked for the CPU."""
    from vo_tpu_torch.ba import BAProblem, bundle_adjust, optimize_pose_graph
    from vo_tpu_torch.engine.loop_closure import detect_loop_closures, optimize_with_loops
    from vo_tpu_torch.engine.refine import refine_full, refine_trajectory

    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 2, 3] = np.arange(3.0)
    feats = (np.zeros((3, 4, 2), np.float32), np.ones((3, 4, 8), np.float32),
             np.zeros((3, 4), bool), np.zeros((3, 4, 3), np.float32))
    K = np.eye(3, dtype=np.float32)
    prob = BAProblem(torch.eye(4).repeat(2, 1, 1), torch.zeros(3, 3),
                     torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, 4, 2),
                     torch.zeros(2, 4, dtype=torch.bool), torch.eye(3))
    edges, w = np.array([[0, 1], [1, 2]]), np.ones(2, np.float32)
    calls = [lambda **kw: refine_full(poses, *feats, K, **kw),
             lambda **kw: refine_trajectory(poses, *feats, K, **kw),
             lambda **kw: detect_loop_closures([0, 2], poses, *feats, K, **kw),
             lambda **kw: optimize_with_loops(poses, [0, 2], [], **kw),
             lambda **kw: bundle_adjust(prob, **kw),
             lambda **kw: optimize_pose_graph(poses, edges, poses[:2], w, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    out, _, _ = bundle_adjust(prob, device="cpu")
    assert out.device.type == "cpu" and torch.isfinite(out).all()


def test_mono_slice_defaults_to_gpu(no_cuda, tmp_path):
    """The mono engine, the essential-matrix and homography RANSACs, triangulation and
    the long-run runner raise without a GPU, and run when asked for the CPU (or given
    CPU tensors)."""
    from vo_tpu_torch import prng
    from vo_tpu_torch.engine.mono import MonoVOEngine
    from vo_tpu_torch.estimation.essential import EssentialConfig, essential_ransac
    from vo_tpu_torch.estimation.homography import homography_ransac
    from vo_tpu_torch.geometry.triangulation import triangulate
    from vo_tpu_torch.runners import longrun

    rng = np.random.default_rng(65)
    kp1 = rng.uniform(0, 100, (40, 2)).astype(np.float32)
    kp2 = kp1 + np.float32(3.0)
    valid, K = np.ones(40, bool), np.array([[100.0, 0, 50], [0, 100, 50], [0, 0, 1]],
                                          np.float32)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.5
    key = prng.key(0)
    ecfg = EssentialConfig(n_hypotheses=8, polish_starts=2, polish_iters=2)
    calls = [lambda **kw: essential_ransac(key, kp1, kp2, valid, K, ecfg, **kw),
             lambda **kw: homography_ransac(key, kp1, kp2, valid, **kw),
             lambda **kw: triangulate(kp1, kp2, np.eye(4, dtype=np.float32), T, K, **kw),
             lambda **kw: MonoVOEngine(**kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        longrun.main(["--dir", str(tmp_path)])
    assert longrun.main(["--dir", str(tmp_path)], device="cpu") == 1   # no frames there
    # CPU tensors run where they lie; the engine runs where its features lie.
    res = essential_ransac(key, torch.from_numpy(kp1), torch.from_numpy(kp2),
                           torch.from_numpy(valid), torch.from_numpy(K), ecfg)
    assert res.pose.device.type == "cpu"
    F = 3
    poses, diag = MonoVOEngine(device="cpu").run_sequence(
        torch.from_numpy(np.stack([kp1] * F)), torch.ones(F, 40, 256, dtype=torch.bfloat16),
        torch.ones(F, 40, dtype=torch.bool), torch.ones(F, 40, 3), torch.from_numpy(K))
    assert poses.shape == (F, 4, 4) and diag.accepted.shape == (F - 1,)


def test_bench_defaults_to_gpu(no_cuda, tmp_path):
    """The benchmark raises without a GPU before it renders a frame; with
    ``--device cpu`` it runs (tests/test_torch_bench.py, at a small size, with CUDA
    reported absent as here)."""
    from vo_tpu_torch.runners import bench

    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--dir", str(tmp_path / "seq")])
    assert not (tmp_path / "seq").exists()


def test_r2d2_slice_defaults_to_gpu(no_cuda, tmp_path):
    """The R2D2 extractors, the carried-across parameters and the extract CLI raise
    without a GPU, and run when asked for the CPU."""
    from vo_tpu_torch import prng
    from vo_tpu_torch.models.multiscale import MultiscaleConfig, extract_multiscale
    from vo_tpu_torch.models.patchnet import FAST_QUAD_L2NET_CONFCFS, init_patchnet_params
    from vo_tpu_torch.models.r2d2_extractor import R2D2Extractor
    from vo_tpu_torch.port_state import patchnet_params_from_jax
    from vo_tpu_torch.runners import extract

    params = init_patchnet_params(prng.key(0), FAST_QUAD_L2NET_CONFCFS)
    imgs = np.random.default_rng(66).uniform(0, 255, (1, 40, 48)).astype(np.float32)
    ex = R2D2Extractor.from_params(FAST_QUAD_L2NET_CONFCFS, params, max_kp=8)
    cfg = MultiscaleConfig(min_size=32, top_k=16, per_scale_k=8)
    as_jax = {"convs": [{k: np.transpose(v.numpy(), (2, 3, 1, 0)) if k == "w" else v.numpy()
                         for k, v in layer.items()} for layer in params["convs"]],
              **{h: {"w": np.transpose(params[h]["w"].numpy(), (2, 3, 1, 0)),
                     "b": params[h]["b"].numpy()} for h in ("clf", "sal")}}
    calls = [lambda **kw: ex(imgs, **kw),
             lambda **kw: extract_multiscale(params, FAST_QUAD_L2NET_CONFCFS, imgs, cfg, **kw),
             lambda **kw: patchnet_params_from_jax(as_jax, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    assert ex(imgs, device="cpu").desc.device.type == "cpu"
    back = patchnet_params_from_jax(as_jax, device="cpu")
    assert torch.equal(back["convs"][3]["w"], params["convs"][3]["w"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract.main(["--images", str(tmp_path / "x.png")])


def test_training_slice_defaults_to_gpu(no_cuda, tmp_path):
    """The trainer, the training CLIs, the MMA harness, the segmentation net and the
    carried-across training state raise without a GPU, and run when asked for the CPU
    (or given CPU tensors)."""
    from vo_tpu_torch import prng
    from vo_tpu_torch.evalkit.mma import mma_on_warps
    from vo_tpu_torch.models import patchnet
    from vo_tpu_torch.port_state import segnet_params_from_jax, train_state_from_jax
    from vo_tpu_torch.runners import retrain_parity, train_r2d2
    from vo_tpu_torch.train import trainer
    from vo_tpu_torch.utils import seg

    spec = patchnet.PatchNetSpec("t", patchnet._fast_quad_specs(1, 8), out_dim=8, upsample=2)
    cfg = trainer.TrainConfig(batch=1, height=32, width=32)
    state = trainer.create_train_state(spec, cfg, device="cpu")
    as_jax = lambda p: {"convs": [{k: np.transpose(v.numpy(), (2, 3, 1, 0)) if k == "w"
                                   else v.numpy() for k, v in layer.items()}
                                  for layer in p["convs"]],
                        **{h: {"w": np.transpose(p[h]["w"].numpy(), (2, 3, 1, 0)),
                               "b": p[h]["b"].numpy()} for h in ("clf", "sal")}}
    from collections import namedtuple
    adam = namedtuple("ScaleByAdamState", "count mu nu")(0, as_jax(state.opt_state.mu),
                                                         as_jax(state.opt_state.nu))
    segp = {k: {"w": np.zeros((3, 3, 3, 4), np.float32), "b": np.zeros(4, np.float32)}
            for k in ("stem",)}
    imgs = np.random.default_rng(67).uniform(0, 255, (1, 32, 32)).astype(np.float32)
    calls = [lambda **kw: trainer.create_train_state(spec, cfg, **kw),
             lambda **kw: train_state_from_jax(as_jax(state.params), (adam,), 0, **kw),
             lambda **kw: segnet_params_from_jax(segp, **kw),
             lambda **kw: seg.heuristic_road_mask(imgs[0], **kw),
             lambda **kw: mma_on_warps(lambda im: None, imgs, prng.key(0), **kw)]
    for call in calls[:4]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[4]()
    for main in (lambda a: train_r2d2.main(a + ["--save-path", str(tmp_path / "c")]),
                 lambda a: retrain_parity.main(a + ["--out", str(tmp_path / "r.json")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--steps", "1"])
    new, metrics = trainer.train_step(state, prng.key(0), spec, cfg)
    assert new.step.device.type == "cpu" and int(new.step) == 1
    assert bool(seg.heuristic_road_mask(torch.from_numpy(imgs[0])).device.type == "cpu")


def test_entry_points_run_on_cpu_when_asked(no_cuda):
    imgs = np.random.default_rng(61).uniform(0, 255, (2, 64, 64)).astype(np.float32)
    feats = OrbLikeExtractor(max_kp=16, border=14)(imgs, device="cpu")
    assert feats.kp.device.type == "cpu" and feats.desc.shape == (2, 16, 256)
    assert VOEngine(device="cpu").device.type == "cpu"


def test_geometry_precision_flags_set(no_cuda):
    VOEngine(device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("x", [np.float32(3.5), np.array(7, np.int32), [[1.0, 2.0]],
                               np.arange(6.0).reshape(2, 3)[:, ::2]])
def test_to_device_keeps_the_shape(x):
    """A 0-d array stays 0-d (a train state's counts are); strided views are copied."""
    from vo_tpu_torch.device import to_device

    t = to_device(x, torch.device("cpu"))
    assert t.shape == np.shape(x) and np.array_equal(t.numpy(), np.asarray(x))
