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
