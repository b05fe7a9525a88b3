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
    """The SIFT config's extractor runs on the GPU unless asked for the CPU, and its
    SURF options (not ported yet) raise."""
    imgs = np.random.default_rng(62).uniform(0, 255, (2, 96, 128)).astype(np.float32)
    ex = MultiScaleClassicExtractor(max_kp=32, n_scales=2, response="dog",
                                    descriptor="gradhist", oriented=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex(imgs)
    feats = ex(imgs, device="cpu")
    assert feats.desc.shape == (2, 32, 128) and feats.desc.dtype == torch.bfloat16
    for kw in ({"response": "hessian"}, {"descriptor": "surf"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            MultiScaleClassicExtractor(**kw)


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
