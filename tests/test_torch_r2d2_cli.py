"""``vo_run`` with ``feature_extractor: r2d2`` and ``visualize_results: true``, as users
launch it, against the JAX package's ``vo_run`` on the same directory and YAML.

The published checkpoints are not in the repository, so each package's
``load_pretrained`` is routed to the same seeded Fast network (BatchNorm statistics
perturbed, head biases raised so that the published thresholds keep some keypoints:
tests/test_torch_r2d2_extractor.py). 8 frames of a straight drive at 180 x 240 in the
JAX bench's on-disk format (gray PNG + ``<u2`` millimetres), tests/test_r2d2_e2e.py's
K, 512 keypoints.

The CLIs' default bf16 trunk rounds near-ties each package its own way, and on seeded
weights the engines then part (measured: 0.53 m apart at frame 1). The comparison with
JAX therefore runs both CLIs with an fp32 trunk (``from_pretrained`` wrapped to pass
``compute_dtype="float32"``): poses within 5e-3 m / 1e-3 rad (measured: 2e-6 m), the
same visualisation files, the keypoint and match overlays byte-equal. The default
bf16 CLI is held to the port's own ``run_offline_vo`` on the decoded frames, exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vo_tpu.io.poses import write_kitti_txt
from vo_tpu.models import patchnet as jpatchnet
from vo_tpu.models.r2d2_extractor import R2D2Extractor as JR2D2Extractor
from vo_tpu.runners import vo_run as jvo_run
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch.engine.pipeline import run_offline_vo
from vo_tpu_torch.io.dataset import write_gray_u16mm_dir
from vo_tpu_torch.models import patchnet
from vo_tpu_torch.models.r2d2_extractor import R2D2Extractor
from vo_tpu_torch.port_state import patchnet_params_from_jax
from vo_tpu_torch.runners import vo_run

K = np.array([[200.0, 0.0, 120.0], [0.0, 200.0, 90.0], [0.0, 0.0, 1.0]], np.float32)
F = 8


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(31)
    p = jax.tree_util.tree_map(np.asarray, jpatchnet.init_patchnet_params(
        jax.random.key(0), jpatchnet.FAST_QUAD_L2NET_CONFCFS))
    for layer in p["convs"]:
        if "bn_mean" in layer:
            layer["bn_mean"] = rng.normal(0, 0.1, layer["bn_mean"].shape).astype(np.float32)
            layer["bn_var"] = rng.uniform(0.5, 2.0, layer["bn_var"].shape).astype(np.float32)
    p["clf"]["b"] = np.array([0.0, 4.0], np.float32)
    p["sal"]["b"] = np.array([8.0], np.float32)
    return p


@pytest.fixture
def pretrained(params, monkeypatch):
    """Both packages' ``load_pretrained`` give the seeded network."""
    monkeypatch.setattr("vo_tpu.models.port_weights.load_pretrained",
                        lambda name: (jpatchnet.FAST_QUAD_L2NET_CONFCFS,
                                      jax.tree_util.tree_map(jnp.asarray, params)))
    monkeypatch.setattr("vo_tpu_torch.models.port_weights.load_pretrained",
                        lambda name: (patchnet.FAST_QUAD_L2NET_CONFCFS,
                                      patchnet_params_from_jax(params, device="cpu")))


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    d = tmp_path_factory.mktemp("r2d2_cli")
    imgs, deps, gt = render_sequence(F, K, H=180, W=240, step=0.8, yaw_rate=0.0)
    write_gray_u16mm_dir(str(d / "seq"), imgs, deps)
    write_kitti_txt(str(d / "gt.txt"), gt)
    return d


def _yaml(d, out):
    path = d / f"{out}.yaml"
    path.write_text(f"""feature_extractor: r2d2
image_path: {d / 'seq'}
camera_intrinsic_matrix: [200.0, 0.0, 120.0, 0.0, 200.0, 90.0, 0.0, 0.0, 1.0]
output_filename: {d / out}
gt_txt_file_path: {d / 'gt.txt'}
visualize_results: true
max_keypoints: 512
extraction_batch: 4
kf_min_matches: 60
kf_min_inliers: 30
pnp_min_inliers: 12
pnp_n_hypotheses: 256
""")
    return str(path)


def _fp32_trunk(monkeypatch, cls):
    orig = cls.from_pretrained.__func__

    def from_pretrained(c, name="faster2d2_WASF_N16", max_kp=2048, **kw):
        return orig(c, name, max_kp, compute_dtype="float32", **kw)

    monkeypatch.setattr(cls, "from_pretrained", classmethod(from_pretrained))


def test_vo_run_r2d2_matches_jax(seq, pretrained, monkeypatch, capsys):
    for cls in (JR2D2Extractor, R2D2Extractor):
        _fp32_trunk(monkeypatch, cls)
    assert jvo_run.main(["--config", _yaml(seq, "jax"), "--eval"]) == 0
    res = vo_run.run(["--config", _yaml(seq, "port"), "--eval", "--device", "cpu"])
    assert res.rc == 0 and res.diag.accepted.all()
    out = capsys.readouterr().out
    assert out.count("[eval] seg trans") == 2 and out.count("[viz] wrote overlays for 8") == 2
    jposes, tposes = np.load(seq / "jax.npy"), np.load(seq / "port.npy")
    np.testing.assert_array_equal(tposes, res.poses)
    np.testing.assert_allclose(tposes[:, :3, 3], jposes[:, :3, 3], rtol=0, atol=5e-3)
    rot = np.linalg.norm(tposes[:, :3, :3] - jposes[:, :3, :3], axis=(1, 2)) / np.sqrt(2)
    assert rot.max() < 1e-3
    jviz, tviz = seq / "jax_viz", seq / "port_viz"
    names = sorted(os.listdir(tviz))
    assert names == sorted(os.listdir(jviz)) and "trajectory.png" in names
    assert sum(n.startswith("kps_") for n in names) == F
    assert sum(n.startswith("matches_") for n in names) == F - 1
    for n in names:
        if n != "trajectory.png":
            assert (tviz / n).read_bytes() == (jviz / n).read_bytes(), n


def test_vo_run_r2d2_default_trunk_equals_in_memory(seq, pretrained):
    """The default (bf16) trunk through the CLI: ``run_offline_vo``'s poses and
    diagnostics on the frames as decoded; with sparse retention the overlays cover the
    retained frames."""
    from vo_tpu_torch.io.dataset import RGBDSequence

    res = vo_run.run(["--config", _yaml(seq, "bf16"), "--device", "cpu"])
    assert res.rc == 0
    cfg = vo_run.RunConfig.from_yaml(_yaml(seq, "bf16"))
    ex = vo_run.build_extractor(cfg)
    assert (ex.compute_dtype, ex.max_kp, ex.score_thr) == ("bfloat16", 512, 0.85)
    assert cfg.vo.matcher == "ratio_mutual_nn" and cfg.vo.ratio == 0.9
    decoded = RGBDSequence.from_dir(str(seq / "seq"))
    imgs, deps = (np.stack(x) for x in zip(*(decoded[i] for i in range(F))))
    poses, diag = run_offline_vo(imgs, deps, K, vo_config=cfg.vo, extractor=ex,
                                 extraction_batch=4, device="cpu")
    np.testing.assert_array_equal(res.poses, poses)
    for a, b in zip(res.diag, diag):
        np.testing.assert_array_equal(a, b)

    sparse = vo_run.run(["--config", _yaml(seq, "sparse"), "--device", "cpu", "--refine",
                         "--retain", "sparse", "--depth-transfer", "sparse"])
    rows = sparse.features[2]
    assert 0 < len(rows) < F
    kps = sorted(n for n in os.listdir(seq / "sparse_viz") if n.startswith("kps_"))
    assert kps == [f"kps_{int(i):06d}.png" for i in rows]
