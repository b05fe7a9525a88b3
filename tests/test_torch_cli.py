"""The port's entry points as users launch them: ``vo_run`` on a directory of frames
(against the JAX package's ``vo_run`` on the same directory and YAML), resuming
through the CLI, ``--refine`` with ``--save-odometry``, the options not ported yet, and
the per-frame ``OnlineVO``.

Configuration as tests/test_torch_engine.py (10 rendered frames, 240 x 320, 512
keypoints, 256 hypotheses), streamed in batches of 4. Tolerances: against JAX,
per-frame poses within 5e-3 m / 1e-3 rad (the engine parity of that file); the CLI
equals the port's in-memory run on the decoded frames, and a resumed run the
uninterrupted one; ``OnlineVO`` within 1e-4 m of the offline run (tests/test_online.py's
tolerance).

The CLI reads frames from disk as uint8, and on uint8 frames of a turning drive the
two packages' PnP-RANSAC splits on near-tied solutions although their features are
identical (measured: yaw rate 0.004 rad/frame, frame 1, equal inlier counts, poses
4.7 cm apart; ROADMAP.md section 3). The CLI comparison with JAX therefore renders a
straight drive (measured: 7e-6 m apart); ``OnlineVO`` runs on test_torch_engine.py's
turning frames as they are rendered (fp32).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vo_tpu.engine.online import OnlineVO as JOnlineVO
from vo_tpu.engine.vo import VOConfig as JVOConfig
from vo_tpu.estimation.pnp import PnPConfig as JPnPConfig
from vo_tpu.features.extractor import OrbLikeExtractor as JExtractor
from vo_tpu.io.poses import write_kitti_txt
from vo_tpu.runners import vo_run as jvo_run
from vo_tpu.utils.synthetic import render_sequence
from vo_tpu_torch.engine.online import OnlineVO
from vo_tpu_torch.engine.pipeline import run_offline_vo
from vo_tpu_torch.engine.refine import refine_full
from vo_tpu_torch.io.dataset import write_gray_u16mm_dir
from vo_tpu_torch.port_state import config_from_jax
from vo_tpu_torch.runners import vo_run

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
F = 10
JCFG = JVOConfig(matcher="ratio_binary", kf_min_matches=60, kf_min_inliers=30,
                 pnp=JPnPConfig(min_inliers=15, n_hypotheses=256))
JEX = JExtractor(max_kp=512)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its workers, and an
    oversubscribed thread pool made the port's runs here several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return render_sequence(F, K, H=240, W=320, step=0.8, yaw_rate=0.0)


@pytest.fixture(scope="module")
def turning_frames():
    return render_sequence(F, K, H=240, W=320, step=0.8, yaw_rate=0.01)


@pytest.fixture(scope="module")
def seq(frames, tmp_path_factory):
    """The sequence in the JAX bench's on-disk format (8-bit gray PNG + ``<u2``
    millimetre npy), with its ground truth as KITTI txt."""
    d = tmp_path_factory.mktemp("cli")
    imgs, deps, gt = frames
    write_gray_u16mm_dir(str(d / "seq"), imgs, deps)
    write_kitti_txt(str(d / "gt.txt"), gt)
    return d


@pytest.fixture(scope="module")
def decoded(frames):
    """The frames as the loaders decode them: uint8 gray, millimetres as metres."""
    imgs, deps, _ = frames
    mm = np.round(np.clip(deps, 0.0, 65.535) * 1000.0).astype(np.uint16)
    return np.clip(imgs, 0, 255).astype(np.uint8), mm.astype(np.float32) * 1e-3


def _yaml(d, out, batch=4):
    path = d / f"{out}.yaml"
    path.write_text(f"""feature_extractor: orb
image_path: {d / 'seq'}
camera_intrinsic_matrix: [260.0, 0.0, 160.0, 0.0, 260.0, 120.0, 0.0, 0.0, 1.0]
output_filename: {d / out}
gt_txt_file_path: {d / 'gt.txt'}
max_keypoints: 512
extraction_batch: {batch}
kf_min_matches: 60
kf_min_inliers: 30
pnp_min_inliers: 15
pnp_n_hypotheses: 256
""")
    return str(path)


SPARSE = ["--depth-transfer", "sparse"]


@pytest.fixture(scope="module")
def port_cli(seq):
    res = vo_run.run(["--config", _yaml(seq, "port"), "--eval", "--device", "cpu"] + SPARSE)
    assert res.rc == 0 and res.loader == "native"
    return res


def _assert_frames_agree(jposes, jdiag, tposes, tdiag, trans_tol=5e-3, rot_tol=1e-3):
    if jdiag is not None:
        for f in ("n_matches", "accepted", "promoted_keyframe"):
            np.testing.assert_array_equal(np.asarray(getattr(tdiag, f)),
                                          np.asarray(getattr(jdiag, f)), err_msg=f)
    jposes, tposes = np.asarray(jposes, np.float64), np.asarray(tposes, np.float64)
    assert tposes.shape == jposes.shape
    assert np.abs(tposes[:, :3, 3] - jposes[:, :3, 3]).max() < trans_tol
    rot = np.linalg.norm(tposes[:, :3, :3] - jposes[:, :3, :3], axis=(1, 2)) / np.sqrt(2)
    assert rot.max() < rot_tol


def test_cli_matches_jax(seq, port_cli, capsys):
    """The bench's io-included path (native loader, gray + u16mm, sparse depth
    transfer) through both packages' CLIs, on one YAML. Its batches of 5 give the
    JAX package two chunks of one length to compile."""
    cfg = _yaml(seq, "both", batch=5)
    assert jvo_run.main(["--config", cfg, "--eval"] + SPARSE) == 0
    jposes = np.load(seq / "both.npy")
    out = capsys.readouterr().out
    assert "native loader" in out and "[eval] seg trans" in out
    res = vo_run.run(["--config", cfg, "--eval", "--device", "cpu"] + SPARSE)
    tposes = np.load(seq / "both.npy")
    np.testing.assert_array_equal(tposes, res.poses)
    assert tposes.shape == (F, 4, 4) and np.isfinite(tposes).all()
    _assert_frames_agree(jposes, None, tposes, None)
    # the batch size does not change the port's result
    np.testing.assert_array_equal(tposes, port_cli.poses)
    assert res.diag.accepted.all() and res.diag.promoted_keyframe.any()


@pytest.mark.parametrize("mode", ["sparse", "float32"])
def test_cli_equals_in_memory_run_on_decoded_frames(seq, decoded, port_cli, mode):
    """The CLI gives ``run_offline_vo``'s poses on the frames as decoded: gray in
    sparse mode, gray replicated to RGB in float32 mode (the loader emits RGB)."""
    gray, metres = decoded
    cfg = vo_run.RunConfig.from_yaml(_yaml(seq, "cfg"))
    if mode == "sparse":
        res = port_cli
    else:
        res = vo_run.run(["--config", _yaml(seq, "f32"), "--device", "cpu"])
        gray = np.repeat(gray[..., None], 3, axis=-1)
    poses, diag = run_offline_vo(gray, metres, K, vo_config=cfg.vo,
                                 extractor=vo_run.build_extractor(cfg),
                                 extraction_batch=4, device="cpu")
    np.testing.assert_array_equal(res.poses, poses)
    for a, b in zip(res.diag, diag):
        np.testing.assert_array_equal(a, b)


def test_cli_first_line_names_loader(seq, capsys):
    vo_run.main(["--config", _yaml(seq, "limit"), "--limit", "5", "--device", "cpu",
                 "--depth-transfer", "sparse"])
    first = capsys.readouterr().out.splitlines()[0]
    assert "5 frames" in first and "native loader" in first and "sparse" in first
    assert np.load(seq / "limit.npy").shape == (5, 4, 4)


def test_cli_resume(seq, port_cli):
    ck = str(seq / "ck.npz")
    args = ["--config", _yaml(seq, "resumed"), "--device", "cpu"] + SPARSE
    assert vo_run.main(args + ["--limit", "8", "--checkpoint", ck,
                               "--checkpoint-every", "4"]) == 0
    with np.load(ck) as blob:
        assert int(blob["next_frame"]) == 8
    res = vo_run.run(args + ["--resume", ck])
    assert res.rc == 0 and res.loader == "native"
    np.testing.assert_array_equal(np.load(seq / "resumed.npy"), port_cli.poses)


@pytest.mark.parametrize("retain", ["all", "sparse"])
def test_cli_refine_and_save_odometry(seq, port_cli, retain, capsys):
    """``--refine --save-odometry``: the written poses are ``refine_full``'s on the
    CLI's own odometry and features (``feat_rows`` with sparse retention), and the
    odometry file is its ``refined_odometry``. The straight drive revisits nothing, so
    the adaptive branch leaves the odometry as it is."""
    name, odo = f"refined_{retain}", str(seq / f"odometry_{retain}")
    res = vo_run.run(["--config", _yaml(seq, name), "--device", "cpu", "--refine",
                      "--save-odometry", odo, "--retain", retain] + SPARSE)
    assert res.rc == 0
    out = capsys.readouterr().out
    assert "[refine] pose graph: 0 loop edges" in out and "odometry-stage" in out
    np.testing.assert_array_equal(res.odometry, port_cli.poses)
    feats, kp3d, rows = res.features
    assert (feats.kp.shape[0] < F) == (retain == "sparse") and len(rows) == feats.kp.shape[0]
    closed, info = refine_full(res.odometry, feats.kp, feats.desc, feats.valid, kp3d, K,
                               diag_promoted=res.diag.promoted_keyframe,
                               feat_rows=None if retain == "all" else rows, device="cpu")
    np.testing.assert_array_equal(res.poses, closed)
    np.testing.assert_array_equal(np.load(seq / f"{name}.npy"), closed)
    np.testing.assert_array_equal(np.load(odo + ".npy"), info["refined_odometry"])
    np.testing.assert_array_equal(res.refine["refined_odometry"], info["refined_odometry"])
    assert res.refine["keyframes"].tolist() == info["keyframes"].tolist()


@pytest.mark.parametrize("case", ["visualize", "r2d2"])
def test_unported_options_raise_before_reading(tmp_path, case):
    """Each raises NotImplementedError naming its ROADMAP item, before any frame is
    read (the image path does not even exist), with ``--refine`` or without.
    (``feature_extractor: surf`` is ported: tests/test_torch_surf.py.)"""
    extra = {"visualize": "visualize_results: true\n",
             "r2d2": "feature_extractor: r2d2\n"}
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"image_path: {tmp_path / 'missing'}\n" + extra[case])
    for flags in ([], ["--refine", "--save-odometry", str(tmp_path / "odo")]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            vo_run.main(["--config", str(cfg), "--device", "cpu"] + flags)


def test_cli_empty_directory(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"image_path: {tmp_path}\n")
    assert vo_run.main(["--config", str(cfg), "--device", "cpu"]) == 2


def test_online_matches_offline_and_jax(turning_frames):
    imgs, deps, _ = turning_frames
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    ex = config_from_jax(dataclasses.asdict(JEX))
    offline, diag = run_offline_vo(imgs, deps, K, vo_config=cfg, extractor=ex,
                                   device="cpu")
    vo = OnlineVO(K, config=cfg, extractor=ex, device="cpu")
    online = []
    for i in range(F):
        online.append(vo.process_frame(imgs[i], deps[i], i))
        if i:
            assert vo.last_diagnostics.n_matches == diag.n_matches[i - 1]
    online = np.stack(online)
    assert np.abs(online - offline).max() < 1e-4

    jvo = JOnlineVO(K, config=JCFG, extractor=JEX)
    jonline = np.stack([jvo.process_frame(imgs[i], deps[i], i) for i in range(F)])
    _assert_frames_agree(jonline, None, online, None)

    vo.reset()                                   # a new run from the current frame
    assert np.array_equal(vo.process_frame(imgs[5], deps[5], 5), np.eye(4))
    pose6 = vo.process_frame(imgs[6], deps[6], 6)
    jvo.reset()
    jvo.process_frame(imgs[5], deps[5], 5)
    _assert_frames_agree(jvo.process_frame(imgs[6], deps[6], 6)[None], None, pose6[None],
                         None)
