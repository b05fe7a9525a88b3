"""The port's benchmark (``vo_tpu_torch/runners/bench.py``) against the JAX package's
``bench.py``, on the CPU at a small size.

``main`` runs every workload on 4 slalom frames at 120 x 400 (K scaled from KITTI's)
in batches of 2, 256 keypoints, 64 PnP hypotheses, one timed pass and a loop drive of
8 frames, rendered in a pool of 2, with CUDA reported absent and one torch thread (the
engine's many small ops gain nothing from more on the CPU, and under a parallel test
run threads that share cores with other processes' wait on each other); the line it
prints has the keys of
``BENCH_r05.json``'s ``parsed`` (the JAX bench's line), nested keys included, with
the JAX types. At that size the values themselves say nothing of accuracy or speed.
The adversarial faults at 160 frames are bench.py's (a literal copy, exact), and the
port's trajectory score is ``bench._score`` (the evaluator's fp64 sums, within 1e-6).
"""

import json
import pathlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bench as jbench
from vo_tpu_torch.runners import bench
from vo_tpu_torch.utils.synthetic import slalom_trajectory

ROOT = pathlib.Path(__file__).resolve().parents[1]
R2D2_KEYS = ("r2d2_pipeline_fps", "r2d2_trajectory_sane", "r2d2_seg_trans_err_pct",
             "r2d2_seg_rot_err_deg_100m", "r2d2_accept_rate")


def small_bench(monkeypatch):
    sx, sy = 400 / 1232, 120 / 376
    K = np.array([[721.53 * sx, 0.0, 609.55 * sx], [0.0, 721.53 * sx, 172.85 * sy],
                  [0.0, 0.0, 1.0]], np.float32)
    for name, value in dict(H=120, W=400, K=K, EXTRACT_BATCH=2, STEREO_BATCH=2,
                            MAX_KP=256, N_HYPOTHESES=64, N_PASSES=1, LOOP_OUT_FRAMES=2,
                            LOOP_TURN_FRAMES=2, PROCESSES=2).items():
        monkeypatch.setattr(bench, name, value)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def test_main_on_cpu_prints_the_jax_line(monkeypatch, tmp_path, capsys, one_thread):
    small_bench(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "bench.json"
    assert bench.main(["--dir", str(tmp_path / "seq"), "--frames", "4", "--out", str(out),
                       "--device", "cpu"]) == 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(printed)
    assert json.loads(out.read_text()) == line
    ref = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]
    assert list(line) == list(ref)                       # the keys, in bench.py's order
    assert _keys(line) == _keys(ref) and len(_keys(ref)) == 65
    for k, v in line.items():
        if k in R2D2_KEYS:
            assert v is None, k                            # no checkpoint in the repo
        else:
            assert type(v) is type(ref[k]), (k, v)
    assert line["refine_wall_breakdown_s"].keys() == ref["refine_wall_breakdown_s"].keys()
    assert line["pallas_parity"] is True and line["io_loader"] == "native"
    assert line["device"] == "cpu" and line["refine_frames"] == 8
    assert line["unit"] == "frames/s (120x400 rgbd, 256 kp, full pipeline)"
    assert line["io_wire_bytes_per_frame"] == 120 * 400 + 2 * 256 * 2 + 2 * 256 + 84
    assert line["accept_rate"] == 1.0 and line["trajectory_sane"] is True
    cached = {p.name for p in (tmp_path / "seq").iterdir()}
    assert cached == {"slalom_v3_4x120x400.npz", "slalom_v3_right_4x120x400.npz",
                      "loop_v2_2x2_120x400.npz", "slalom_v3_grayu16_4x120x400"}


def _jax_bench_faults(imgs, deps):
    """bench.py:453-463, copied literally."""
    aimgs = np.array(imgs)
    adeps = np.array(deps)
    rnga = np.random.default_rng(8214)
    aimgs[40:43] = 128.0 + 2.0 * rnga.standard_normal(
        aimgs[40:43].shape).astype(np.float32)
    drop = rnga.uniform(size=adeps[80:87].shape) < 0.85
    adeps[80:87] = np.where(drop, 0.0, adeps[80:87])
    for t, fno in enumerate(range(110, 126)):
        x0 = 40 + 70 * t
        aimgs[fno, 60:316, x0:x0 + 360] = 90.0
        adeps[fno, 60:316, x0:x0 + 360] = 2.0
    return aimgs, adeps


def test_adversarial_faults_are_bench_pys():
    """At 160 frames (72 rows: the faults' rows 60-71; 1,456 columns: every occluder
    whole) equal to bench.py's bit for bit; at 120 frames the occluder stops at frame
    119 and the earlier faults are the same."""
    rng = np.random.default_rng(3)
    imgs = rng.uniform(0, 255, (160, 72, 1456)).astype(np.float32)
    deps = rng.uniform(1, 40, (160, 72, 1456)).astype(np.float32)
    got, want = bench.adversarial_faults(imgs, deps), _jax_bench_faults(imgs, deps)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert not np.array_equal(got[0][125], imgs[125]) and np.array_equal(got[0][126], imgs[126])
    short = bench.adversarial_faults(imgs[:120], deps[:120])
    for g, w in zip(short, want):
        assert g.shape[0] == 120 and np.array_equal(g, w[:120])


@pytest.mark.parametrize("accept_rate", [1.0, 0.95, 0.75])
def test_score_is_bench_pys(accept_rate):
    gt = slalom_trajectory(160, step=0.8)
    rng = np.random.default_rng(4)
    poses = gt.copy()
    poses[:, :3, 3] += np.cumsum(rng.normal(0, 0.01, (160, 3)), axis=0)
    poses = poses.astype(np.float32)
    accepted = rng.uniform(size=159) < accept_rate
    diag = SimpleNamespace(accepted=accepted)
    (jres, jacc, jdrift, jsane), (res, acc, drift, sane) = (
        jbench._score(gt, poses, diag), bench._score(gt, poses, diag))
    assert sane == jsane and acc == jacc
    np.testing.assert_allclose([res.seg_trans_err_pct, res.seg_rot_err_deg_per_100m, drift],
                               [jres.seg_trans_err_pct, jres.seg_rot_err_deg_per_100m,
                                jdrift], rtol=1e-6)
    assert res.seg_trans_err_pct > 0.05
