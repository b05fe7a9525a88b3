"""Port parity: the long-run runner (``runners/longrun.py``) on the CPU: the rendered
sequence directory is byte for byte the JAX runner's, and ``main`` on 3 frames writes
a report with every key of the JAX runner's report (and the port's
``refined_finite``)."""

import json
import os

import numpy as np

from vo_tpu.runners import longrun as jlongrun
from vo_tpu_torch.runners import longrun


def test_render_sequence_dir_bytes(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jlongrun.render_sequence_dir(str(jdir), 2)
    longrun.render_sequence_dir(str(tdir), 2, processes=1)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert names == [".complete", "000000.png", "000000_depth.npy", "000001.png",
                     "000001_depth.npy", "gt.npy"]
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name


def test_main_on_cpu_writes_the_jax_report_keys(tmp_path):
    d, out = tmp_path / "seq", tmp_path / "report.json"
    assert longrun.main(["--dir", str(d), "--frames", "3"], device="cpu") == 1  # missing
    longrun.render_sequence_dir(str(d), 3, processes=2)
    rc = longrun.main(["--dir", str(d), "--frames", "3", "--batch", "1", "--out",
                       str(out)], device="cpu")
    assert rc == 0
    report = json.loads(out.read_text())
    jax_keys = {"frames", "resolution", "distance_m", "fps_io_included", "stream_wall_s",
                "seg_trans_err_pct", "seg_rot_err_deg_100m", "final_drift_m",
                "accept_rate", "checkpoint_written", "retained_feature_frames",
                "retained_fraction", "refine_windows", "refine_ran_ba",
                "refine_loop_edges", "refine_wall_s", "refine_seg_trans_err_pct",
                "peak_host_rss_mb", "reference_full_run", "device"}
    src = open(jlongrun.__file__).read()
    assert all(f'"{k}"' in src for k in jax_keys)      # the JAX runner's own keys
    assert set(report) == jax_keys | {"refined_finite"}
    assert report["frames"] == 3 and report["resolution"] == [376, 1232]
    assert report["accept_rate"] == 1.0 and report["checkpoint_written"]
    assert report["refined_finite"]
    assert report["device"] == "cpu" and report["final_drift_m"] < 0.05
    assert np.isfinite([report[k] for k in ("seg_trans_err_pct", "fps_io_included",
                                            "peak_host_rss_mb")]).all()
