"""The port's dry run (``vo_tpu_torch/runners/dryrun.py``) against ``__graft_entry__.py``.

``entry`` on the CPU: the outputs of the JAX entry step's shapes, equal keypoints and
validity, descriptors and back-projected points within 1e-5. ``main`` over 2 spawned
gloo ranks (a (1, 2) mesh, as the JAX dry run builds it for 2 devices) passes its own
checks and writes its report.
"""

import json

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vo_tpu_torch.runners import dryrun


def test_entry_matches_the_jax_entry():
    jfn, jargs = graft.entry()
    want = [np.asarray(x) for x in jfn(*jargs)]
    fn, args = dryrun.entry(device="cpu")
    for a, j in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(j))
    got = [(x.float() if x.dtype == torch.bfloat16 else x).numpy() for x in fn(*args)]
    assert [g.shape for g in got] == [w.shape for w in want]
    kp, desc, valid, kp3d = got
    assert np.array_equal(kp, want[0]) and np.array_equal(valid, want[2])
    np.testing.assert_allclose(desc.astype(np.float32), want[1].astype(np.float32), atol=1e-5)
    np.testing.assert_allclose(kp3d, want[3], rtol=1e-5, atol=1e-5)


def test_dryrun_over_two_gloo_ranks(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert dryrun.main(["--nprocs", "2", "--backend", "gloo", "--device", "cpu",
                        "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert report["mesh"] == {"data": 1, "model": 2}
    assert report["inference"]["matches"] > 0
    assert report["train"]["all_reduces"]["gradients"][0] == 1
    for name in ("ba_small", "ba_window"):
        ba = report[name]
        assert ba["shards"] == 2 and ba["flops_per_rank"] < ba["flops_one"]
        assert ba["final_cost"] == pytest.approx(ba["final_cost_one"], rel=1e-4)
        assert ba["collectives_per_iteration"]["all_to_all U"][0] == 1
    assert (report["ba_window"]["P"], report["ba_window"]["L"]) == (64, 8192)


@pytest.mark.parametrize("argv", [["--backend", "nccl", "--device", "cpu"],
                                  ["--backend", "gloo", "--device", "cuda"]])
def test_dryrun_refuses_a_backend_on_the_wrong_device(argv):
    with pytest.raises(ValueError, match="runs on"):
        dryrun.main(["--nprocs", "1"] + argv)
