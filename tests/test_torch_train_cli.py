"""The port's training CLIs against the JAX package's on the CPU, at --steps 2.

Both packages' ``main`` run on a narrow Fast network (monkeypatched in place of the
full-width one, as the CLIs take no width flag) and the same flags. ``train_r2d2``:
the same log fields, the first two steps' losses within 2e-4 (the log's 4 decimals;
both start from the seed's weights and draw the same synthetic batches), a checkpoint
that ``--resume`` continues from step 2. ``retrain_parity``: reports with the JAX
runner's keys, on two small evaluation images.
"""

import json
import re

import numpy as np
import pytest

from vo_tpu.models import patchnet as jpatchnet
from vo_tpu.runners import retrain_parity as jretrain
from vo_tpu.runners import train_r2d2 as jtrain
from vo_tpu_torch.models import patchnet
from vo_tpu_torch.runners import retrain_parity, train_r2d2

JSPEC = jpatchnet.PatchNetSpec("narrow", jpatchnet._fast_quad_specs(1, 32), out_dim=32,
                               upsample=2)
TSPEC = patchnet.PatchNetSpec("narrow", patchnet._fast_quad_specs(1, 32), out_dim=32,
                              upsample=2)
LOG = re.compile(r"\[train\] step (\d+) loss ([\d.]+) \(ema ([\d.]+)\) ap ([\d.]+) "
                 r"cosim ([\d.]+) peaky ([\d.]+) \| [\d.]+ img/s")


def test_train_r2d2_main(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(jtrain.ARCHS, "fast_quad", JSPEC)
    monkeypatch.setitem(train_r2d2.ARCHS, "fast_quad", TSPEC)
    flags = ["--steps", "2", "--batch", "2", "--hw", "32", "32", "--log-every", "1"]
    assert jtrain.main(flags + ["--save-path", str(tmp_path / "jax.ckpt")]) == 0
    jlog = [LOG.match(line) for line in capsys.readouterr().out.splitlines()]
    ckpt = str(tmp_path / "torch.ckpt")
    assert train_r2d2.main(flags + ["--save-path", ckpt, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    tlog = [LOG.match(line) for line in out.splitlines()]
    jlog, tlog = [m for m in jlog if m], [m for m in tlog if m]
    assert [m.group(1) for m in tlog] == [m.group(1) for m in jlog] == ["1", "2"]
    for jm, tm in zip(jlog, tlog):
        for g in range(2, 7):
            assert float(tm.group(g)) == pytest.approx(float(jm.group(g)), abs=2e-4)
    assert f"saved {ckpt} at step 2" in out

    assert train_r2d2.main(["--steps", "1", "--batch", "2", "--hw", "32", "32",
                            "--save-path", ckpt, "--resume", ckpt, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {ckpt} at step 2" in out and f"saved {ckpt} at step 3" in out


def test_retrain_parity_main_writes_the_jax_keys(tmp_path, monkeypatch):
    rng = np.random.default_rng(98)
    imgs = rng.uniform(0, 255, (2, 48, 64)).astype(np.float32)
    monkeypatch.setattr(jpatchnet, "FAST_QUAD_L2NET_CONFCFS", JSPEC)
    monkeypatch.setattr(patchnet, "FAST_QUAD_L2NET_CONFCFS", TSPEC)
    monkeypatch.setattr(jretrain, "load_eval_images", lambda data_dir: imgs)
    monkeypatch.setattr(retrain_parity, "load_eval_images", lambda data_dir: imgs)
    flags = ["--steps", "2", "--batch", "2", "--crop", "32", "--eval-every", "1",
             "--skip-ported"]
    assert jretrain.main(flags + ["--out", str(tmp_path / "jax.json")]) == 0
    assert retrain_parity.main(flags + ["--out", str(tmp_path / "torch.json"),
                                        "--device", "cpu"]) == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "torch.json").read_text())
    assert set(got) == set(want)
    assert [c["step"] for c in got["curve"]] == [c["step"] for c in want["curve"]] == [1, 2]
    assert all(set(c) == set(w) for c, w in zip(got["curve"], want["curve"]))
    assert got["device"] == "cpu" and got["eval_images"] == 2
    assert 0.0 <= got["mma3_init"] <= 1.0 and isinstance(got["match_support_ok"], bool)
    for k in ("steps", "batch", "crop", "lr", "sampler", "lr_schedule", "score_mode"):
        assert got[k] == want[k], k


def test_load_eval_images_tops_up_with_textures(tmp_path):
    from PIL import Image

    Image.fromarray(np.random.default_rng(99).uniform(0, 255, (300, 500)).astype(np.uint8)).save(
        tmp_path / "a.png")
    got = retrain_parity.load_eval_images(str(tmp_path), H=60, W=80, min_images=3)
    want = jretrain.load_eval_images(str(tmp_path), H=60, W=80, min_images=3)
    assert got.shape == want.shape == (3, 60, 80)
    assert np.array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1e-4 * 255)
    assert retrain_parity.load_eval_images(None, H=60, W=80, min_images=2).shape == (2, 60, 80)
