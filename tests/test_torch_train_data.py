"""The port's training datasets and random-window loader against the JAX package's.

The host side is numpy and PIL in both packages: the same seed and sources give the
JAX loader's crops bit for bit (still pairs, stored-flow pairs and the catalogs; the
synthetic-homography source warps with each package's own ``warp_pair``, so its crops
are held within 1e-4 of their scale). The real-image producer re-raises a loader
crash in the consumer (``tests/test_train.py``'s contract).
"""

from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from vo_tpu.runners import train_r2d2 as jrunner
from vo_tpu.train import datasets as jds
from vo_tpu.train.trainer import TrainConfig as JTrainConfig
from vo_tpu_torch.runners import train_r2d2
from vo_tpu_torch.train import datasets as tds
from vo_tpu_torch.train.trainer import TrainConfig


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Images, a stored-flow pair list, a style-transfer folder and a flow directory."""
    root = tmp_path_factory.mktemp("train_data")
    (root / "empty").mkdir()
    rng = np.random.default_rng(95)
    (root / "imgs" / "db").mkdir(parents=True)
    (root / "imgs" / "night").mkdir()
    for i in range(3):
        img = rng.uniform(0, 255, (120, 150)).astype(np.uint8)
        Image.fromarray(img).save(root / "imgs" / "db" / f"{100 + i}.png")
    Image.fromarray(rng.uniform(0, 255, (90, 100)).astype(np.uint8)).save(
        root / "imgs" / "night" / "n.jpg")
    st = root / "style"
    st.mkdir()
    Image.fromarray(rng.uniform(0, 255, (100, 140)).astype(np.uint8)).save(st / "100.png.st_a.png")
    fl = root / "optical_flow"
    (fl / "flow").mkdir(parents=True)
    (fl / "mask").mkdir()
    rel = np.zeros((120, 150, 2), np.float32)
    rel[..., 0] = 3.5
    rel[..., 1] = -2.0
    jds.flow_to_png(rel, str(fl / "flow" / "100_101.png"))
    Image.fromarray((rng.uniform(size=(120, 150)) > 0.2).astype(np.uint8) * 255).save(
        fl / "mask" / "100_101.png")
    fp = root / "flowpairs"
    fp.mkdir()
    Image.fromarray(rng.uniform(0, 255, (80, 96)).astype(np.uint8)).save(fp / "a.png")
    Image.fromarray(rng.uniform(0, 255, (80, 96)).astype(np.uint8)).save(fp / "b.png")
    gy, gx = np.mgrid[0:80, 0:96].astype(np.float32)
    np.save(fp / "ab.npy", np.stack([gx * 1.05 + 2, gy * 0.97 - 1], -1))
    (fp / "pairs.txt").write_text("a.png b.png ab.npy\n")
    return root


def test_flow_png_codec(tmp_path):
    rng = np.random.default_rng(96)
    flow = rng.uniform(-300, 300, (20, 30, 2)).astype(np.float32)
    qj = jds.flow_to_png(flow, str(tmp_path / "j.png"))
    qt = tds.flow_to_png(flow, str(tmp_path / "t.png"))
    assert np.array_equal(qj, qt)
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "t.png").read_bytes()
    assert np.array_equal(tds.png_to_flow(str(tmp_path / "j.png")),
                          jds.png_to_flow(str(tmp_path / "j.png")))


def test_image_folder_and_catalogs(tree):
    for sel in ("", "db"):
        jf, tf = jds.ImageFolder(str(tree / "imgs"), sel), tds.ImageFolder(str(tree / "imgs"), sel)
        assert jf.paths == tf.paths
        assert np.array_equal(jf.load_gray(0, 64), tf.load_gray(0, 64))
    jf, tf = jds.ImageFolder(str(tree / "imgs"), "db"), tds.ImageFolder(str(tree / "imgs"), "db")
    sources = [(jds.StillPairs(jf), tds.StillPairs(tf)),
               (jds.StyleTransferPairs(jf, str(tree / "style")),
                tds.StyleTransferPairs(tf, str(tree / "style"))),
               (jds.FlowDirPairs(jf, str(tree / "optical_flow")),
                tds.FlowDirPairs(tf, str(tree / "optical_flow"))),
               (jds.FlowPairs(str(tree / "flowpairs")), tds.FlowPairs(str(tree / "flowpairs")))]
    for js, ts in sources:
        assert len(js) == len(ts)
        for a, b in zip(js.get_pair(0), ts.get_pair(0)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="no images"):
        tds.ImageFolder(str(tree / "empty"))


def test_synthetic_homography_pairs(tree):
    jf, tf = jds.ImageFolder(str(tree / "imgs"), "db"), tds.ImageFolder(str(tree / "imgs"), "db")
    js, ts = jds.SyntheticHomographyPairs(jf, 96), tds.SyntheticHomographyPairs(tf, 96)
    for i in range(2):
        (i1j, i2j, fj, mj), (i1t, i2t, ft, mt) = js.get_pair(i), ts.get_pair(i)
        assert np.array_equal(i1j, i1t) and mt.dtype == np.bool_ and i2t.dtype == np.float32
        np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4 * np.abs(fj).max())
        assert (mt != mj).mean() < 0.01
        assert np.abs(i2t - i2j).mean() < 0.5


def test_tilt_and_loader_crops_bit_for_bit(tree):
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    img = np.random.default_rng(97).uniform(0, 255, (60, 70)).astype(np.float32)
    gy, gx = np.mgrid[0:60, 0:70]
    aflow = np.stack([gx, gy], -1).astype(np.float32)
    mask = np.ones((60, 70), bool)
    for a, b in zip(jds.tilt_second_image(rng_j, img, aflow, mask),
                    tds.tilt_second_image(rng_t, img, aflow, mask)):
        assert np.array_equal(a, b)

    jf, tf = jds.ImageFolder(str(tree / "imgs"), "db"), tds.ImageFolder(str(tree / "imgs"), "db")
    jsrc = jds.CatPairs(jds.StillPairs(jf), jds.FlowPairs(str(tree / "flowpairs")),
                        jds.FlowDirPairs(jf, str(tree / "optical_flow")))
    tsrc = tds.CatPairs(tds.StillPairs(tf), tds.FlowPairs(str(tree / "flowpairs")),
                        tds.FlowDirPairs(tf, str(tree / "optical_flow")))
    for crop in (48, 64):
        jl = jds.RandomWindowPairLoader(jsrc, jds.WindowLoaderConfig(crop=crop, seed=11))
        tl = tds.RandomWindowPairLoader(tsrc, tds.WindowLoaderConfig(crop=crop, seed=11))
        for _ in range(2):
            for a, b in zip(jl.batch(3), tl.batch(3)):
                assert a.shape[:3] == (3, crop, crop) and a.dtype == b.dtype
                assert np.array_equal(a, b)


def test_real_image_batches_with_catalog_flags(tree):
    args = SimpleNamespace(data_dir=str(tree / "imgs"), flow_pairs=str(tree / "flowpairs"),
                           style_pairs=str(tree / "style"), flow_dir=str(tree / "optical_flow"),
                           select="db")
    cfg = TrainConfig(batch=2, height=48, width=48)
    got = list(train_r2d2.real_image_batches(args, cfg, steps=2, prefetch=1))
    want = list(jrunner.real_image_batches(args, JTrainConfig(batch=2, height=48, width=48),
                                           steps=2, prefetch=1))
    assert len(got) == len(want) == 2
    img1, img2, aflow, mask = got[0]
    assert img1.shape == (2, 48, 48) and aflow.shape == (2, 48, 48, 2) and mask.any()
    for gb, wb in zip(got, want):      # the synthetic warps differ within rounding
        assert all(g.shape == w.shape and g.dtype == w.dtype for g, w in zip(gb, wb))


def test_dead_producer_raises_in_the_consumer(tree, monkeypatch):
    calls = {"n": 0}
    orig = tds.RandomWindowPairLoader.batch

    def dying_batch(self, b):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise OSError("disk vanished")
        return orig(self, b)

    monkeypatch.setattr(tds.RandomWindowPairLoader, "batch", dying_batch)
    args = SimpleNamespace(data_dir=str(tree / "imgs"), flow_pairs=None)
    cfg = TrainConfig(batch=2, height=48, width=48)
    with pytest.raises(RuntimeError, match="loader died") as ei:
        for _ in train_r2d2.real_image_batches(args, cfg, steps=10, prefetch=2):
            pass
    assert isinstance(ei.value.__cause__, OSError)
    assert calls["n"] == 3
