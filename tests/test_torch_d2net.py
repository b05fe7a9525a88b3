"""D2-Net (mihaidusmanu/d2-net, Dusmanu et al., CVPR 2019) on the port's extraction
path (``vo_tpu_torch/models/d2net.py``), and the pieces of the benchmark's cell
``d2net_ms.extract``: the configuration's layer list, the port against the benchmark's
plain reference (``benchmark/vobench/ref_d2net.py``), the detection, banned mask,
budget, localization and corner rule on hand-made maps, the spans and counters, the
driver's judge, its readers, the checkpoint reader and the CLI.

Tolerances of the port against the reference, at 2 frames of 64 x 96 with seeded
weights: the kept keypoints, their cells (level, channel, row, column) equal; image
positions within 2e-3 px, descriptors within 1e-5, scores within 1e-5 of the
reference's. The port runs the trunk on the batch and the reference frame by frame,
and the CPU's convolution sums in another order for another batch: the maps differ by
a few fp32 ulps (4.6e-4 on values near 130), which move a refined position by up to
~2e-4 px (a Newton step divides by second differences), a unit descriptor by ~1e-6 and
a score by ~1e-6 of itself. Every stage after the trunk repeats the reference's
operations in its order. A bf16 trunk (8 bits of mantissa against 24) moves the maps
by ~1e-2 of themselves and misses them.
"""

import copy
import functools
import importlib.util
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from vo_tpu_torch import prng
from vo_tpu_torch.models import d2net, patchnet
from vo_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
sys.path[:0] = [BENCH]

from vobench import (d2net_counts, d2net_extract, harness, ref_d2net,  # noqa: E402
                     render)

TOL = {"kp_px": 2e-3, "desc": 1e-5, "score_rel": 1e-5}
SEED = 2 ** 31 + 9


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def upstream_sequential() -> nn.Sequential:
    """``DenseFeatureExtractionModule.model`` as ``lib/model_test.py`` writes it."""
    return nn.Sequential(
        nn.Conv2d(3, 64, 3, padding=1), nn.ReLU(inplace=True),
        nn.Conv2d(64, 64, 3, padding=1), nn.ReLU(inplace=True),
        nn.MaxPool2d(2, stride=2),
        nn.Conv2d(64, 128, 3, padding=1), nn.ReLU(inplace=True),
        nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(inplace=True),
        nn.MaxPool2d(2, stride=2),
        nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(inplace=True),
        nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(inplace=True),
        nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(inplace=True),
        nn.AvgPool2d(2, stride=1),
        nn.Conv2d(256, 512, 3, padding=2, dilation=2), nn.ReLU(inplace=True),
        nn.Conv2d(512, 512, 3, padding=2, dilation=2), nn.ReLU(inplace=True),
        nn.Conv2d(512, 512, 3, padding=2, dilation=2),
    )


def _config() -> dict:
    return harness.load_json(BENCH, "configs", "d2net_ms_kitti.json")


def test_layer_list_follows_model_test():
    seq = list(upstream_sequential())
    want = []
    for n, m in enumerate(seq):
        if isinstance(m, nn.Conv2d):
            relu = n + 1 < len(seq) and isinstance(seq[n + 1], nn.ReLU)
            want.append({"op": "conv", "in": m.in_channels, "out": m.out_channels,
                         "k": m.kernel_size[0], "dilation": m.dilation[0],
                         "padding": m.padding[0], "relu": relu})
        elif isinstance(m, (nn.MaxPool2d, nn.AvgPool2d)):
            k = m.kernel_size if isinstance(m.kernel_size, int) else m.kernel_size[0]
            s = m.stride if isinstance(m.stride, int) else m.stride[0]
            want.append({"op": "max_pool" if isinstance(m, nn.MaxPool2d) else "avg_pool",
                         "k": k, "stride": s})
    cfg = _config()
    assert cfg["d2net"]["layers"] == want
    assert d2net_extract.layer_dicts(d2net.D2NET_VGG16_CONV4_3) == want
    assert cfg["d2net"]["use_relu"] and cfg["multiscale"]["scales"] == [0.5, 1.0, 2.0]
    assert d2net_extract.program(cfg).level_k == tuple(cfg["multiscale"]["level_k"])


def test_operations_per_image():
    cfg = _config()
    assert d2net_counts.flops_per_image(cfg) / 1e9 == pytest.approx(2681.4047, abs=1e-4)
    levels = d2net_counts.level_sizes(376, 1232, cfg["multiscale"]["scales"])
    assert levels == [(0.5, 188, 616), (1.0, 376, 1232), (2.0, 752, 2464)]
    last = [d2net_counts.trunk_convs(cfg["d2net"]["layers"], h, w)[-1] for _, h, w in levels]
    assert [(a["h"], a["w"]) for a in last] == [(46, 153), (93, 307), (187, 615)]
    x = torch.zeros(1, 3, 64, 96)
    params = ref_d2net.draw_weights(cfg["d2net"], 3, torch.device("cpu"))
    assert d2net.apply_d2net(params, x).shape == (1, 512, 15, 23)


def _small(frames: int = 2, H: int = 64, W: int = 96):
    """The configuration at H x W, its weights and rendered frames."""
    cfg = copy.deepcopy(_config())
    f = 721.53 * W / 1232
    cfg["image_hw"] = [H, W]
    cfg["K"] = [[f, 0.0, (W - 1) / 2], [0.0, f, (H - 1) / 2], [0.0, 0.0, 1.0]]
    traffic = dict(harness.load_json(BENCH, "traffic", "d2net_extract.json"), frames=frames)
    gray = render.render_drive(traffic, cfg, SEED, torch.device("cpu"))["gray"]
    rgb = np.ascontiguousarray(np.repeat(gray[..., None], 3, axis=-1))
    params = ref_d2net.draw_weights(cfg["d2net"], SEED, torch.device("cpu"))
    return cfg, params, rgb


def _compare(got: d2net.D2NetFeatures, want: list) -> dict:
    """Cells kept by only one side, and the largest gaps over the common ones."""
    out = {"off": 0, "kept": 0, "kp_px": 0.0, "desc": 0.0, "score_rel": 0.0}
    host = {k: getattr(got, k) for k in d2net_extract._FIELDS}
    for mine, theirs in zip(d2net_extract._as_frames(host), want):
        a = {tuple(c): r for r, c in enumerate(mine["cell"].tolist())}
        b = {tuple(c): r for r, c in enumerate(theirs["cell"].tolist())}
        common = sorted(a.keys() & b.keys())
        out["off"] += len(a.keys() ^ b.keys())
        out["kept"] += len(common)
        ia, ib = torch.tensor([a[k] for k in common]), torch.tensor([b[k] for k in common])
        out["kp_px"] = max(out["kp_px"], float((mine["kp"][ia] - theirs["kp"][ib]).abs().max()))
        out["desc"] = max(out["desc"], float((mine["desc"][ia] - theirs["desc"][ib]).abs().max()))
        rel = (mine["score"][ia] - theirs["score"][ib]).abs() / theirs["score"][ib]
        out["score_rel"] = max(out["score_rel"], float(rel.max()))
    return out


@pytest.fixture(scope="module")
def small_run():
    n = torch.get_num_threads()
    torch.set_num_threads(1)          # set up before the per-test fixture
    try:
        cfg, params, rgb = _small()
        dcfg = d2net_extract.program(cfg)
        stats = {}
        got = d2net.extract_d2net(params, rgb, dcfg, device="cpu", stats=stats)
        want = ref_d2net.extract(params, cfg, torch.from_numpy(rgb))
    finally:
        torch.set_num_threads(n)
    return cfg, params, rgb, dcfg, got, want, stats


def test_port_matches_the_reference(small_run):
    cfg, params, rgb, dcfg, got, want, stats = small_run
    gaps = _compare(got, want)
    assert gaps["off"] == 0 and gaps["kept"] > 80, gaps
    assert all(gaps[k] <= TOL[k] for k in TOL), gaps
    counts = d2net.read_counts(stats)
    assert counts["budget"] == [0, 0, 0]
    assert sum(counts["kept"]) == gaps["kept"] == int(got.valid.sum())
    for n in range(3):
        lost = sum(counts[c][n] for c in ("banned", "budget", "offset", "corner"))
        assert counts["found"][n] - lost == counts["kept"][n]
    assert counts["banned"][0] == 0 and sum(counts["banned"][1:]) > 0
    # The levels sit in blocks of their budgets, best first; the positions map back
    # through 4 p + 1.5 and the level's size ratio.
    K = sum(min(k, h * w) for k, (h, w) in zip(dcfg.level_k, [(7, 11), (15, 23), (31, 47)]))
    assert got.kp.shape == (2, K, 3) and got.desc.shape == (2, K, 512)
    v = got.valid
    level = got.cell[..., 0].long()
    scale = torch.tensor(dcfg.scales)[level.clamp(min=0)]
    assert torch.equal(got.kp[..., 2][v], (1 / scale)[v])
    for b in range(2):
        for n in range(3):
            s = got.score[b][v[b] & (level[b] == n)]
            assert bool(torch.all(s[:-1] >= s[1:]))
    assert torch.allclose(got.desc[v].norm(dim=-1), torch.ones(int(v.sum())), atol=1e-6)


def test_a_bf16_trunk_misses_the_tolerances(small_run, monkeypatch):
    """The same comparison one precision down fails: the tolerances see a bf16 trunk."""
    cfg, params, rgb, dcfg, _, want, _ = small_run
    monkeypatch.setattr(d2net, "apply_d2net",
                        functools.partial(d2net.apply_d2net, compute_dtype=torch.bfloat16))
    got = d2net.extract_d2net(params, rgb, dcfg, device="cpu")
    gaps = _compare(got, want)
    assert gaps["off"] > 0 or any(gaps[k] > 10 * TOL[k] for k in TOL), gaps


def _map(C: int, h: int, w: int, peaks: dict) -> torch.Tensor:
    """A (1, C, h, w) map, zero but for ``peaks`` {(c, i, j): value}."""
    x = torch.zeros(1, C, h, w)
    for (c, i, j), v in peaks.items():
        x[0, c, i, j] = v
    return x


def _cells(d: d2net.Detections) -> list:
    live = torch.isfinite(d.score[0])
    return [(int(c), int(i), int(j)) for c, i, j in
            zip(d.channel[0][live], d.i[0][live], d.j[0][live])]


def test_detection_needs_the_channel_maximum_and_a_spatial_maximum():
    x = _map(2, 9, 9, {(0, 2, 2): 5.0, (1, 2, 2): 6.0,      # channel 1 wins at (2, 2)
                       (0, 6, 6): 4.0, (0, 6, 5): 4.5})     # (6, 6) is not a 3x3 max
    x[0, 0, 6, 4] = 1.0                                     # so that (6, 5) is no ridge
    d = d2net.detect(x, None, 0, 81, 5.0)
    assert set(_cells(d)) == {(1, 2, 2), (0, 6, 5)}
    ref = ref_d2net.detect(x[0], 5.0)
    assert set(map(tuple, ref.nonzero().tolist())) == set(_cells(d))


def test_edge_test_drops_ridges():
    """A blob passes; a ridge along j (dii << djj ~ 0) fails tr^2 / det <= 36 / 5."""
    x = torch.zeros(1, 1, 11, 11)
    x[0, 0, 2, 2], x[0, 0, 1, 2], x[0, 0, 3, 2], x[0, 0, 2, 1], x[0, 0, 2, 3] = 4, 1, 1, 1, 1
    x[0, 0, 7, 3:10] = torch.tensor([2.0, 2.5, 3.0, 3.1, 3.0, 2.5, 2.0])   # a ridge
    d = d2net.detect(x, None, 0, 121, 5.0)
    assert _cells(d) == [(0, 2, 2)]
    ref = ref_d2net.detect(x[0], 5.0)
    assert ref.nonzero().tolist() == [[0, 2, 2]]
    assert int(d.counts[0]) == 1


def test_banned_mask_across_levels():
    """A pixel detected at a coarser level is dropped at the finer one (counted), and
    the mask handed on holds both levels' detections, nearest-upsampled."""
    coarse = _map(1, 4, 4, {(0, 1, 1): 3.0})
    d0 = d2net.detect(coarse, None, 0, 16, 5.0)
    assert _cells(d0) == [(0, 1, 1)]
    fine = torch.zeros(1, 1, 8, 8)
    feat, banned = d2net.fuse(fine, coarse, d0.banned)
    assert banned.shape == (1, 1, 8, 8)
    assert banned[0, 0].nonzero().tolist() == [[2, 2], [2, 3], [3, 2], [3, 3]]
    feat = feat + _map(1, 8, 8, {(0, 2, 3): 50.0, (0, 6, 6): 40.0})
    d1 = d2net.detect(feat, banned, 1, 64, 5.0)
    assert _cells(d1) == [(0, 6, 6)]
    assert d1.counts.tolist()[:2] == [2, 1]                   # found 2, banned 1
    assert d1.banned[0, 0, 2, 3] and d1.banned[0, 0, 6, 6] and d1.banned[0, 0, 2, 2]
    assert float(d1.score[0, 0]) == 40.0 / 2                  # the level index + 1


def test_corner_rule_and_offset_test():
    """A peak on the first row whose Newton step points out of the map fails the corner
    rule; one whose step reaches 0.5 fails the offset test; both are counted."""
    x = _map(1, 6, 8, {(0, 0, 2): 2.0, (0, 1, 2): -1.0})     # step toward row -1: out
    x[0, 0, 2:5, 4:7] = torch.tensor([[0.1, 1.9, 1.8],       # a step of -0.54 rows
                                      [0.0, 2.0, 1.2],
                                      [0.8, 0.8, 0.5]])
    d = d2net.detect(x, None, 0, 48, 5.0)
    cells = _cells(d)
    assert cells == [(0, 0, 2), (0, 3, 5)]
    assert d.counts.tolist() == [2, 0, 0, 1, 1, 0]           # offset 1, corner 1
    steps = ref_d2net.localize(x[0])
    for c, i, j in cells:
        n = cells.index((c, i, j))
        assert d.fi[0, n] == torch.tensor(float(i)) + steps[0, c, i, j]
        assert d.fj[0, n] == torch.tensor(float(j)) + steps[1, c, i, j]
        assert not bool(d.valid[0, n])


def test_budget_keeps_the_best_by_score_and_counts_the_rest():
    peaks = {(0, 1, 1): 3.0, (0, 1, 6): 5.0, (0, 6, 1): 4.0, (0, 6, 6): 1.0}
    x = _map(1, 8, 8, peaks)
    d = d2net.detect(x, None, 2, 2, 5.0)
    assert _cells(d) == [(0, 1, 6), (0, 6, 1)]
    assert torch.equal(d.score[0], torch.tensor([5.0, 4.0]) / 3)
    assert d.counts.tolist()[2] == 2 and int(d.peak) == 4


def test_detection_and_steps_match_the_reference_on_random_maps():
    g = torch.Generator().manual_seed(5)
    x = torch.relu(torch.randn(1, 16, 12, 14, generator=g))
    x = torch.nn.functional.avg_pool2d(x, 3, 1, 1) * 100    # smooth, with ties at 0
    d = d2net.detect(x, None, 0, 12 * 14, 5.0)
    want = ref_d2net.detect(x[0], 5.0).nonzero().tolist()
    assert sorted(_cells(d)) == sorted(map(tuple, want)) and len(want) > 5
    steps = ref_d2net.localize(x[0])
    live = torch.isfinite(d.score[0])
    c, i, j = d.channel[0][live], d.i[0][live], d.j[0][live]
    assert torch.equal(d.fi[0][live], i.float() + steps[0, c, i, j])
    assert torch.equal(d.fj[0][live], j.float() + steps[1, c, i, j])


def test_d2net_conv_spans_and_the_r2d2_ones():
    cfg, params, rgb = _small(frames=1, H=32, W=48)
    dcfg = d2net_extract.program(cfg)
    off = d2net.extract_d2net(params, rgb, dcfg, device="cpu")
    profiling.start()
    try:
        on = d2net.extract_d2net(params, rgb, dcfg, device="cpu")
        patchnet.apply_patchnet(patchnet.init_patchnet_params(
            prng.key(0), patchnet.QUAD_L2NET_CONFCFS),
            patchnet.QUAD_L2NET_CONFCFS, torch.zeros(1, 8, 8, 3))
    finally:
        spans = profiling.stop()
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    names = [s.name for s in spans]
    assert names.count("d2net.extract") == 1 and names.count("d2net.merge") == 1
    levels = [i for i, s in enumerate(spans) if s.name == "d2net.level"]
    assert [(spans[i].attrs["scale"], spans[i].attrs["h"], spans[i].attrs["w"])
            for i in levels] == [(0.5, 16, 24), (1.0, 32, 48), (2.0, 64, 96)]
    layers = cfg["d2net"]["layers"]
    for i in levels:
        kids = [s.name for s in spans if s.parent == i]
        assert kids == ["d2net.network", "d2net.fuse", "d2net.detect", "d2net.describe"]
        net = next(n for n, s in enumerate(spans) if s.parent == i)
        convs = [s.attrs for s in spans if s.name == "d2net.conv" and s.parent == net]
        _, h, w = spans[i].attrs.values()
        want = [dict(a, layer=n) for n, a in enumerate(d2net_counts.trunk_convs(layers, h, w))]
        assert convs == [dict(a, rows=1) for a in want]
    r2d2 = [s for s in spans if s.name == "r2d2.conv"]
    assert len(r2d2) == 9 and r2d2[0].attrs == {"layer": 0, "k": 3, "dilation": 1, "cin": 3,
                                                "cout": 32, "rows": 1, "h": 8, "w": 8}
    assert names.count("d2net.conv") == 30


def test_conv_bias_is_the_r2d2_step():
    """``apply_patchnet``'s convolution step through the shared helper, bit for bit."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 9, 11, generator=g)
    w, b = torch.randn(7, 5, 2, 2, generator=g), torch.randn(7, generator=g)
    want = torch.nn.functional.conv2d(x, w, padding=2, dilation=4) + b[:, None, None]
    got = patchnet.conv_bias(x, w, b, 2, 4, torch.float32, "r2d2.conv", 0)
    assert torch.equal(got, want)


def test_counters_accumulate_over_calls(small_run):
    cfg, params, rgb, dcfg, got, _, stats = small_run
    assert d2net.read_counts({}) == {}
    twice = {}
    for _ in range(2):
        d2net.extract_d2net(params, rgb, dcfg, device="cpu", stats=twice)
    one, two = d2net.read_counts(stats), d2net.read_counts(twice)
    assert all(two[k] == [2 * v for v in one[k]] for k in d2net.COUNTERS)
    assert two["peak"] == one["peak"]


def test_checkpoint_reader(tmp_path):
    seq = upstream_sequential()
    state = {f"dense_feature_extraction.model.{k}": v for k, v in seq.state_dict().items()}
    torch.save({"model": state}, tmp_path / "d2_tf.pth")
    params = d2net.load_d2net_checkpoint(str(tmp_path / "d2_tf.pth"))
    convs = [m for m in seq if isinstance(m, nn.Conv2d)]
    assert len(params["convs"]) == len(convs) == 10
    for p, m in zip(params["convs"], convs):
        assert torch.equal(p["w"], m.weight.detach()) and torch.equal(p["b"], m.bias.detach())
    x = torch.randn(1, 3, 40, 48)
    with torch.no_grad():
        want = torch.relu(seq(x))
    assert torch.allclose(d2net.apply_d2net(params, x), want, rtol=1e-5, atol=1e-4)
    with pytest.raises(FileNotFoundError):
        d2net.load_d2net_checkpoint(str(tmp_path / "missing.pth"))
    torch.save({"model": dict(state, extra=torch.zeros(1))}, tmp_path / "bad.pth")
    with pytest.raises(ValueError):
        d2net.load_d2net_checkpoint(str(tmp_path / "bad.pth"))


def test_extract_cli_writes_d2net_files(tmp_path, monkeypatch):
    from PIL import Image

    from vo_tpu_torch.io.dataset import _read_png_rgb
    from vo_tpu_torch.models import port_weights
    from vo_tpu_torch.runners import extract

    seq = upstream_sequential()
    state = {f"module.dense_feature_extraction.model.{k}": v
             for k, v in seq.state_dict().items()}
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save({"model": state}, weights / "d2_tf.pth")
    monkeypatch.setattr(port_weights, "MODELS_DIR", str(weights))
    rng = np.random.default_rng(3)
    paths = []
    for i in range(2):
        p = tmp_path / f"im{i}.png"
        Image.fromarray(rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    kroot = str(tmp_path / "kapture")
    assert extract.main(["--model", "d2_tf", "--multiscale", "--images", *paths, "--device",
                         "cpu", "--kapture-root", kroot]) == 0
    params = d2net.load_d2net_checkpoint(str(weights / "d2_tf.pth"))
    imgs = np.stack([_read_png_rgb(p) for p in paths])
    feats = d2net.extract_d2net(params, imgs, d2net.D2NetConfig(), device="cpu")
    for i, p in enumerate(paths):
        with np.load(p + ".d2-net") as f:
            assert sorted(f.files) == ["descriptors", "keypoints", "scores"]
            v = feats.valid[i]
            assert f["keypoints"].shape == (int(v.sum()), 3) and f["descriptors"].shape[1] == 512
            cell = feats.cell[i][v].numpy()
            order = np.lexsort(cell.T[::-1])
            np.testing.assert_array_equal(f["keypoints"], feats.kp[i][v].numpy()[order])
            np.testing.assert_array_equal(f["scores"], feats.score[i][v].numpy()[order])
            assert set(np.unique(f["keypoints"][:, 2])) <= {0.5, 1.0, 2.0}
        kp, desc = extract.load_kapture_features(kroot, "d2-net", os.path.basename(p))
        assert kp.shape == (int(feats.valid[i].sum()), 3) and desc.shape[1] == 512
    assert extract.main(["--model", "d2_tf", "--images", paths[0], "--device", "cpu",
                         "--tag", "single"]) == 0
    with np.load(paths[0] + ".single") as f:
        assert set(np.unique(f["keypoints"][:, 2])) == {1.0}


def _cell(frames: int = 4) -> dict:
    w = copy.deepcopy(harness.workload("d2net_ms.extract"))
    cfg, tr = w["config"], w["traffic"]
    H, W = 32, 48
    f = 721.53 * W / 1232
    cfg["image_hw"] = [H, W]
    cfg["K"] = [[f, 0.0, (W - 1) / 2], [0.0, f, (H - 1) / 2], [0.0, 0.0, 1.0]]
    tr.update(frames=frames, batch=2, sample_range=2)
    return w


def _run(w: dict, seed: int = 2 ** 31 + 21):
    ctx = SimpleNamespace(config=w["config"], traffic=w["traffic"],
                          device=torch.device("cpu"), seed=seed, seconds=0.2, trace=False,
                          t0=time.perf_counter())
    return d2net_extract.run(ctx)


def test_driver_is_correct_on_a_small_cell():
    w = _cell()
    assert [m["name"] for m in w["end_to_end"]] == ["frames_per_s.extract", "setup_s"]
    run = _run(w)
    line = harness.result_line(w, run, False, "cpu", "cpu")
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"frames_per_s.extract", "setup_s"}
    assert set(line["checks"]) == {"keypoints_off", "kp_gap_px", "desc_gap", "score_gap"}
    assert run.stats == {} and run.frames == run.attempted > 0
    assert run.info["counters"]["budget"] == [0, 0, 0]


def test_driver_sees_a_descriptor_perturbed(monkeypatch):
    orig = d2net.extract_d2net

    def altered(*args, **kw):
        f = orig(*args, **kw)
        desc = f.desc.clone()
        n = int(f.valid[0].nonzero()[0])
        desc[0, n, 0] += 1e-3
        return f._replace(desc=desc)

    monkeypatch.setattr(d2net, "extract_d2net", altered)
    run = _run(_cell())
    assert "desc_gap" in {c.name for c in run.checks if not c.ok}


def test_driver_raises_without_the_program(monkeypatch):
    """The parent commit has no ``models.d2net``: the driver stops before any work."""
    monkeypatch.setitem(sys.modules, "vo_tpu_torch.models.d2net", None)
    with pytest.raises(ImportError):
        _run(_cell())


def test_weights_come_from_the_seed_alone():
    net = _config()["d2net"]
    a = ref_d2net.draw_weights(net, 2 ** 31 + 5, torch.device("cpu"))
    b = ref_d2net.draw_weights(net, 2 ** 31 + 5, torch.device("cpu"))
    c = ref_d2net.draw_weights(net, 6, torch.device("cpu"))
    assert torch.equal(a["convs"][7]["w"], b["convs"][7]["w"])
    assert not torch.equal(a["convs"][7]["w"], c["convs"][7]["w"])
    assert [p["w"].shape[:2] for p in a["convs"]][-1] == (512, 512)
    assert float(a["convs"][9]["w"].std()) == pytest.approx((2 / (9 * 512)) ** 0.5, rel=0.01)


def test_span_sums_over_device_spans():
    def rec(name, ms, **attrs):
        return profiling.SpanRecord(name, 1, 1, 0, 1, -1, attrs, ms)

    a = {"k": 3, "dilation": 2, "cin": 512, "cout": 512, "rows": 8, "h": 187, "w": 615}
    spans = [rec("d2net.conv", 30.0, layer=8, **a), rec("d2net.conv", None, layer=9, **a),
             rec("d2net.detect", 2.0), rec("d2net.fuse", 0.5), rec("d2net.describe", 1.0),
             rec("d2net.network", 99.0), rec("r2d2.conv", 7.0, layer=0, **a)]
    got = d2net_extract.span_sums(spans, 8)
    from vobench import conv_roofline

    assert got == {"d2net_conv_spans": 1, "d2net_conv_device_ms": 30.0,
                   "d2net_conv_bound_ms": pytest.approx(1e3 * conv_roofline.bound_s(a)),
                   "d2net_detect_device_ms": 3.5, "d2net_span_frames": 8}
    assert d2net_extract.span_sums(spans[-2:], 8) == {}


def _reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name, stats, want", [
    ("d2net_conv_roofline_pct", {"d2net_conv_device_ms": 80.0, "d2net_conv_bound_ms": 30.0},
     37.5),
    ("d2net_conv_roofline_pct", {"conv_device_ms": 80.0, "conv_bound_ms": 30.0}, None),
    ("d2net_detect_ms_per_frame", {"d2net_detect_device_ms": 96.0, "d2net_span_frames": 32},
     3.0),
    ("d2net_detect_ms_per_frame", {"d2net_detect_device_ms": 96.0, "d2net_span_frames": 0},
     None),
])
def test_span_readers(name, stats, want):
    """The new readers on a run's stats; a program without the spans leaves them empty
    (an empty ``Run``, as the parent commit's)."""
    assert _reader(name)(SimpleNamespace(stats=stats)) == want
    empty = harness.Run(frames=8, window_s=1.0, setup_s=1.0, memory_peak_bytes=0,
                        checks=[], attempted=8)
    assert _reader(name)(empty) is None


def test_mfu_reader():
    cfg = _config()
    trace = SimpleNamespace(frames=32, window_s=2.0)
    run = SimpleNamespace(trace=trace, config=cfg)
    want = 100 * 2681.404674048e9 * 32 / 2.0 / 67e12
    assert _reader("d2net_extract_mfu_pct")(run) == pytest.approx(want)
    assert _reader("d2net_extract_mfu_pct")(SimpleNamespace(trace=trace, config={})) is None
    assert _reader("d2net_extract_mfu_pct")(SimpleNamespace(trace=None, config=cfg)) is None


def test_input_resize_follows_extract_features():
    """``extract_features.py``'s limits: a no-op at KITTI size; the longer side to
    ``max_edge``, then both sides to ``max_sum_edges``, truncating; positions scaled
    back to the frame."""
    cfg = d2net.D2NetConfig()
    assert d2net.input_size(376, 1232, cfg) == (376, 1232)
    assert d2net.input_size(1200, 2000, cfg) == (960, 1600)
    assert d2net.input_size(1500, 1600, cfg) == (1354, 1445)
    _, params, rgb = _small(frames=1, H=48, W=64)
    small = d2net.D2NetConfig(scales=(1.0,), max_edge=40)
    assert d2net.input_size(48, 64, small) == (30, 40)
    f = d2net.extract_d2net(params, rgb, small, device="cpu")
    v = f.valid[0]
    assert int(v.sum()) > 0 and f.cell.shape[1] == 6 * 9
    x = f.kp[0, v, 0]
    j = f.cell[0, v, 3].to(torch.float32)
    assert bool(torch.all((x / 1.6 - (4 * j + 1.5)).abs() < 2.0 + 1e-4))
