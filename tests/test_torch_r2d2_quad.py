"""The upstream's default R2D2 network, ``Quad_L2Net_ConfCFS`` (naver/r2d2
``r2d2_WASF_N16``), on the port's multiscale path, and the pieces of the benchmark's
cell ``r2d2_quad.extract``: the configuration's layer list, the port against the
benchmark's plain reference (``benchmark/vobench/ref_r2d2.py``), the operation count,
the ``r2d2.conv`` spans, the span-recording driver and its readers. Checks that hold
for both published networks are parametrised over them.

Tolerances of the port against the reference: keypoints, their order and masks equal;
descriptor and score gaps <= 1e-5. The two run the same operations in the same order on
the CPU, so the gap is fp32 rounding at most; 1e-5 is the noise an fp32 trunk of nine
convolutions (sums of up to 1,152 products) may leave on unit-norm descriptors and on
scores in [0, 1], and a bf16 trunk misses it by three orders of magnitude.
"""

import copy
import importlib.util
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vo_tpu_torch.models import multiscale, patchnet
from vo_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
sys.path[:0] = [BENCH]

from vobench import (conv_roofline, counts, harness, r2d2_extract_spans,  # noqa: E402
                     ref_r2d2, render)

CONFIGS = {"fast": "r2d2_fast_kitti", "quad": "r2d2_quad_kitti"}
SPECS = {"fast": patchnet.FAST_QUAD_L2NET_CONFCFS, "quad": patchnet.QUAD_L2NET_CONFCFS}
TOL = 1e-5


def upstream_quad_layers(mchan: int = 4, dim: int = 128) -> list[dict]:
    """naver/r2d2 ``nets/patchnet.py``: ``Quad_L2Net(dim, mchan, relu22=False)`` as
    ``PatchNet._add_conv`` builds it with ``dilated=True``: a layer runs at the running
    dilation with stride 1, and a stride-2 layer doubles the running dilation of the
    layers after it; padding ((k - 1) d) // 2 keeps the size, so nothing pools."""
    m = mchan
    calls = [  # (out channels, k, stride, bn, relu): Quad_L2Net.__init__'s calls
        (8 * m, 3, 1, True, True), (8 * m, 3, 1, True, True), (16 * m, 3, 2, True, True),
        (16 * m, 3, 1, True, True), (32 * m, 3, 2, True, True), (32 * m, 3, 1, True, True),
        (32 * m, 2, 2, True, False), (32 * m, 2, 2, True, False), (dim, 2, 2, False, False)]
    layers, cur, dilation = [], 3, 1
    for out, k, stride, bn, relu in calls:
        layers.append({"in": cur, "out": out, "k": k, "dilation": dilation, "bn": bn,
                       "relu": relu, "pool_after": 1})
        cur, dilation = out, dilation * stride
    return layers


def _config(net: str) -> dict:
    return harness.load_json(BENCH, "configs", f"{CONFIGS[net]}.json")


def _spec_layers(spec) -> list[dict]:
    return [{"in": c.in_ch, "out": c.out_ch, "k": c.k, "dilation": c.dilation, "bn": c.bn,
             "relu": c.relu, "pool_after": c.pool_after} for c in spec.convs]


def test_layer_list_follows_the_upstream_rule():
    want = upstream_quad_layers()
    assert [l["dilation"] for l in want] == [1, 1, 1, 2, 2, 4, 4, 8, 16]
    net = _config("quad")["network"]
    assert net["layers"] == want
    assert (net["name"], net["out_dim"], net["upsample"]) == ("Quad_L2Net_ConfCFS", 128, 1)
    spec = patchnet.QUAD_L2NET_CONFCFS
    assert _spec_layers(spec) == want
    assert (spec.name, spec.out_dim, spec.upsample) == ("Quad_L2Net_ConfCFS", 128, 1)
    assert r2d2_extract_spans.program(_config("quad"))[0] is spec


def _small(net: str, H: int = 64, W: int = 192, frames: int = 2, seed: int = 2 ** 31 + 9):
    """The configuration at H x W with a 3-level pyramid (scales 1, 2^-0.25, 2^-0.5),
    its weights and rendered frames."""
    cfg = copy.deepcopy(_config(net))
    f = 721.53 * W / 1232
    cfg["image_hw"] = [H, W]
    cfg["K"] = [[f, 0.0, (W - 1) / 2], [0.0, f, (H - 1) / 2], [0.0, 0.0, 1.0]]
    cfg["multiscale"].update(min_size=2 * W // 3, max_size=W, top_k=300, per_scale_k=128)
    traffic = dict(harness.load_json(BENCH, "traffic", "extract_spans.json"), frames=frames)
    gray = render.render_drive(traffic, cfg, seed, torch.device("cpu"))["gray"]
    rgb = np.ascontiguousarray(np.repeat(gray[..., None], 3, axis=-1))
    params = ref_r2d2.draw_weights(cfg["network"], seed, torch.device("cpu"))
    return cfg, params, rgb


@pytest.mark.parametrize("net", ["fast", "quad"])
def test_port_matches_the_reference(net):
    cfg, params, rgb = _small(net)
    spec, mcfg = r2d2_extract_spans.program(cfg)
    assert len(multiscale.pyramid_scales(*rgb.shape[1:3], mcfg)) == 3
    got = multiscale.extract_multiscale(params, spec, rgb, mcfg, device="cpu")
    want = ref_r2d2.extract(params, cfg, torch.from_numpy(rgb))
    assert int(got.valid.sum()) > 100
    assert torch.equal(got.kp, want["kp"]) and torch.equal(got.valid, want["valid"])
    assert float((got.desc - want["desc"]).abs().max()) <= TOL
    assert float((got.score - want["score"]).abs().max()) <= TOL


@pytest.mark.parametrize("net", ["fast", "quad"])
def test_a_bf16_trunk_misses_the_tolerances(net):
    """The same comparison one precision down fails: the limits see a bf16 trunk."""
    cfg, params, rgb = _small(net, frames=1)
    images = ref_r2d2.normalize_images(torch.from_numpy(rgb))
    want = ref_r2d2.forward(params, cfg["network"], images)
    got = patchnet.apply_patchnet(params, SPECS[net], images, compute_dtype=torch.bfloat16)
    gaps = {k: float((got[k].to(torch.float32) - want[k]).abs().max()) for k in want}
    assert max(gaps.values()) > 100 * TOL, gaps
    fp32 = patchnet.apply_patchnet(params, SPECS[net], images)
    assert max(float((fp32[k] - want[k]).abs().max()) for k in want) <= TOL


@pytest.mark.parametrize("net, gflop, dilated_share", [("fast", 211.8978, 0.2299),
                                                        ("quad", 718.7401, 0.7115)])
def test_operations_per_image(net, gflop, dilated_share):
    cfg = _config(net)
    total = counts.r2d2_flops_per_image(cfg)
    assert total / 1e9 == pytest.approx(gflop, abs=1e-4)
    # The convolutions one image runs, as their spans would name them: the pyramid's
    # levels, each layer at the size it runs at.
    H, W = cfg["image_hw"]
    convs = []
    for _, nh, nw in counts.pyramid_levels(H, W, cfg["multiscale"]):
        for layer in cfg["network"]["layers"]:
            convs.append({"k": layer["k"], "dilation": layer["dilation"],
                          "cin": layer["in"], "cout": layer["out"], "rows": 1, "h": nh,
                          "w": nw})
            nh, nw = nh // layer["pool_after"], nw // layer["pool_after"]
    ops = [conv_roofline.ops_bytes(a)[0] for a in convs]
    heads = sum(2.0 * 128 * 3 * nh * nw
                for _, nh, nw in counts.pyramid_levels(H, W, cfg["multiscale"]))
    assert sum(ops) + heads == pytest.approx(total, rel=1e-12)
    dilated = sum(o for o, a in zip(ops, convs) if a["dilation"] >= conv_roofline.DILATED)
    assert dilated / total == pytest.approx(dilated_share, abs=1e-4)


def test_conv_roofline_by_hand():
    a = {"k": 2, "dilation": 16, "cin": 128, "cout": 128, "rows": 8, "h": 266, "w": 872}
    ops, nbytes = conv_roofline.ops_bytes(a)
    assert ops == 2 * 4 * 128 * 128 * 8 * 266 * 872
    assert nbytes == 4 * 8 * 266 * 872 * 256 + 4 * 4 * 128 * 128
    assert conv_roofline.bound_s(a) == pytest.approx(ops / 67e12)       # operations
    small = {"k": 3, "dilation": 1, "cin": 3, "cout": 32, "rows": 8, "h": 266, "w": 872}
    ops, nbytes = conv_roofline.ops_bytes(small)
    assert conv_roofline.bound_s(small) == pytest.approx(nbytes / 3.35e12)  # bytes


@pytest.mark.parametrize("net", ["fast", "quad"])
def test_one_conv_span_per_layer_and_level(net):
    cfg, params, rgb = _small(net, H=32, W=96, frames=2)
    spec, mcfg = r2d2_extract_spans.program(cfg)
    off = multiscale.extract_multiscale(params, spec, rgb, mcfg, device="cpu")
    assert not profiling.recording() and profiling.stop() == []
    profiling.start()
    try:
        assert profiling.recording()
        on = multiscale.extract_multiscale(params, spec, rgb, mcfg, device="cpu")
    finally:
        spans = profiling.stop()
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    nets = [i for i, s in enumerate(spans) if s.name == "r2d2.network"]
    levels = [spans[spans[i].parent].attrs for i in nets]
    assert len(levels) == len(multiscale.pyramid_scales(32, 96, mcfg)) == 3
    for i, level in zip(nets, levels):
        convs = [s for s in spans if s.name == "r2d2.conv" and s.parent == i]
        h, w = level["h"], level["w"]
        want = []
        for n, c in enumerate(spec.convs):
            want.append({"layer": n, "k": c.k, "dilation": c.dilation, "cin": c.in_ch,
                         "cout": c.out_ch, "rows": 2, "h": h, "w": w})
            h, w = h // c.pool_after, w // c.pool_after
        assert [s.attrs for s in convs] == want
        assert all(s.device_ms is None for s in convs)       # no CUDA events on the CPU
    assert sum(s.name == "r2d2.conv" for s in spans) == 9 * len(nets)
    assert conv_roofline.span_sums(spans, 2) == {}


def test_span_sums_over_device_spans():
    def rec(name, ms, **attrs):
        return profiling.SpanRecord(name, 1, 1, 0, 1, -1, attrs, ms)

    a = {"k": 3, "cin": 128, "cout": 128, "rows": 8, "h": 266, "w": 872}
    spans = [rec("r2d2.conv", 4.0, dilation=4, layer=5, **a),
             rec("r2d2.conv", 2.0, dilation=2, layer=4, **a),
             rec("r2d2.conv", None, dilation=8, layer=6, **a),
             rec("r2d2.network", 9.0)]
    got = conv_roofline.span_sums(spans, 8)
    bound = conv_roofline.bound_s(dict(a, dilation=4))
    assert got == {"conv_spans": 2, "conv_device_ms": 6.0,
                   "conv_bound_ms": pytest.approx(2e3 * bound),
                   "dilated_conv_device_ms": 4.0, "conv_frames": 8}


def _reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name, stats, want", [
    ("r2d2_conv_roofline_pct", {}, None),
    ("r2d2_conv_roofline_pct", {"conv_device_ms": 0.0, "conv_bound_ms": 0.0}, None),
    ("r2d2_conv_roofline_pct", {"conv_device_ms": 80.0, "conv_bound_ms": 30.0}, 37.5),
    ("r2d2_dilated_conv_ms_per_frame", {}, None),
    ("r2d2_dilated_conv_ms_per_frame", {"dilated_conv_device_ms": 5.0, "conv_frames": 0},
     None),
    ("r2d2_dilated_conv_ms_per_frame", {"dilated_conv_device_ms": 240.0, "conv_frames": 64},
     3.75),
])
def test_span_readers(name, stats, want):
    """The new readers on a run's stats; a program without the span leaves them empty
    (an empty ``Run``, as the parent commit's)."""
    assert _reader(name)(SimpleNamespace(stats=stats)) == want
    empty = harness.Run(frames=8, window_s=1.0, setup_s=1.0, memory_peak_bytes=0,
                        checks=[], attempted=8)
    assert _reader(name)(empty) is None


def _shrunk_cell() -> dict:
    w = copy.deepcopy(harness.workload("r2d2_quad.extract"))
    cfg, tr = w["config"], w["traffic"]
    H, W = 120, 384
    f = 721.53 * W / 1232
    cfg["image_hw"] = [H, W]
    cfg["K"] = [[f, 0.0, (W - 1) / 2], [0.0, f, (H - 1) / 2], [0.0, 0.0, 1.0]]
    cfg["multiscale"].update(min_size=32, max_size=128, top_k=300, per_scale_k=128)
    tr.update(frames=8, batch=4, sample_range=4)
    return w


def _run(w: dict, seed: int = 2 ** 31 + 21):
    import time

    ctx = SimpleNamespace(config=w["config"], traffic=w["traffic"],
                          device=torch.device("cpu"), seed=seed, seconds=0.5, trace=False,
                          t0=time.perf_counter())
    return r2d2_extract_spans.run(ctx)


def test_driver_is_correct_on_a_small_quad_cell():
    w = _shrunk_cell()
    assert w["traffic"]["driver"] == "r2d2_extract_spans"
    assert [m["name"] for m in w["end_to_end"]] == ["frames_per_s.extract", "setup_s"]
    run = _run(w)
    line = harness.result_line(w, run, False, "cpu", "cpu")
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"frames_per_s.extract", "setup_s"}
    assert set(line["checks"]) == {"keypoints_off", "desc_gap", "score_gap"}
    assert run.stats == {} and run.frames == run.attempted > 0


def test_driver_sees_a_broken_timed_path(monkeypatch):
    orig = multiscale.extract_multiscale

    def altered(*args, **kw):
        f = orig(*args, **kw)
        desc = f.desc.clone()
        desc[:, 0, 0] += 1e-3
        return f._replace(desc=desc)

    monkeypatch.setattr(multiscale, "extract_multiscale", altered)
    run = _run(_shrunk_cell())
    assert "desc_gap" in {c.name for c in run.checks if not c.ok}
