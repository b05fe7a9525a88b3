"""The port's spans (``utils/profiling.py``): the tree a streaming run records, the
streaming entry's ``stats`` read from the same clock reads, outputs unchanged by the
recorder, the spans on the profiler's clock, the R2D2 pyramid's levels, ``OnlineVO``'s
frame spans, and the files ``trace`` and ``vo_run --trace`` write.

The drive is tests/test_torch_streaming.py's configuration (rendered frames, 240 x 320,
512 keypoints, 256 hypotheses) cut to 8 frames, streamed in two chunks of 4 with the
sparse depth transfer. On the CPU there is no device to wait on, so the readback waits
(``stream.sync_wait``) and the device spans' CUDA events are held on the card
(tests/test_torch_cuda.py).
"""

import json
import threading

import numpy as np
import pytest
import torch

from vo_tpu_torch import prng
from vo_tpu_torch.engine.online import OnlineVO
from vo_tpu_torch.engine.pipeline import extract_and_backproject, run_offline_vo_streaming
from vo_tpu_torch.engine.vo import VOConfig, VOEngine
from vo_tpu_torch.estimation.pnp import PnPConfig
from vo_tpu_torch.features.extractor import OrbLikeExtractor
from vo_tpu_torch.io.dataset import write_gray_u16mm_dir
from vo_tpu_torch.models import multiscale, patchnet
from vo_tpu_torch.runners import vo_run
from vo_tpu_torch.utils import profiling
from vo_tpu_torch.utils.synthetic import render_sequence

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
CFG = VOConfig(matcher="ratio_binary", kf_min_matches=60, kf_min_inliers=30,
               pnp=PnPConfig(min_inliers=15, n_hypotheses=256))
EX = OrbLikeExtractor(max_kp=512)
F, B = 8, 4
PNP_STAGES = ["pnp.hypotheses", "pnp.score", "pnp.anneal", "pnp.refine"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    profiling.stop()
    yield
    profiling.stop()


@pytest.fixture(scope="module")
def frames():
    imgs, deps, _ = render_sequence(F, K, H=240, W=320, step=0.8, yaw_rate=0.01)
    return imgs, deps


def _stream(frames, stats=None):
    imgs, deps = frames

    def batches():
        for s in range(0, F, B):
            yield s, imgs[s:s + B], deps[s:s + B]

    return run_offline_vo_streaming(batches(), F, K, vo_config=CFG, extractor=EX,
                                    transfer_depth="sparse", device="cpu", stats=stats)


@pytest.fixture(scope="module")
def traced(frames):
    """(outputs, stats, spans) of the streaming run with the recorder on."""
    stats: dict = {}
    profiling.start()
    try:
        out = _stream(frames, stats)
    finally:
        spans = profiling.stop()
    return out, stats, spans


def _names(spans, idx):
    return [spans[j].name for j in idx]


def _sum_s(spans, name):
    return sum((s.end_ns - s.start_ns) * 1e-9 for s in spans if s.name == name)


def test_streaming_span_tree(traced):
    _, _, spans = traced
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in spans)
    roots = [i for i, s in enumerate(spans) if s.parent == -1 and s.name == "stream.chunk"]
    # two chunks, then the wait that finds the end of the stream and flushes chunk 1
    assert [spans[i].attrs["chunk"] for i in roots] == [0, 1, 2]
    kids = [[spans[j].name for j, s in enumerate(spans) if s.parent == i] for i in roots]
    assert kids[0] == ["stream.queue_wait", "stream.extract", "stream.depth_gather",
                       "engine.chunk", "stream.pack"]
    assert kids[1] == ["stream.queue_wait", "stream.extract", "stream.flush",
                       "stream.depth_gather", "engine.chunk", "stream.pack"]
    assert kids[2] == ["stream.queue_wait", "stream.flush"]
    consumer = spans[roots[0]].tid
    # every span under chunk k carries chunk k
    for i, s in enumerate(spans):
        if s.tid != consumer:
            continue
        root = i
        while spans[root].parent != -1:
            root = spans[root].parent
        assert s.attrs["chunk"] == spans[root].attrs["chunk"], s

    steps = [i for i, s in enumerate(spans) if s.name == "engine.step"]
    assert [spans[i].attrs["frame"] for i in steps] == list(range(1, F))
    assert all(spans[spans[i].parent].name == "engine.chunk" for i in steps)
    assert [spans[i].attrs["chunk"] for i in steps] == [0, 0, 0, 1, 1, 1, 1]
    for i in steps:
        kids = [j for j, s in enumerate(spans) if s.parent == i]
        assert _names(spans, kids) == ["engine.match", "pnp.ransac"]
        assert _names(spans, [j for j, s in enumerate(spans) if s.parent == kids[1]]) \
            == PNP_STAGES
        inner = [spans[j] for j in kids]
        assert spans[i].start_ns <= inner[0].start_ns <= inner[1].end_ns <= spans[i].end_ns

    # the producer: one loader.next per batch and one that ends the stream, on its thread
    loader = [s for s in spans if s.name.startswith("loader.")]
    assert [(s.name, s.attrs["chunk"]) for s in loader] == [
        ("loader.next", 0), ("loader.upload", 0), ("loader.next", 1),
        ("loader.upload", 1), ("loader.next", 2)]
    assert {s.tid for s in loader} != {consumer} and len({s.tid for s in loader}) == 1
    assert all(s.parent == -1 for s in loader)


def test_stats_are_the_span_sums(traced):
    _, stats, spans = traced
    assert stats["queue_wait_s"] == pytest.approx(_sum_s(spans, "stream.queue_wait"),
                                                  rel=1e-12, abs=1e-15)
    assert stats["engine_s"] == pytest.approx(_sum_s(spans, "engine.chunk"),
                                              rel=1e-12, abs=1e-15)
    assert stats["engine_s"] > 0.0
    # no device on the CPU: nothing to wait on, and no span either
    assert stats["sync_wait_s"] == 0.0 == _sum_s(spans, "stream.sync_wait")
    assert stats["chunks"] == 2


def test_stats_count_eager_steps_on_the_cpu(traced):
    """Off CUDA every step runs ``_step`` eagerly: one per frame after the first."""
    _, stats, spans = traced
    assert stats["eager_steps"] == F - 1 and stats["graph_replays"] == 0
    steps = [s for s in spans if s.name == "engine.step"]
    assert [s.attrs["frame"] for s in steps] == list(range(1, F))
    assert not any("graph" in s.attrs for s in steps)


@pytest.mark.parametrize("change, same", [
    (dict(seed=1), True), (dict(min_point_depth=0.5, max_point_depth=20.0), True),
    (dict(ratio=0.8), False), (dict(kf_min_matches=61), False),
    (dict(pnp=PnPConfig(min_inliers=15, n_hypotheses=128)), False),
    (dict(matcher="mutual_nn"), False)])
def test_graph_key_holds_what_the_step_reads(change, same):
    """The key of the step's CUDA graph: the fields ``_step`` reads, not the seed or the
    depth limits (they reach it as inputs); the engine's class; each input's shape."""
    import dataclasses

    from vo_tpu_torch.engine.vo import _graph_key

    def key(engine, k=512):
        state = engine.initial_state(torch.zeros(k, 2), torch.zeros(k, 256), torch.ones(
            k, dtype=torch.bool), torch.ones(k, 3))
        per_frame = (torch.zeros(4, k, 2), torch.zeros(4, k, 256),
                     torch.ones(4, k, dtype=torch.bool), torch.ones(4, k, 3),
                     torch.ones(4, k, dtype=torch.bool), torch.arange(4, dtype=torch.int32),
                     torch.zeros(4, 2, dtype=torch.int32))
        return _graph_key(engine, torch.eye(3), state, per_frame)

    class Sub(VOEngine):
        pass

    base = key(VOEngine(CFG, device="cpu"))
    assert (key(VOEngine(dataclasses.replace(CFG, **change), device="cpu")) == base) == same
    assert key(Sub(CFG, device="cpu")) != base
    assert key(VOEngine(CFG, device="cpu"), k=256) != base
    assert hash(base) == hash(key(VOEngine(CFG, device="cpu")))


@pytest.mark.parametrize("stats, want", [
    ({"graph_replays": 150, "eager_steps": 0}, 100.0),
    ({"graph_replays": 45, "eager_steps": 15}, 75.0),
    ({"graph_replays": 0, "eager_steps": 7}, 0.0),
    ({"graph_replays": 0, "eager_steps": 0}, None),
    ({"engine_s": 2.5, "chunks": 10}, None),          # a program without the counters
    ({"graph_replays": 3}, None),
])
def test_engine_graph_step_pct_reader(stats, want):
    """The benchmark's reader of ``engine_graph_step_pct`` on the entry's stats."""
    import importlib.util
    import os
    from types import SimpleNamespace

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark", "metrics", "engine_graph_step_pct.py")
    spec = importlib.util.spec_from_file_location("engine_graph_step_pct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read(SimpleNamespace(stats=stats, frames=160)) == want


def test_recorder_changes_no_output_and_records_nothing_when_off(frames, traced):
    (poses, diag, (feats, kp3d, rows)), _, _ = traced
    stats: dict = {}
    poses0, diag0, (feats0, kp3d0, rows0) = _stream(frames, stats)
    assert profiling.stop() == []
    np.testing.assert_array_equal(poses, poses0)
    for a, b in zip(diag, diag0):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(list(feats) + [kp3d], list(feats0) + [kp3d0]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(rows, rows0)
    assert set(stats) == {"queue_wait_s", "sync_wait_s", "engine_s", "h2d_bytes",
                          "d2h_bytes", "chunks", "graph_replays", "eager_steps",
                          "engine_device_s", "gn_kernel_solves", "bank_kernel_calls",
                          "extract_graph_replays", "extract_eager_calls"}


def test_off_costs_one_shared_null_context():
    assert not profiling._on
    assert profiling.span("a", frame=1) is profiling.span("b", device=True)
    with profiling.timed("c") as t:
        pass
    assert t.seconds >= 0.0 and profiling.stop() == []


def test_spans_nest_per_thread_and_open_spans_stay_open():
    profiling.start()
    done, release = threading.Event(), threading.Event()

    def other():
        with profiling.span("other.outer"):
            with profiling.span("other.inner"):
                done.set()
                release.wait(10)

    with profiling.span("main.outer", chunk=3):
        t = threading.Thread(target=other)
        t.start()
        assert done.wait(10)
        with profiling.span("main.inner"):
            pass
    spans = profiling.stop()
    release.set()
    t.join(10)
    assert not t.is_alive()
    by = {s.name: (i, s) for i, s in enumerate(spans)}
    assert by["main.inner"][1].parent == by["main.outer"][0]
    assert by["main.inner"][1].attrs == {"chunk": 3}
    assert by["other.inner"][1].parent == by["other.outer"][0]
    assert by["other.outer"][1].parent == -1
    assert by["other.outer"][1].end_ns is None and by["other.inner"][1].end_ns is None
    assert by["other.outer"][1].tid != by["main.outer"][1].tid


def test_pnp_aten_events_fall_inside_pnp_spans(frames):
    """The spans' clock is the profiler's: each PnP's argmax lies inside its
    ``pnp.score`` span, the matcher's inside ``engine.match`` spans."""
    from torch.profiler import ProfilerActivity, profile

    imgs, deps = frames
    Kd = torch.from_numpy(K)
    feats, kp3d = extract_and_backproject(EX, torch.from_numpy(imgs[:3]),
                                          torch.from_numpy(deps[:3]), Kd)
    engine = VOEngine(CFG, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.start()
        try:
            engine.run_sequence(feats.kp, feats.desc, feats.valid, kp3d, Kd)
        finally:
            spans = profiling.stop()
    argmax = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::argmax"]
    score = [s for s in spans if s.name == "pnp.score"]
    match = [s for s in spans if s.name == "engine.match"]
    ransac = [s for s in spans if s.name == "pnp.ransac"]
    assert len(score) == len(ransac) == 2 and argmax

    def inside(t, ss):
        return sum(s.start_ns <= t <= s.end_ns for s in ss)

    assert [sum(s.start_ns <= t <= s.end_ns for t in argmax) for s in score] == [1, 1]
    assert all(inside(t, score) + inside(t, match) == 1 for t in argmax)
    assert all(inside(t, ransac) for t in argmax if inside(t, score))


def test_multiscale_opens_one_level_per_scale():
    spec = patchnet.PatchNetSpec("narrow", patchnet._fast_quad_specs(1, 32), out_dim=32,
                                 upsample=2)
    params = patchnet.init_patchnet_params(prng.key(7), spec)
    cfg = multiscale.MultiscaleConfig(min_size=32, max_size=256, top_k=64, per_scale_k=32,
                                      rel_thr=0.0, rep_thr=0.0)
    rgb = np.random.default_rng(0).integers(0, 255, (2, 64, 96, 3)).astype(np.uint8)
    want = multiscale.extract_multiscale(params, spec, rgb, cfg, device="cpu")
    profiling.start()
    try:
        got = multiscale.extract_multiscale(params, spec, rgb, cfg, device="cpu")
    finally:
        spans = profiling.stop()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    scales = multiscale.pyramid_scales(64, 96, cfg)
    assert len(scales) > 1
    (root,) = [i for i, s in enumerate(spans) if s.name == "r2d2.extract"]
    assert spans[root].attrs == {"rows": 2}
    levels = [i for i, s in enumerate(spans) if s.name == "r2d2.level"]
    assert [spans[i].attrs["scale"] for i in levels] == scales
    assert [(spans[i].attrs["h"], spans[i].attrs["w"]) for i in levels] == [
        multiscale._level_hw(64, 96, s) for s in scales]
    assert all(spans[i].parent == root for i in levels)
    for i in levels:
        assert _names(spans, [j for j, s in enumerate(spans) if s.parent == i]) == [
            "r2d2.network", "r2d2.select"]
    assert _names(spans, [j for j, s in enumerate(spans) if s.parent == root]) == \
        ["r2d2.level"] * len(scales) + ["r2d2.merge"]


def test_online_frame_spans(frames):
    imgs, deps = frames
    vo = OnlineVO(K, config=CFG, extractor=EX, device="cpu")
    profiling.start()
    try:
        for i in range(2):
            vo.process_frame(imgs[i], deps[i], i)
    finally:
        spans = profiling.stop()
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [(spans[i].name, spans[i].attrs) for i in roots] == [
        ("online.frame", {"frame": 0}), ("online.frame", {"frame": 1})]
    assert _names(spans, [j for j, s in enumerate(spans) if s.parent == roots[0]]) == [
        "online.extract"]
    kids = [j for j, s in enumerate(spans) if s.parent == roots[1]]
    assert _names(spans, kids) == ["online.extract", "engine.step", "online.readback"]
    assert spans[kids[1]].attrs == {"frame": 1}
    assert _names(spans, [j for j, s in enumerate(spans) if s.parent == kids[1]]) == [
        "engine.match", "pnp.ransac"]


def _events(path):
    with open(path) as f:
        d = json.load(f)
    return d.get("baseTimeNanoseconds", 0), d["traceEvents"]


def test_trace_writes_spans_on_the_profilers_time_base(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer", chunk=0):
            torch.ones(64, 64) @ torch.ones(64, 64)
    base, prof_events = _events(tmp_path / "trace.json")
    span_base, spans = _events(tmp_path / "spans.json")
    assert span_base == base
    (outer,) = [e for e in spans if e["name"] == "outer"]
    assert outer["ph"] == "X" and outer["args"] == {"chunk": 0}
    (mm,) = [e for e in prof_events if e.get("name") == "aten::mm"]
    assert outer["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= outer["ts"] + outer["dur"]
    assert outer["tid"] == mm["tid"]
    assert not profiling._on


def test_vo_run_trace(frames, tmp_path):
    imgs, deps = frames
    write_gray_u16mm_dir(str(tmp_path / "seq"), imgs[:B], deps[:B])
    cfg = tmp_path / "run.yaml"
    cfg.write_text(f"""feature_extractor: orb
image_path: {tmp_path / 'seq'}
camera_intrinsic_matrix: [260.0, 0.0, 160.0, 0.0, 260.0, 120.0, 0.0, 0.0, 1.0]
output_filename: {tmp_path / 'out'}
max_keypoints: 512
extraction_batch: {B}
kf_min_matches: 60
kf_min_inliers: 30
pnp_min_inliers: 15
pnp_n_hypotheses: 256
""")
    res = vo_run.run(["--config", str(cfg), "--device", "cpu", "--depth-transfer",
                      "sparse", "--trace", str(tmp_path / "prof")])
    assert res.rc == 0 and res.poses.shape == (B, 4, 4)
    _, prof_events = _events(tmp_path / "prof" / "trace.json")
    _, spans = _events(tmp_path / "prof" / "spans.json")
    assert any(e.get("name") == "aten::argmax" for e in prof_events)
    names = [e["name"] for e in spans]
    assert names.count("engine.step") == B - 1 and names.count("stream.chunk") == 2
