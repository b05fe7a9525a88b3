"""The benchmark's yardstick on the CPU: discovery by name, the import scan, the
operation counts, the frozen renderer, and the plain references against the port at a
small size."""

from __future__ import annotations

import ast
import json
import os
import re

import numpy as np
import pytest
import torch

from conftest import BENCH, context, shrink
from vobench import counts, harness, kitti, r2d2_extract, ref_engine, ref_r2d2, render
from vobench import rgbd_replay

ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_every_cell_resolves_its_files_by_name():
    man = harness.manifest()
    for cell in man["workloads"]:
        w = harness.workload(cell["name"], man)
        assert callable(harness.driver(w["traffic"]).run)
        names = {m["name"] for m in w["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2, cell["name"]
        assert w["per_layer"], cell["name"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]


def test_manifest_keeps_to_the_contract():
    man = harness.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in man[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in man["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and m["bound"] <= 0.25
    layers = {m["layer"] for m in man["per_layer"]}
    assert all("\n" not in layer for layer in layers)
    assert 1 <= man["run_seconds"] <= 51


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


def _module_file(name: str) -> str | None:
    for base in (BENCH, ROOT):
        stem = os.path.join(base, *name.split("."))
        for cand in (stem + ".py", os.path.join(stem, "__init__.py")):
            if os.path.isfile(cand):
                return cand
    return None


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    """Every import in the benchmark's files and, transitively, in the modules of the
    repository they reach (imports inside functions too), by whole top-level name."""
    todo = [os.path.join(d, f) for d, _, fs in os.walk(BENCH) for f in fs
            if f.endswith(".py") and "tests" not in d.split(os.sep)]
    seen, reached = set(), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for mod in _imports(path):
            reached.add(mod)
            parts = mod.split(".")
            for i in range(1, len(parts) + 1):
                f = _module_file(".".join(parts[:i]))
                if f is not None:
                    todo.append(f)
    assert any(p.startswith(os.path.join(ROOT, "vo_tpu_torch")) for p in seen)
    bad = sorted(m for m in reached if m.split(".")[0] in harness.FORBIDDEN_MODULES)
    assert not bad, bad


def test_forbidden_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "vo_tpu_torch_lookalike", types.ModuleType("x"))
    assert "vo_tpu_torch_lookalike" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "vo_tpu.engine", types.ModuleType("y"))
    assert "vo_tpu.engine" in harness.forbidden_loaded()


def test_match_operations_and_bytes_by_hand():
    flops, nbytes = counts.match_ops_bytes(2048, 2048, 256, bf16=True)
    assert flops == 2 * 2048 * 2048 * 256 == 2_147_483_648
    # operands 4096 x 256 x 2 B, masks 4096 B, rows 2048 x 12 B, columns 2048 x 4 B
    assert nbytes == 2_097_152 + 4_096 + 24_576 + 8_192
    bound, by = counts.match_bound_s(2048, 2048, 256, bf16=True)
    assert by == "operations" and bound == pytest.approx(2_147_483_648 / 989e12)
    flops32, bytes32 = counts.match_ops_bytes(100, 50, 128, bf16=False)
    assert flops32 == 2 * 100 * 50 * 128
    assert bytes32 == 150 * 128 * 4 + 150 + 100 * 12 + 50 * 4


def test_r2d2_operations_by_hand():
    net = harness.load_json(BENCH, "configs", "r2d2_fast_kitti.json")["network"]
    # Full resolution: 3x3 convolutions 3->32, 32->32, 32->64.
    full = 2 * 9 * (3 * 32 + 32 * 32 + 32 * 64)
    assert full == 57_024
    # After the 2x pool: 64->64, 64->128, 128->128 (3x3), three 2x2 128->128.
    half = 2 * (9 * (64 * 64 + 64 * 128 + 128 * 128) + 3 * 4 * 128 * 128)
    assert half == 909_312
    heads = 2 * 128 * 3
    assert counts.patchnet_flops(net["layers"], 128, 64, 96) == (
        (full + heads) * 64 * 96 + half * 32 * 48)
    cfg = harness.load_json(BENCH, "configs", "r2d2_fast_kitti.json")
    levels = counts.pyramid_levels(376, 1232, cfg["multiscale"])
    assert [lv[1:] for lv in levels] == [(266, 872), (224, 734), (188, 616), (158, 518),
                                         (134, 436), (112, 366), (94, 308), (80, 260)]
    assert sum(h * w for _, h, w in levels) == 743_188


def test_frozen_renderer_matches_the_numpy_renderers():
    from vo_tpu_torch.utils.synthetic import default_world, render_rgbd

    K = np.array([[75.0, 0.0, 63.5], [0.0, 75.0, 23.5], [0.0, 0.0, 1.0]])
    poses = render.slalom(12)[[0, 11]]
    planes = render.world(None)
    for T in poses:
        img, dep = render.render_numpy(T, K, 48, 128, planes)
        want_img, want_dep = render_rgbd(T, K, 48, 128, default_world())
        assert np.array_equal(img, want_img) and np.array_equal(dep, want_dep)
    imgs, deps = render.render_torch(poses, K, 48, 128, planes, torch.device("cpu"))
    for i, T in enumerate(poses):
        img, dep = render.render_numpy(T, K, 48, 128, planes)
        assert np.array_equal(imgs[i], img) and np.array_equal(deps[i], dep)
    other = render.world(2 ** 31 + 17)
    assert [p.tex_seed for p in other] != [p.tex_seed for p in planes]


def test_kitti_segments_match_the_evaluator():
    from vo_tpu_torch.evalkit import KittiOdomEvaluator

    gt = render.slalom(200)
    rng = np.random.default_rng(3)
    pred = gt.copy()
    pred[:, :3, 3] += np.cumsum(rng.normal(0, 0.01, (200, 3)), axis=0)
    res = KittiOdomEvaluator().evaluate(gt, pred)
    t, r = kitti.segment_errors(gt, pred)
    assert t == pytest.approx(res.seg_trans_err_pct, rel=1e-12)
    assert r == pytest.approx(res.seg_rot_err_deg_per_100m, rel=1e-12)


@pytest.fixture(scope="module")
def small_drive():
    w = shrink("orb_kitti.replay", frames=16)
    inputs = render.render_drive(w["traffic"], w["config"], 5, torch.device("cpu"))
    return w, inputs


def test_reference_extraction_matches_the_port(small_drive):
    from vo_tpu_torch.engine.pipeline import backproject_sparse

    w, inputs = small_drive
    cfg = w["config"]
    extractor, _ = rgbd_replay.program(cfg)
    gray = torch.from_numpy(inputs["gray"][:4])
    feats = extractor(gray, device="cpu")
    kp, desc, valid = ref_engine.extract(gray, cfg["extractor"])
    assert torch.equal(kp, feats.kp) and torch.equal(valid, feats.valid)
    assert torch.equal(desc, feats.desc)
    K = torch.tensor(cfg["K"], dtype=torch.float32)
    mm = torch.from_numpy(inputs["mm"][:4].astype(np.int32))
    H, W = cfg["image_hw"]
    xi = kp[..., 0].long().clamp(0, W - 1)
    yi = kp[..., 1].long().clamp(0, H - 1)
    z16 = torch.from_numpy(inputs["mm"][:4])[torch.arange(4)[:, None], yi, xi]
    want = backproject_sparse(feats.kp, z16.view(torch.int16), K)
    assert torch.equal(ref_engine.backproject(kp, mm, K), want)


def test_reference_drive_matches_the_port_engine(small_drive):
    from vo_tpu_torch.engine.pipeline import run_offline_vo

    w, inputs = small_drive
    cfg = w["config"]
    extractor, vo = rgbd_replay.program(cfg)
    K = np.asarray(cfg["K"], np.float32)
    deps = inputs["mm"].astype(np.float32) * np.float32(1e-3)
    poses, diag = run_offline_vo(inputs["gray"], deps, K, vo_config=vo,
                                 extractor=extractor, device="cpu")
    Kt = torch.from_numpy(K)
    ref = ref_engine.run_drive(torch.from_numpy(inputs["gray"]),
                               torch.from_numpy(inputs["mm"].astype(np.int32)), Kt, cfg,
                               batch=8)
    assert np.array_equal(ref["diag"]["n_inliers"], diag.n_inliers)
    assert np.array_equal(ref["diag"]["accepted"], diag.accepted)
    assert np.array_equal(ref["diag"]["promoted_keyframe"], diag.promoted_keyframe)
    np.testing.assert_allclose(ref["poses"], poses, atol=1e-5)


def test_reference_r2d2_matches_the_port():
    from vo_tpu_torch.models.multiscale import extract_multiscale

    w = shrink("r2d2_fast.extract")
    cfg, tr = w["config"], w["traffic"]
    inputs = r2d2_extract.make_inputs(cfg, tr, 7, torch.device("cpu"))
    spec, mcfg = r2d2_extract.program(cfg)
    rgb = inputs["rgb"][:2]
    got = extract_multiscale(inputs["params"], spec, rgb, mcfg, device="cpu")
    want = ref_r2d2.extract(inputs["params"], cfg, torch.from_numpy(rgb))
    for k in ("kp", "desc", "score", "valid"):
        assert torch.equal(getattr(got, k), want[k]), k


def test_weights_come_from_the_seed_alone():
    net = harness.load_json(BENCH, "configs", "r2d2_fast_kitti.json")["network"]
    a = ref_r2d2.draw_weights(net, 2 ** 31 + 5, torch.device("cpu"))
    b = ref_r2d2.draw_weights(net, 2 ** 31 + 5, torch.device("cpu"))
    c = ref_r2d2.draw_weights(net, 6, torch.device("cpu"))
    assert torch.equal(a["convs"][3]["w"], b["convs"][3]["w"])
    assert not torch.equal(a["convs"][3]["w"], c["convs"][3]["w"])
    assert a["convs"][0]["w"].shape == (32, 3, 3, 3) and a["clf"]["w"].shape == (2, 128, 1, 1)


def test_readers_stay_silent_without_their_source():
    run = harness.Run(frames=10, window_s=2.0, setup_s=1.0, memory_peak_bytes=0, checks=[],
                      attempted=10)
    man = harness.manifest()
    for m in man["per_layer"]:
        assert harness.reader(m["name"])(run) is None, m["name"]
    assert harness.reader("frames_per_s.replay")(run) == 5.0


def test_a_sound_small_run_is_correct_and_prints_every_key():
    w = shrink("r2d2_fast.extract")
    run = r2d2_extract.run(context(w, 11))
    line = harness.result_line(w, run, False, "cpu", "cpu")
    assert line["correct"], line["checks"]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"frames_per_s.extract", "setup_s"}
    json.dumps(line)
