"""Driver of the ``rgbd_replay`` traffic: offline replay of a logged RGB-D drive from
disk, as ``vo_run`` replays a directory.

Set-up renders the seed's drive on the card, writes it under ``TMPDIR`` as gray PNG +
uint16-millimetre npy (deleted at exit), and warms the program on one chunk. The
window is a closed loop over whole passes of the drive through
``run_offline_vo_streaming`` fed by the native loader: a pass starts while the time
gone plus half the last pass's length is under ``--seconds``, and every pass runs to
its end, so the window ends within half a pass of ``--seconds`` and holds only whole
passes. ``frames_per_s`` is every frame of those passes over the window's length.

Correctness (``judge``), once the window has closed: every pass's trajectory through
the KITTI gate against the render's ground truth; at ``check_frames`` frames drawn
from the seed, in every pass, one step of the plain reference from the program's own
keyframe state (the keyframe's features, pose, id and rejection count as the
program's outputs give them), compared with the program's flags, counts and pose; and
the features and camera points of those frames and their keyframes against the
reference's extraction from the benchmark's own frames.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from vobench import frames_io, kitti, ref_engine, render
from vobench.harness import Run, checks_from
from vobench.trace import SubWindow


def sample_frames(seed: int, n: int, k: int) -> list[int]:
    """``k`` distinct frames of [1, n), drawn from the seed."""
    rng = np.random.default_rng([seed % 2 ** 63, 1])
    return sorted(int(f) for f in rng.choice(np.arange(1, n), size=min(k, n - 1),
                                             replace=False))


class TimedExtractor:
    """The extractor handed to the entry: calls ``on_call(k)`` before its k-th call
    and, when ``timed``, records CUDA events around each call."""

    def __init__(self, inner, timed: bool):
        self.inner = inner
        self.timed = timed
        self.on_call = None
        self.reset()

    def reset(self) -> None:
        self.calls, self.rows, self.events = 0, 0, []

    def __call__(self, images, device=None):
        if self.on_call is not None:
            self.on_call(self.calls)
        self.calls += 1
        if not self.timed:
            return self.inner(images, device=device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.inner(images, device=device)
        end.record()
        self.events.append((start, end))
        self.rows += images.shape[0]
        return out

    def elapsed_ms(self) -> float | None:
        if not self.events:
            return None
        torch.cuda.synchronize()
        return float(sum(s.elapsed_time(e) for s, e in self.events))


def program(config: dict):
    """The system under test as the configuration states it: (extractor, VOConfig)."""
    from vo_tpu_torch.engine.vo import VOConfig
    from vo_tpu_torch.estimation.pnp import PnPConfig
    from vo_tpu_torch.features.extractor import OrbLikeExtractor

    ex, eng = config["extractor"], config["engine"]
    extractor = OrbLikeExtractor(
        max_kp=ex["max_kp"], nms_size=ex["nms_size"], rel_threshold=ex["rel_threshold"],
        border=ex["border"], subpixel=False, bits=ex["bits"], response=ex["response"],
        oriented=False, descriptor=ex["descriptor"])
    pnp = PnPConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in eng["pnp"].items()})
    keys = ("matcher", "ratio", "min_displacement_px", "min_point_depth",
            "max_point_depth", "max_speed", "kf_min_matches", "kf_min_inliers",
            "kf_max_step", "bad_pnp_limit", "seed")
    vo = VOConfig(pnp=pnp, use_match_kernel=True, **{k: eng[k] for k in keys})
    return extractor, vo


def make_inputs(config: dict, traffic: dict, seed: int, device, tmp_root=None) -> dict:
    """Render the seed's drive and write it to a new directory under ``tmp_root``
    (default ``TMPDIR``): {"gt", "gray", "mm", "dir", "render_s", "write_s"}."""
    t0 = time.perf_counter()
    inputs = render.render_drive(traffic, config, seed, device)
    t1 = time.perf_counter()
    inputs["dir"] = tempfile.mkdtemp(prefix="vo_replay_", dir=tmp_root)
    frames_io.write_drive(inputs["dir"], inputs["gray"], inputs["mm"])
    os.sync()    # the drive is on disk before the window, not in dirty pages
    inputs["render_s"], inputs["write_s"] = t1 - t0, time.perf_counter() - t1
    return inputs


def one_pass(inputs: dict, config: dict, traffic: dict, extractor, vo, device,
             limit: int = 0) -> tuple[dict, dict]:
    """One replay of the drive on disk (its first ``limit`` frames when given) ->
    (the program's outputs, its counters)."""
    from vo_tpu_torch.engine.pipeline import run_offline_vo_streaming
    from vo_tpu_torch.io.native import NativeRGBDSequence

    n = limit or inputs["gray"].shape[0]
    nat = NativeRGBDSequence.try_open(inputs["dir"])
    if nat is None:
        raise RuntimeError(f"the native loader found no frames in {inputs['dir']}")
    stats: dict = {}
    try:
        poses, diag, (feats, kp3d, _) = run_offline_vo_streaming(
            nat.iter_batches(traffic["batch"], limit=limit, gray=True, depth="u16mm"), n,
            np.asarray(config["K"], np.float32), vo_config=vo, extractor=extractor,
            prefetch=traffic["prefetch"], transfer_depth=traffic["transfer_depth"],
            device=device, stats=stats)
    finally:
        nat.close()
    out = {"poses": poses,
           "diag": {"n_matches": diag.n_matches, "n_inliers": diag.n_inliers,
                    "accepted": diag.accepted, "promoted_keyframe": diag.promoted_keyframe},
           "feats": {"kp": feats.kp, "desc": feats.desc, "valid": feats.valid, "kp3d": kp3d}}
    return out, stats


def control_outputs(inputs: dict, config: dict, traffic: dict, device) -> dict:
    """The reference in the program's place one precision down: the filters in bf16
    (the configuration's fp32 elementwise arithmetic) and the geometry's fp32 products
    with TF32 on (the configuration keeps TF32 off)."""
    K = torch.tensor(config["K"], dtype=torch.float32, device=device)
    gray = torch.from_numpy(inputs["gray"]).to(device)
    mm = torch.from_numpy(inputs["mm"].astype(np.int32)).to(device)
    return ref_engine.run_drive(gray, mm, K, config, traffic["batch"],
                                dtype=torch.bfloat16, tf32=True)


def keyframe_state(diag: dict, f: int) -> tuple[int, int]:
    """(keyframe, consecutive rejections) in force when frame ``f`` is stepped, from
    the diagnostics of frames 1.. (row i is frame i + 1)."""
    promoted = np.asarray(diag["promoted_keyframe"], bool)
    accepted = np.asarray(diag["accepted"], bool)
    kfs = np.nonzero(promoted[:f - 1])[0]
    kf = int(kfs[-1]) + 1 if kfs.size else 0
    bad = 0
    for j in range(f - 1, 0, -1):
        if accepted[j - 1]:
            break
        bad += 1
    return kf, bad


def _rotation_gap(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """|Ra - Rb|_F / sqrt(2): the angle between two rotations for small angles, and
    well conditioned where the angle's arccos is not (near 0)."""
    return float(np.linalg.norm(Ra - Rb) / np.sqrt(2.0))


def trim(out: dict, frames: list[int]) -> dict:
    """Keep of a pass's features only the rows the judge reads: the checked frames and
    their keyframes (``out["rows"]``), so that the passes of a window do not pile up on
    the card."""
    rows = sorted(set(frames) | {keyframe_state(out["diag"], f)[0] for f in frames})
    idx = torch.tensor(rows, device=out["feats"]["kp"].device)
    return dict(out, rows=rows,
                feats={k: v.index_select(0, idx) for k, v in out["feats"].items()})


def judge(inputs: dict, outputs: list[dict], config: dict, traffic: dict, seed: int,
          device) -> dict:
    """The numbers compared for ``correct`` over every pass in ``outputs`` (whole, or
    ``trim``-med to the rows the judge reads)."""
    eng, ex = config["engine"], config["extractor"]
    n = inputs["gray"].shape[0]
    K = torch.tensor(config["K"], dtype=torch.float32, device=device)
    frames = sample_frames(seed, n, traffic["check_frames"])
    num = {"feature_rows_off": 0.0, "step_flags_off": 0.0, "pose_gap_m": 0.0,
           "rot_gap_rad": 0.0, "seg_trans_pct": 0.0, "seg_rot_deg_100m": 0.0,
           "reject_rate": 0.0}
    names = ("kp", "desc", "valid", "kp3d")
    steps = off_steps = 0
    cache: dict = {}
    checked = set(frames)
    with ref_engine.matmul_precision(False):
        for out in outputs:
            d, poses, feats = out["diag"], out["poses"], out["feats"]
            pos = {f: i for i, f in enumerate(out.get("rows", range(n)))}
            g = kitti.gate(inputs["gt"], poses, d["accepted"])
            for k in ("seg_trans_pct", "seg_rot_deg_100m", "reject_rate"):
                num[k] = max(num[k], g[k])
            for f in frames:
                kf, bad = keyframe_state(d, f)
                checked.add(kf)
                used = ([feats[k][pos[kf]] for k in names]
                        + [feats[k][pos[f]] for k in names])
                key = (f, kf, bad, np.asarray(poses[kf], np.float32).tobytes())
                hit = cache.get(key)
                if hit is not None and all(torch.equal(a, b) for a, b in zip(hit[0], used)):
                    res = hit[1]
                else:
                    ref = dict(zip(names, used[:4]), id=kf, bad_pnp=bad,
                               pose=torch.tensor(np.asarray(poses[kf], np.float32),
                                                 device=device))
                    res = ref_engine.step(eng, K, ref, dict(zip(names, used[4:])), f)
                    cache[key] = (used, res)
                mine = (int(d["n_matches"][f - 1]), int(d["n_inliers"][f - 1]),
                        bool(d["accepted"][f - 1]), bool(d["promoted_keyframe"][f - 1]))
                theirs = (res["n_matches"], res["n_inliers"], res["accepted"],
                          res["promoted"])
                steps += 1
                off_steps += mine != theirs
                P = np.asarray(poses[f], np.float64)
                Q = res["pose"].to(torch.float64).cpu().numpy()
                num["pose_gap_m"] = max(num["pose_gap_m"],
                                        float(np.linalg.norm(P[:3, 3] - Q[:3, 3])))
                num["rot_gap_rad"] = max(num["rot_gap_rad"],
                                         _rotation_gap(Q[:3, :3], P[:3, :3]))
        checked = sorted(checked)
        idx = torch.tensor(checked, device=device)
        gray = torch.from_numpy(inputs["gray"]).to(device)[idx]
        mm = torch.from_numpy(inputs["mm"].astype(np.int32)).to(device)[idx]
        want = ref_engine.extract_drive(gray, mm, K, ex, traffic["batch"])
        rows = off_rows = 0
        tol = config["correctness"]["kp3d_tolerance_m"]
        for out in outputs:
            pos = {f: i for i, f in enumerate(out.get("rows", range(n)))}
            here = [i for i, f in enumerate(checked) if f in pos]
            gi = torch.tensor([pos[checked[i]] for i in here], device=device)
            wi = torch.tensor(here, device=device)
            got = {k: out["feats"][k][gi] for k in names}
            w = {k: want[k][wi] for k in names}
            off = ((got["valid"] != w["valid"])
                   | (got["kp"] != w["kp"]).any(-1)
                   | (got["desc"] != w["desc"]).any(-1)
                   | ((got["kp3d"] - w["kp3d"]).abs() > tol).any(-1))
            rows += off.numel()
            off_rows += int(off.sum())
    num["feature_rows_off"] = off_rows / rows
    num["step_flags_off"] = off_steps / steps
    return num


def run(ctx) -> Run:
    """Set-up, the window, then the judge; see the module's docstring."""
    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    inputs = make_inputs(config, traffic, ctx.seed, dev)
    try:
        extractor, vo = program(config)
        timed = TimedExtractor(extractor, timed=ctx.trace and cuda)
        t0 = time.perf_counter()
        one_pass(inputs, config, traffic, timed, vo, dev, limit=traffic["batch"])
        if cuda:
            torch.cuda.synchronize(dev)
        warm_s = time.perf_counter() - t0
        timed.reset()
        sub = None
        if ctx.trace and cuda:
            first, count = traffic["trace_chunks"]
            sub = SubWindow(first, count, traffic["batch"], dev)
            timed.on_call = sub.at
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t_window = time.perf_counter()
        setup_s = t_window - ctx.t0
        frames = sample_frames(ctx.seed, inputs["gray"].shape[0], traffic["check_frames"])
        outputs, stats, pass_s = [], Counter(), []
        while True:
            t_pass = time.perf_counter()
            out, st = one_pass(inputs, config, traffic, timed, vo, dev)
            outputs.append(trim(out, frames))
            stats.update(st)
            now = time.perf_counter()
            pass_s.append(now - t_pass)
            if now - t_window + 0.5 * pass_s[-1] >= ctx.seconds:
                break
        window_s = time.perf_counter() - t_window
        timed.on_call = None
        memory = torch.cuda.max_memory_allocated(dev) if cuda else 0
        summary = sub.summary() if sub is not None else None
        extract_ms = timed.elapsed_ms()
        t_judge = time.perf_counter()
        numbers = judge(inputs, outputs, config, traffic, ctx.seed, dev)
        judge_s = time.perf_counter() - t_judge
    finally:
        shutil.rmtree(inputs["dir"], ignore_errors=True)
    n_frames = len(outputs) * inputs["gray"].shape[0]
    return Run(frames=n_frames, window_s=window_s, setup_s=setup_s,
               memory_peak_bytes=memory,
               checks=checks_from(numbers, config["correctness"]["limits"]),
               attempted=n_frames, stats=dict(stats), extract_ms=extract_ms,
               extract_frames=timed.rows, trace=summary, config=config, traffic=traffic,
               info={"passes": len(outputs), "pass_s": pass_s, "render_s": inputs["render_s"],
                     "write_s": inputs["write_s"], "warm_s": warm_s, "judge_s": judge_s})


def readings(config: dict, traffic: dict, seed: int, device, control: bool = False) -> dict:
    """The judge's numbers for one pass of the program on the seed's drive, or for the
    control in its place (to set the limits from)."""
    inputs = make_inputs(config, traffic, seed, device)
    try:
        if control:
            outputs = [control_outputs(inputs, config, traffic, device)]
        else:
            extractor, vo = program(config)
            outputs = [one_pass(inputs, config, traffic, extractor, vo, device)[0]]
        return judge(inputs, outputs, config, traffic, seed, device)
    finally:
        shutil.rmtree(inputs["dir"], ignore_errors=True)
