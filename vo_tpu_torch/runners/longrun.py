"""KITTI-length long run: 801 frames, streaming, bounded memory.

Port of ``vo_tpu/runners/longrun.py``. 801 KITTI-resolution frames of the synthetic
world, streamed from disk (gray PNG + uint16-millimetre npy) through the native
decode pool, with the sparse depth transfer, sparse feature retention, a mid-run
checkpoint and ``refine_full``; the KITTI evaluator's numbers and the host and device
memory peaks go into a JSON report.

    python -m vo_tpu_torch.runners.longrun --dir DIR --out DIR/longrun.json \
        [--frames 801] [--render-if-missing]

``--dir`` must be given. The frames are rendered in a process pool (``processes``,
default min(8, cpu count)) with the JAX runner's bytes. The report has the JAX
runner's keys; ``device`` is the card's name and power limit as ``nvidia-smi``
prints them. Added: ``refined_finite`` (every refined pose is finite) and, on the
card, ``peak_device_mb`` (the run's and the refinement's peak allocation).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import resource
import sys
import time

import numpy as np

F_DEFAULT = 801
H, W = 376, 1232
K = np.array([[721.53, 0.0, 609.55], [0.0, 721.53, 172.85], [0.0, 0.0, 1.0]],
             np.float32)


def render_frame(d: str, i: int, T: np.ndarray, n_frames: int) -> None:
    """Render frame ``i`` of an ``n_frames`` run at pose ``T`` and write
    ``{i:06d}.png`` (8-bit gray, PIL) and ``{i:06d}_depth.npy`` (uint16 mm)."""
    from PIL import Image

    from vo_tpu_torch.utils.synthetic import (default_world, depth_valid_fraction,
                                              render_rgbd)

    world = default_world(far_z=float(n_frames * 0.8 + 120))
    g, dep = render_rgbd(T, K, H=H, W=W, world=world,
                         max_depth=float(n_frames * 0.8 + 140))
    if depth_valid_fraction(dep) <= 0.5:
        raise RuntimeError(f"frame {i}: depth-valid fraction {depth_valid_fraction(dep)}")
    Image.fromarray(np.clip(g, 0, 255).astype(np.uint8), mode="L").save(
        os.path.join(d, f"{i:06d}.png"))
    np.save(os.path.join(d, f"{i:06d}_depth.npy"),
            np.round(np.clip(dep, 0, 65.535) * 1000.0).astype(np.uint16))


def render_jobs(d: str, n_frames: int) -> list[tuple]:
    """``render_frame``'s arguments for every frame of an ``n_frames`` run into ``d``
    (created), for a caller's own pool."""
    from vo_tpu_torch.utils.synthetic import slalom_trajectory

    os.makedirs(d, exist_ok=True)
    return [(d, i, T, n_frames) for i, T in enumerate(slalom_trajectory(n_frames, step=0.8))]


def mark_complete(d: str, n_frames: int) -> None:
    """Write ``gt.npy`` and the ``.complete`` marker once every frame is on disk."""
    from vo_tpu_torch.utils.synthetic import slalom_trajectory

    np.save(os.path.join(d, "gt.npy"), slalom_trajectory(n_frames, step=0.8))
    open(os.path.join(d, ".complete"), "w").close()


def render_sequence_dir(d: str, n_frames: int, processes: int | None = None) -> None:
    """Render the slalom of ``n_frames`` frames into ``d`` (frames, ``gt.npy`` and a
    ``.complete`` marker) in a spawned pool of ``processes`` workers (default
    min(8, cpu count); 1 renders in this process)."""
    jobs = render_jobs(d, n_frames)
    if processes is None:
        processes = min(8, os.cpu_count() or 1)
    if processes <= 1:
        for job in jobs:
            render_frame(*job)
    else:
        with multiprocessing.get_context("spawn").Pool(processes) as p:
            for k, _ in enumerate(p.imap(_render_job, jobs)):
                if k % 100 == 0:
                    print(f"[longrun] render {k}/{n_frames}", flush=True)
    mark_complete(d, n_frames)


def _render_job(job) -> None:
    render_frame(*job)


def main(argv=None, device: str | None = None) -> int:
    """The long run on ``device`` (default cuda; raises if there is no GPU) -> exit code."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--frames", type=int, default=F_DEFAULT)
    ap.add_argument("--out", default="LONGRUN.json")
    ap.add_argument("--render-if-missing", action="store_true")
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args(argv)

    import torch

    from vo_tpu_torch.device import card_name, resolve_device

    dev = resolve_device(device)

    if not os.path.exists(os.path.join(args.dir, ".complete")):
        if not args.render_if_missing:
            print(f"sequence dir {args.dir} missing (pass --render-if-missing)",
                  file=sys.stderr)
            return 1
        render_sequence_dir(args.dir, args.frames)

    from vo_tpu_torch.engine.pipeline import run_offline_vo_streaming
    from vo_tpu_torch.engine.refine import refine_full
    from vo_tpu_torch.engine.vo import VOConfig
    from vo_tpu_torch.estimation.pnp import PnPConfig
    from vo_tpu_torch.evalkit import KittiOdomEvaluator
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.io.native import NativeRGBDSequence

    gt = np.load(os.path.join(args.dir, "gt.npy"))
    F = min(args.frames, gt.shape[0])
    vo_cfg = VOConfig(matcher="ratio_binary", pnp=PnPConfig(n_hypotheses=512))
    extractor = OrbLikeExtractor(max_kp=2048)
    ckpt = os.path.join(args.dir, "mid.ckpt.npz")

    def open_native():
        nat = NativeRGBDSequence.try_open(args.dir)
        if nat is None:
            raise RuntimeError("native loader unavailable")
        return nat

    # Warm-up pass over a short prefix: the kernels and allocator outside the timed run.
    nat = open_native()
    run_offline_vo_streaming(
        nat.iter_batches(args.batch, limit=3 * args.batch, gray=True, depth="u16mm"),
        3 * args.batch, K, vo_config=vo_cfg, extractor=extractor,
        transfer_depth="sparse", retain="sparse", device=dev)
    nat.close()

    nat = open_native()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    poses, diag, (feats, kp3d, feat_rows) = run_offline_vo_streaming(
        nat.iter_batches(args.batch, limit=F, gray=True, depth="u16mm"), F, K,
        vo_config=vo_cfg, extractor=extractor, transfer_depth="sparse", retain="sparse",
        checkpoint_path=ckpt, checkpoint_every=256, device=dev)
    stream_wall = time.perf_counter() - t0
    nat.close()

    res = KittiOdomEvaluator().evaluate(gt[:F], poses)
    accept = float(np.mean(np.asarray(diag.accepted)))
    drift = float(np.linalg.norm(poses[-1, :3, 3] - gt[F - 1, :3, 3]))

    t0 = time.perf_counter()
    refined, rinfo = refine_full(
        poses, feats.kp, feats.desc, feats.valid, kp3d, K,
        diag_promoted=np.asarray(diag.promoted_keyframe), feat_rows=feat_rows, device=dev)
    refine_wall = time.perf_counter() - t0
    res_r = KittiOdomEvaluator().evaluate(gt[:F], refined)

    peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    retained = int(len(feat_rows))
    report = {
        "frames": int(F),
        "resolution": [H, W],
        "distance_m": round(float(res.total_distance), 1),
        "fps_io_included": round(F / stream_wall, 2),
        "stream_wall_s": round(stream_wall, 1),
        "seg_trans_err_pct": round(float(res.seg_trans_err_pct), 3),
        "seg_rot_err_deg_100m": round(float(res.seg_rot_err_deg_per_100m), 3),
        "final_drift_m": round(drift, 3),
        "accept_rate": round(accept, 3),
        "checkpoint_written": os.path.exists(ckpt),
        "retained_feature_frames": retained,
        "retained_fraction": round(retained / F, 3),
        "refine_windows": len(rinfo["ba"].get("windows", [])),
        "refine_ran_ba": bool(rinfo["ran_ba"]),
        "refine_loop_edges": int(rinfo["loop_edges"]),
        "refine_wall_s": round(refine_wall, 1),
        "refine_seg_trans_err_pct": round(float(res_r.seg_trans_err_pct), 3),
        "peak_host_rss_mb": round(peak_rss_mb, 1),
        "reference_full_run": {"frames": 801, "seg_trans_err_pct": 3.37,
                               "seg_rot_err_deg_100m": 1.271,
                               "source": "plot_utils/data/global_poses.npy "
                                         "scored by kittievalodom.py (BASELINE.md)"},
        "device": card_name(dev),
    }
    report["refined_finite"] = bool(np.isfinite(refined).all())
    if dev.type == "cuda":
        report["peak_device_mb"] = round(torch.cuda.max_memory_allocated(dev) / 2**20, 1)
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, args.out)
    print(f"[longrun] {json.dumps(report)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
