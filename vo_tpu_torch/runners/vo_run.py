"""Offline RGB-D VO runner: port of ``vo_tpu/runners/vo_run.py``.

Usage:
    python -m vo_tpu_torch.runners.vo_run --config cfg.yaml               # on the GPU
    python -m vo_tpu_torch.runners.vo_run --config cfg.yaml --eval        # + score vs GT
    python -m vo_tpu_torch.runners.vo_run --config cfg.yaml --refine      # BA + pose graph
    python -m vo_tpu_torch.runners.vo_run --config cfg.yaml --device cpu
    python -m vo_tpu_torch.runners.vo_run --config cfg.yaml --limit 32 --trace prof/

Reads *.png + *_depth.npy pairs from ``image_path`` in fixed-size batches: the native
C++ loader (``native/vo_loader.cpp``, built into ``vo_tpu_torch/_build/`` at first use)
when it opens the directory, the PIL reader otherwise; decode overlaps the device's
work (``run_offline_vo_streaming``). Optionally refines the trajectory (``--refine``:
``engine/refine.py::refine_full``, windowed BA and loop closure), writes
``<output_filename>.npy`` (stacked 4x4 poses), renders the reference's
``visualize_results`` overlays and trajectory plot into ``<output_filename>_viz/``, and
evaluates against ``gt_txt_file_path``. ``--trace DIR`` profiles the streaming run
(``utils/profiling.py::trace``): ``DIR/trace.json``, the profiler's CPU and CUDA
events, and ``DIR/spans.json``, the port's spans, on one time base.

``feature_extractor`` is ``orb``, ``sift``, ``surf`` (box-filter Hessian + SURF-64,
matched in fp32) or ``r2d2`` (the published ``faster2d2_WASF_N16`` network, read from
``vo_tpu_torch/models/weights/``; matched by ``ratio_mutual_nn`` in fp32). A missing
checkpoint, or ``visualize_results: true`` without matplotlib, raises before any frame
is read.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import NamedTuple

import numpy as np

from vo_tpu_torch.config import RunConfig
from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.engine.pipeline import run_offline_vo_streaming
from vo_tpu_torch.evalkit import KittiOdomEvaluator
from vo_tpu_torch.evalkit.kitti import load_poses_txt
from vo_tpu_torch.features.extractor import OrbLikeExtractor
from vo_tpu_torch.io.dataset import RGBDSequence
from vo_tpu_torch.io.native import NativeRGBDSequence
from vo_tpu_torch.io.poses import kitti_gt_to_modified_txt, save_poses_npy
from vo_tpu_torch.utils import profiling


def build_extractor(cfg: RunConfig):
    classic = {"orb": dict(response="harris", descriptor="brief"),
               "sift": dict(response="dog", descriptor="gradhist"),
               "surf": dict(response="hessian", descriptor="surf")}
    if cfg.feature_extractor in classic:
        kw = classic[cfg.feature_extractor]
        if cfg.octaves > 1:
            from vo_tpu_torch.features.pyramid import MultiScaleClassicExtractor

            return MultiScaleClassicExtractor(
                max_kp=cfg.max_keypoints, n_scales=cfg.octaves,
                oriented=cfg.oriented, **kw)
        if cfg.feature_extractor == "orb":
            return OrbLikeExtractor(max_kp=cfg.max_keypoints)
        return OrbLikeExtractor(max_kp=cfg.max_keypoints, **kw)
    if cfg.feature_extractor == "r2d2":
        from vo_tpu_torch.models.r2d2_extractor import R2D2Extractor

        return R2D2Extractor.from_pretrained(max_kp=cfg.max_keypoints)
    raise ValueError(f"unknown feature_extractor {cfg.feature_extractor!r}")


def refine_poses(poses, feats, kp3d, K, diag, feat_rows=None, save_odometry=None,
                 device=None):
    """BA-refine keyframe windows, then close loops with a pose graph
    (``refine_full``'s adaptive branch). ``feat_rows`` maps feature rows to frame ids
    when the streaming run retained features sparsely. Returns (closed poses, the
    refinement's info dict)."""
    from vo_tpu_torch.engine.refine import refine_full

    closed, info = refine_full(
        poses, feats.kp, feats.desc, feats.valid, kp3d, K,
        diag_promoted=np.asarray(diag.promoted_keyframe), feat_rows=feat_rows,
        device=device)
    lc = info["pgo"]
    if info["ran_ba"]:
        print(f"[refine] heading drift {info['loop_rot_disc_deg']:.2f} deg -> "
              f"rotation-only BA over {len(info['ba']['windows'])} windows, "
              f"{len(info['keyframes'])} keyframes")
    else:
        print(f"[refine] heading drift {info['loop_rot_disc_deg']:.2f} deg "
              f"(healthy) -> BA skipped, isotropic closure")
    print(f"[refine] pose graph: {lc['n_loop_edges']} loop edges, "
          f"cost {lc['pgo_cost'][0]:.4f} -> {lc['pgo_cost'][-1]:.4f}")
    if save_odometry:
        save_poses_npy(save_odometry, info["refined_odometry"])
        print(f"[refine] odometry-stage trajectory -> {save_odometry}")
    return closed, info


def write_visualizations(out_dir, image_path, feats, vo_cfg, poses, gt=None,
                         stride: int = 1, max_frames: int = 400, feat_rows=None):
    """The reference's visualize_results output: per-frame keypoint draws, overlays of
    consecutive frames' matches (the plain matchers, as the JAX package's XLA ones)
    and the trajectory plot. Frames are read again from ``image_path`` (the streaming
    run keeps no pixels). With sparse feature retention, ``feat_rows`` names the frames
    that still have features; overlays cover those."""
    from vo_tpu_torch.evalkit.plotting import (draw_keypoints, draw_matches,
                                               plot_trajectories)
    from vo_tpu_torch.matching.matchers import ratio_match, ratio_mutual_nn_match

    os.makedirs(out_dir, exist_ok=True)
    plot_trajectories(os.path.join(out_dir, "trajectory.png"), poses, gt=gt)

    seq = RGBDSequence.from_dir(image_path)
    if feat_rows is None:
        frames = np.arange(min(len(seq), feats.kp.shape[0], max_frames))[::stride]
        rows = frames
    else:
        keep = np.asarray(feat_rows) < min(len(seq), max_frames)
        rows = np.nonzero(keep)[0][::stride]
        frames = np.asarray(feat_rows)[rows]
    kps, valid = feats.kp.cpu().numpy(), feats.valid.cpu().numpy()
    binary = vo_cfg.matcher == "ratio_binary"
    prev = None
    for r, i in zip(rows, frames):
        r, i = int(r), int(i)
        img, _ = seq[i]
        draw_keypoints(os.path.join(out_dir, f"kps_{i:06d}.png"), img, kps[r], valid[r])
        if prev is not None:
            rj, j, pimg = prev
            if binary:
                m = ratio_match(feats.desc[rj], feats.desc[r], feats.valid[rj],
                                feats.valid[r], ratio=vo_cfg.ratio,
                                binary_dim=feats.desc.shape[-1])
            else:
                m = ratio_mutual_nn_match(feats.desc[rj], feats.desc[r], feats.valid[rj],
                                          feats.valid[r], ratio=vo_cfg.ratio)
            mask = m.mask.cpu().numpy()
            kp1 = kps[rj][mask]
            kp2 = kps[r][m.idx.cpu().numpy()[mask]]
            draw_matches(os.path.join(out_dir, f"matches_{j:06d}_{i:06d}.png"),
                         pimg, img, kp1, kp2, stride=max(len(kp1) // 80, 1))
        prev = (r, i, img)
    print(f"[viz] wrote overlays for {len(frames)} frames to {out_dir}/")


class RunResult(NamedTuple):
    """What ``run`` did: its exit code, the loader, the poses it wrote, the engine's
    diagnostics and the odometry (the poses before any refinement); with ``--refine``
    also the refinement's info and the retained features ``(feats, kp3d, feat_rows)``."""

    rc: int
    loader: str = ""
    poses: np.ndarray | None = None
    diag: tuple | None = None
    odometry: np.ndarray | None = None
    refine: dict | None = None
    features: tuple | None = None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--eval", action="store_true", help="score against gt_txt_file_path")
    ap.add_argument("--refine", action="store_true",
                    help="windowed BA + loop-closure pose graph on the trajectory")
    ap.add_argument("--save-odometry", default=None, metavar="PATH",
                    help="with --refine: also write the odometry stage (before loop "
                         "closure) as PATH.npy")
    ap.add_argument("--limit", type=int, default=0, help="process only the first N frames")
    ap.add_argument("--checkpoint", default=None,
                    help="mid-run checkpoint path (poses so far + engine state)")
    ap.add_argument("--checkpoint-every", type=int, default=256,
                    help="frames between mid-run checkpoints")
    ap.add_argument("--resume", default=None,
                    help="resume a run from a --checkpoint file")
    ap.add_argument("--retain", choices=("all", "sparse"), default="all",
                    help="feature retention: 'sparse' keeps keyframes + every 4th frame")
    ap.add_argument("--depth-transfer", choices=("float32", "uint16mm", "sparse"),
                    default="float32",
                    help="host->device depth format: 'uint16mm' halves the bytes (1 mm "
                         "steps, clamps beyond 65.5 m); 'sparse' sends only the "
                         "keypoints' depths")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if there is no GPU)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="profile the streaming run into DIR/trace.json and the port's "
                         "spans into DIR/spans.json (slow: keep --limit small)")
    return ap


def run(argv=None) -> RunResult:
    """``main`` with its results: the loader used, the poses and the diagnostics."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = RunConfig.from_yaml(args.config)
    if cfg.visualize_results:
        from vo_tpu_torch.evalkit.plotting import pyplot

        pyplot()                       # without matplotlib, fail before the run
    extractor = build_extractor(cfg)
    K = cfg.camera_intrinsic_matrix

    sparse = args.depth_transfer == "sparse"
    nat = NativeRGBDSequence.try_open(cfg.image_path) if cfg.image_path else None
    if nat is not None:
        n = min(len(nat), args.limit) if args.limit else len(nat)
        batches = nat.iter_batches(cfg.extraction_batch, limit=n, gray=sparse,
                                   depth="u16mm" if sparse else "f32")
        loader = "native"
    else:
        seq = RGBDSequence.from_dir(cfg.image_path)
        n = min(len(seq), args.limit) if args.limit else len(seq)
        batches = seq.iter_batches(cfg.extraction_batch, limit=n)
        loader = "pil"
    if n == 0:
        print(f"no (*.png, *_depth.npy) pairs under {cfg.image_path!r}", file=sys.stderr)
        return RunResult(rc=2, loader=loader)
    print(f"[vo_tpu_torch] {n} frames from {cfg.image_path} ({loader} loader, streaming "
          f"batches of {cfg.extraction_batch}, depth transfer {args.depth_transfer}, "
          f"on {dev})")

    stats: dict = {}
    t0 = time.perf_counter()
    try:
        with profiling.trace(args.trace) if args.trace else contextlib.nullcontext():
            poses, diag, (feats, kp3d, feat_rows) = run_offline_vo_streaming(
                batches, n, K, vo_config=cfg.vo, extractor=extractor,
                checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
                resume_from=args.resume, retain=args.retain,
                transfer_depth=args.depth_transfer, device=dev, stats=stats)
    finally:
        if nat is not None:
            nat.close()
    dt = time.perf_counter() - t0
    print(f"[vo_tpu_torch] {n} frames in {dt:.2f}s = {n / dt:.1f} fps io-included "
          f"(accept rate {np.mean(diag.accepted):.2f}, mean inliers "
          f"{np.mean(diag.n_inliers):.0f}; waited {stats['queue_wait_s']:.3f}s on the "
          f"loader)")

    odometry, info = poses, None
    if args.refine:
        t1 = time.perf_counter()
        poses, info = refine_poses(poses, feats, kp3d, K, diag,
                                   feat_rows=None if args.retain == "all" else feat_rows,
                                   save_odometry=args.save_odometry, device=dev)
        print(f"[refine] done in {time.perf_counter() - t1:.2f}s")

    out = cfg.output_filename
    save_poses_npy(out, poses)
    print(f"[vo_tpu_torch] wrote {out if out.endswith('.npy') else out + '.npy'}")

    gt = None
    if cfg.gt_txt_file_path and (args.eval or cfg.visualize_results):
        gt = load_poses_txt(kitti_gt_to_modified_txt(cfg.gt_txt_file_path))

    if cfg.visualize_results:
        viz_dir = (out[:-4] if out.endswith(".npy") else out) + "_viz"
        write_visualizations(viz_dir, cfg.image_path, feats, cfg.vo, poses, gt=gt,
                             feat_rows=None if args.retain == "all" else feat_rows)

    if args.eval and gt is not None:
        res = KittiOdomEvaluator().evaluate(gt, poses)
        print(f"[eval] seg trans {res.seg_trans_err_pct:.2f}%  "
              f"seg rot {res.seg_rot_err_deg_per_100m:.3f} deg/100m  "
              f"ATE/dist {res.ate_over_dist:.2f}  RPE {res.rpe_trans:.4f}  "
              f"rot/dist {res.rpe_rot_over_dist:.4f}  dist {res.total_distance:.1f} m")
    return RunResult(rc=0, loader=loader, poses=poses, diag=diag, odometry=odometry,
                     refine=info,
                     features=(feats, kp3d, feat_rows) if args.refine else None)


def main(argv=None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    raise SystemExit(main())
