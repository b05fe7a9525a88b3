"""Offline RGB-D VO runner: port of ``vo_tpu/runners/vo_run.py``.

Usage:
    python -m vo_tpu_torch.runners.vo_run --config cfg.yaml               # on the GPU
    python -m vo_tpu_torch.runners.vo_run --config cfg.yaml --eval        # + score vs GT
    python -m vo_tpu_torch.runners.vo_run --config cfg.yaml --refine      # BA + pose graph
    python -m vo_tpu_torch.runners.vo_run --config cfg.yaml --device cpu

Reads *.png + *_depth.npy pairs from ``image_path`` in fixed-size batches: the native
C++ loader (``native/vo_loader.cpp``, built into ``vo_tpu_torch/_build/`` at first use)
when it opens the directory, the PIL reader otherwise; decode overlaps the device's
work (``run_offline_vo_streaming``). Optionally refines the trajectory (``--refine``:
``engine/refine.py::refine_full``, windowed BA and loop closure), writes
``<output_filename>.npy`` (stacked 4x4 poses) and evaluates against
``gt_txt_file_path``.

``feature_extractor`` is ``orb``, ``sift`` or ``surf`` (box-filter Hessian + SURF-64,
matched in fp32). Not ported yet, and refused before any frame is read:
``visualize_results: true`` (ROADMAP queue 1 item 13) and ``r2d2`` (item 8).
"""

from __future__ import annotations

import argparse
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
        raise NotImplementedError("feature_extractor 'r2d2' is not ported yet (ROADMAP "
                                  "queue 1, item 8: R2D2)")
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
    return ap


def run(argv=None) -> RunResult:
    """``main`` with its results: the loader used, the poses and the diagnostics."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = RunConfig.from_yaml(args.config)
    if cfg.visualize_results:
        raise NotImplementedError("visualize_results: true is not ported yet (ROADMAP "
                                  "queue 1, item 13: evalkit/plotting.py)")
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

    if args.eval and cfg.gt_txt_file_path:
        gt = load_poses_txt(kitti_gt_to_modified_txt(cfg.gt_txt_file_path))
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
