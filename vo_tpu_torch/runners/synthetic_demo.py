"""Self-contained demo: render a synthetic RGB-D drive, run the full VO pipeline,
score against exact ground truth. No dataset required. Port of
``vo_tpu/runners/synthetic_demo.py``.

    python -m vo_tpu_torch.runners.synthetic_demo [--frames 48] [--hw 240 320] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.engine.pipeline import run_offline_vo
from vo_tpu_torch.engine.vo import VOConfig
from vo_tpu_torch.estimation.pnp import PnPConfig
from vo_tpu_torch.evalkit import KittiOdomEvaluator
from vo_tpu_torch.features.extractor import OrbLikeExtractor
from vo_tpu_torch.utils.synthetic import render_sequence


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--hw", type=int, nargs=2, default=(240, 320))
    ap.add_argument("--max-kp", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if there is no GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    H, W = args.hw
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32)
    print(f"[demo] rendering {args.frames} frames at {H}x{W} ...")
    imgs, deps, gt = render_sequence(args.frames, K, H=H, W=W, step=0.8, yaw_rate=0.01)

    cfg = VOConfig(matcher="ratio_binary", kf_min_matches=60, kf_min_inliers=30,
                   pnp=PnPConfig(min_inliers=15, n_hypotheses=256))
    t0 = time.time()
    poses, diag = run_offline_vo(imgs, deps, K, vo_config=cfg,
                                 extractor=OrbLikeExtractor(max_kp=args.max_kp),
                                 device=dev)
    dt = time.time() - t0
    err = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    res = KittiOdomEvaluator().evaluate(gt, poses)
    print(f"[demo] {args.frames} frames in {dt:.2f}s = {args.frames / dt:.1f} fps")
    print(f"[demo] final drift {err[-1]:.3f} m, median {np.median(err):.3f} m over "
          f"{res.total_distance:.1f} m | RPE {res.rpe_trans:.4f} | accept "
          f"{np.mean(diag.accepted):.2f} | mean inliers {np.mean(diag.n_inliers):.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
