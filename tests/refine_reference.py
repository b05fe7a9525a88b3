"""Hold the port's refinement against the JAX package's on the loop workload at full
size: the same odometry and features through both packages' ``refine_full``.

    python tests/refine_reference.py save loop.npz      # on the GPU; imports no JAX
    python tests/refine_reference.py compare loop.npz   # on the CPU; both packages

``save`` renders the 240-frame loop workload of ``bench.py:478-576`` (376 x 1232, the
KITTI intrinsics) in a pool of processes, runs the port's ``run_offline_vo`` with the
main config (``OrbLikeExtractor(max_kp=2048)``, ``ratio_binary``, 512 hypotheses) on
the card and writes the odometry, the keyframe flags and the features (the +-1
descriptors as packed bits, ~19 MB) to an npz.

``compare`` loads it, detects loop closures and runs ``refine_full`` (adaptive
branch) with each package on the CPU, and prints, for each, the loop edges with their
inlier counts and bench.py's refine-block metrics (seg-trans, seg-rot, end drift,
ATE) before and after, then the largest differences between the two packages.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K = np.array([[721.53, 0.0, 609.55], [0.0, 721.53, 172.85], [0.0, 0.0, 1.0]], np.float32)
LOOP = dict(out_frames=64, turn_frames=56, step=0.8, turn_step=0.22)   # bench.py:497-498


def save(path: str) -> None:
    import torch

    from vo_tpu_torch.engine.pipeline import run_offline_vo
    from vo_tpu_torch.engine.vo import VOConfig
    from vo_tpu_torch.estimation.pnp import PnPConfig
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.utils.synthetic import default_world, loop_trajectory, render_rgbd

    world = default_world(half_width=14.0, fine_amp=1.0)
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        frames = pool.starmap(render_rgbd, [(T, K, 376, 1232, world)
                                            for T in loop_trajectory(**LOOP)])
    print(f"rendered {len(frames)} frames in {time.perf_counter() - t0:.1f} s")
    poses, diag, (feats, kp3d) = run_offline_vo(
        np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]), K,
        vo_config=VOConfig(matcher="ratio_binary", pnp=PnPConfig(n_hypotheses=512)),
        extractor=OrbLikeExtractor(max_kp=2048), extraction_batch=16,
        return_features=True)
    np.savez_compressed(
        path, poses=poses, promoted=diag.promoted_keyframe, kp=feats.kp.cpu().numpy(),
        desc_bits=np.packbits((feats.desc > 0).cpu().numpy(), axis=-1),
        valid=feats.valid.cpu().numpy(), kp3d=kp3d.cpu().numpy(),
        card=torch.cuda.get_device_name(0))
    print(f"wrote {path}")


def _scores(name, gt, poses):
    from vo_tpu_torch.evalkit import KittiOdomEvaluator

    r = KittiOdomEvaluator().evaluate(gt, poses)
    print(f"  {name}: seg_trans {r.seg_trans_err_pct:.4f} %, seg_rot "
          f"{r.seg_rot_err_deg_per_100m:.4f} deg/100m, drift "
          f"{np.linalg.norm(poses[-1, :3, 3] - gt[-1, :3, 3]):.4f} m, ATE "
          f"{np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1).mean():.4f} m")


def compare(path: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from vo_tpu.engine import loop_closure as jloop
    from vo_tpu.engine import refine as jref
    from vo_tpu_torch.engine import loop_closure as tloop
    from vo_tpu_torch.engine import refine as tref
    from vo_tpu_torch.utils.synthetic import loop_trajectory

    d = np.load(path)
    print(f"odometry and features from {path} (run on {d['card']})")
    gt = np.asarray(loop_trajectory(**LOOP), np.float64)
    bits = np.unpackbits(d["desc_bits"], axis=-1).astype(np.float32) * 2.0 - 1.0
    port = (d["kp"], torch.from_numpy(bits).to(torch.bfloat16), d["valid"], d["kp3d"])
    ref = (jnp.asarray(d["kp"]), jnp.asarray(bits, jnp.bfloat16), jnp.asarray(d["valid"]),
           jnp.asarray(d["kp3d"]))
    poses, promoted = d["poses"], d["promoted"]
    kfs = tref._select_keyframes(promoted, len(poses))
    edges = {"port": tloop.detect_loop_closures(kfs, poses, *port, K, device="cpu"),
             "jax": jloop.detect_loop_closures(kfs, poses, *ref, K)}
    closed = {}
    for name, fn, args, kw in (("port", tref.refine_full, port, {"device": "cpu"}),
                               ("jax", jref.refine_full, ref, {})):
        t0 = time.perf_counter()
        closed[name], info = fn(poses, *args, K, diag_promoted=promoted, **kw)
        print(f"{name}: {time.perf_counter() - t0:.1f} s, {len(info['keyframes'])} "
              f"keyframes, {info['loop_edges']} loop edges, heading residual "
              f"{info['loop_rot_disc_deg']:.4f} deg, ran_ba {info['ran_ba']}; edges "
              f"(a, b, inliers) {[(a, b, n) for a, b, _, n in edges[name]]}")
        _scores("odometry", gt, poses)
        _scores("refine_full", gt, closed[name])
    for (a, b, Z, n), (_, _, jZ, jn) in zip(edges["port"], edges["jax"]):
        if n != jn or np.abs(Z - jZ).max() > 1e-3:
            print(f"edge ({a}, {b}): inliers {n} against {jn}, Z "
                  f"{np.abs(Z[:3, 3] - jZ[:3, 3]).max():.4f} m apart")
    print(f"closed poses, port against JAX: "
          f"{np.abs(closed['port'][:, :3, 3] - closed['jax'][:, :3, 3]).max():.4f} m")
    same = tloop.optimize_with_loops(poses, kfs, edges["jax"],
                                     tloop.LoopClosureConfig(loop_weight=1.0), device="cpu")[0]
    jsame = jloop.optimize_with_loops(poses, kfs, edges["jax"],
                                      jloop.LoopClosureConfig(loop_weight=1.0))[0]
    print(f"pose graphs on JAX's edges, port against JAX: "
          f"{np.abs(same[:, :3, 3] - jsame[:, :3, 3]).max():.2e} m")


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("save", "compare"):
        raise SystemExit(__doc__)
    (save if sys.argv[1] == "save" else compare)(sys.argv[2])
