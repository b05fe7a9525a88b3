"""Hold the port against the JAX package on the loop workload at full size: the same
odometry and features through both packages' ``refine_full``, both packages' engines
over the card's features, and both packages' extractors on the same frames.

    python tests/refine_reference.py save loop.npz      # on the GPU; imports no JAX
    python tests/refine_reference.py compare loop.npz   # on the CPU; both packages
    python tests/refine_reference.py engine loop.npz    # on the CPU; both packages
    python tests/refine_reference.py extract loop.npz   # on the CPU; both packages
    python tests/refine_reference.py timing loop.npz OTHER_TREE   # on the GPU

``save`` renders the 240-frame loop workload of ``bench.py:478-576`` (376 x 1232, the
KITTI intrinsics) in a pool of processes, runs the port's ``run_offline_vo`` with the
main config (``OrbLikeExtractor(max_kp=2048)``, ``ratio_binary``, 512 hypotheses) on
the card and writes the odometry, the per-frame diagnostics and the features (the +-1
descriptors as packed bits, ~19 MB) to an npz.

``compare`` loads it, detects loop closures and runs ``refine_full`` (adaptive
branch) with each package on the CPU, and prints, for each, the loop edges with their
inlier counts and bench.py's refine-block metrics (seg-trans, seg-rot, end drift,
ATE) before and after, then the largest differences between the two packages.

``engine`` runs both packages' ``VOEngine`` (the main config) over the saved features on
the CPU and prints, against each other and against the card's run, the first frame
whose diagnostics (accepted, matches, inliers) differ, the largest pose difference, and
each odometry's seg-trans, seg-rot and heading residual (the median rotation residual
of the loop edges that the port's detector verifies on it, which decides
``refine_full``'s branch).

``extract`` renders the first 8 frames as ``save`` does and runs both packages'
``OrbLikeExtractor(max_kp=2048)`` on the CPU; it prints the agreement of keypoints
(same pixel at the same index) and descriptor bits, between the packages and against
the card's features in the npz.

Together these place a full-size difference between the card's odometry and the JAX
package's in extraction, in the engine, or in the platform's arithmetic.

``timing`` builds the global bundle-adjustment problem of the saved run once (97
keyframes, the loop edges) and times, on the card, its solve (``bundle_adjust``,
median of 5 warm calls) and a warm ``refine_full`` with this checkout's port and with
another checkout's (``OTHER_TREE``, e.g. the parent commit unpacked with ``git
archive``), in turns: other, this, this, other, each in a process of its own.
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


def _render(traj):
    """The loop workload's frames at 376 x 1232, rendered in a pool of processes."""
    from vo_tpu_torch.utils.synthetic import default_world, render_rgbd

    world = default_world(half_width=14.0, fine_amp=1.0)
    with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        return pool.starmap(render_rgbd, [(T, K, 376, 1232, world) for T in traj])


def save(path: str) -> None:
    import torch

    from vo_tpu_torch.engine.pipeline import run_offline_vo
    from vo_tpu_torch.engine.vo import VOConfig
    from vo_tpu_torch.estimation.pnp import PnPConfig
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.utils.synthetic import loop_trajectory

    t0 = time.perf_counter()
    frames = _render(loop_trajectory(**LOOP))
    print(f"rendered {len(frames)} frames in {time.perf_counter() - t0:.1f} s")
    poses, diag, (feats, kp3d) = run_offline_vo(
        np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]), K,
        vo_config=VOConfig(matcher="ratio_binary", pnp=PnPConfig(n_hypotheses=512)),
        extractor=OrbLikeExtractor(max_kp=2048), extraction_batch=16,
        return_features=True)
    np.savez_compressed(
        path, poses=poses, promoted=diag.promoted_keyframe, accepted=diag.accepted,
        n_matches=diag.n_matches, n_inliers=diag.n_inliers, kp=feats.kp.cpu().numpy(),
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


def _jax_cpu():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")


def _heading_residual(poses, promoted, port_feats):
    """The median loop rotation residual (deg) of ``poses``, on the loop edges the
    port's detector verifies on them (``refine_full``'s branch probe)."""
    from vo_tpu_torch.engine import loop_closure as tloop
    from vo_tpu_torch.engine import refine as tref

    kfs = tref._select_keyframes(promoted, len(poses))
    edges = tloop.detect_loop_closures(kfs, poses, *port_feats, K, device="cpu")
    return tref.loop_rotation_discrepancy_deg(poses, kfs, edges), len(edges)


def engine(path: str) -> None:
    _jax_cpu()
    import jax.numpy as jnp
    import torch

    from vo_tpu.engine.vo import VOConfig as JVOConfig
    from vo_tpu.engine.vo import VOEngine as JEngine
    from vo_tpu.estimation.pnp import PnPConfig as JPnPConfig
    from vo_tpu_torch.engine.vo import VOConfig, VOEngine
    from vo_tpu_torch.estimation.pnp import PnPConfig
    from vo_tpu_torch.evalkit import KittiOdomEvaluator
    from vo_tpu_torch.utils.synthetic import loop_trajectory

    d = np.load(path)
    print(f"features from {path} (run on {d['card']})")
    gt = np.asarray(loop_trajectory(**LOOP), np.float64)
    bits = np.unpackbits(d["desc_bits"], axis=-1).astype(np.float32) * 2.0 - 1.0
    desc = torch.from_numpy(bits).to(torch.bfloat16)
    del bits
    port = (torch.from_numpy(d["kp"]), desc, torch.from_numpy(d["valid"]),
            torch.from_numpy(d["kp3d"]))
    runs = {"card (port)": (d["poses"], {k: d[k] for k in ("accepted", "n_matches",
                                                            "n_inliers")})}
    t0 = time.perf_counter()
    poses, diag = VOEngine(VOConfig(matcher="ratio_binary", pnp=PnPConfig(n_hypotheses=512)),
                           device="cpu").run_sequence(*port, torch.from_numpy(K))
    runs["port, CPU"] = (poses.numpy(), {k: getattr(diag, k).numpy()
                                         for k in ("accepted", "n_matches", "n_inliers")})
    print(f"port engine on the CPU: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    jdesc = jnp.asarray(desc.view(torch.int16).numpy()).view(jnp.bfloat16)
    jposes, jdiag = JEngine(JVOConfig(matcher="ratio_binary",
                                      pnp=JPnPConfig(n_hypotheses=512))).run_sequence(
        jnp.asarray(d["kp"]), jdesc, jnp.asarray(d["valid"]), jnp.asarray(d["kp3d"]),
        jnp.asarray(K))
    runs["JAX, CPU"] = (np.asarray(jposes), {k: np.asarray(getattr(jdiag, k))
                                             for k in ("accepted", "n_matches",
                                                       "n_inliers")})
    print(f"JAX engine on the CPU: {time.perf_counter() - t0:.1f} s")
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            (pa, da), (pb, db) = runs[a], runs[b]
            differ = np.zeros(len(da["accepted"]), bool)
            for k in da:
                differ |= np.asarray(da[k]) != np.asarray(db[k])
            first = int(np.argmax(differ)) + 1 if differ.any() else None
            dt = np.abs(pa[:, :3, 3] - pb[:, :3, 3]).max(axis=1)
            print(f"{a} against {b}: {int(differ.sum())} frames with other diagnostics, "
                  f"the first frame {first} (inliers "
                  f"{None if first is None else (int(da['n_inliers'][first - 1]), int(db['n_inliers'][first - 1]))}); "
                  f"largest pose difference {dt.max():.4f} m at frame {int(dt.argmax())}, "
                  f"poses identical up to frame {int(np.argmax(dt > 0)) if (dt > 0).any() else len(dt)}")
    for name, (poses, diag) in runs.items():
        r = KittiOdomEvaluator().evaluate(gt, poses)
        res, n_edges = _heading_residual(poses, d["promoted"], port)
        print(f"{name}: seg_trans {r.seg_trans_err_pct:.4f} %, seg_rot "
              f"{r.seg_rot_err_deg_per_100m:.4f} deg/100m, accept "
              f"{float(np.mean(diag['accepted'])):.3f}, heading residual {res:.4f} deg "
              f"over {n_edges} loop edges, drift "
              f"{np.linalg.norm(poses[-1, :3, 3] - gt[-1, :3, 3]):.4f} m")


def extract(path: str, n: int = 8) -> None:
    _jax_cpu()
    import jax.numpy as jnp

    from vo_tpu.features.extractor import OrbLikeExtractor as JOrb
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.utils.synthetic import loop_trajectory

    d = np.load(path)
    imgs = np.stack([f[0] for f in _render(loop_trajectory(**LOOP)[:n])])
    t = OrbLikeExtractor(max_kp=2048)(imgs, device="cpu")
    j = JOrb(max_kp=2048)(jnp.asarray(imgs))
    card = {"kp": d["kp"][:n], "valid": d["valid"][:n],
            "desc": np.unpackbits(d["desc_bits"][:n], axis=-1).astype(np.float32) * 2 - 1}
    sets = {"port, CPU": {"kp": t.kp.numpy(), "valid": t.valid.numpy(),
                          "desc": t.desc.float().numpy()},
            "JAX, CPU": {"kp": np.asarray(j.kp), "valid": np.asarray(j.valid),
                         "desc": np.asarray(j.desc, np.float32)},
            "card (port)": card}
    names = list(sets)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            A, B = sets[a], sets[b]
            same_kp = (A["kp"] == B["kp"]).all(-1) & (A["valid"] == B["valid"])
            both = same_kp & A["valid"]
            bits = (A["desc"] == B["desc"]).all(-1)[both].mean() if both.any() else 0.0
            bit_share = (A["desc"] == B["desc"])[both].mean() if both.any() else 0.0
            print(f"{a} against {b}, {n} frames at 376 x 1232: keypoints at the same index "
                  f"{same_kp.mean() * 100:.3f} % (per frame "
                  f"{[int(x) for x in same_kp.sum(1)]} of 2048), valid counts "
                  f"{[int(x) for x in A['valid'].sum(1)]} / "
                  f"{[int(x) for x in B['valid'].sum(1)]}; descriptor bits equal "
                  f"{bit_share * 100:.4f} %, whole descriptors equal {bits * 100:.3f} %")


def timing(path: str, other: str) -> None:
    import subprocess

    import torch

    from vo_tpu_torch.engine import loop_closure as tloop
    from vo_tpu_torch.engine import refine as tref

    d = np.load(path)
    bits = np.unpackbits(d["desc_bits"], axis=-1).astype(np.float32) * 2.0 - 1.0
    dev = torch.device("cuda")
    feats = (torch.from_numpy(d["kp"]).to(dev), torch.from_numpy(bits).to(dev, torch.bfloat16),
             torch.from_numpy(d["valid"]).to(dev), torch.from_numpy(d["kp3d"]).to(dev))
    del bits
    poses, promoted = d["poses"], d["promoted"]
    host = tref._host_features(poses, feats[0], feats[2], feats[3])
    kfs = tref._select_keyframes(promoted, len(poses))
    cfg = tref.RefineConfig()
    edges = tloop.detect_loop_closures(kfs, poses, *feats, K, device=dev)
    all_pairs = tref._all_adjacent_pair_matches(kfs, host[1], feats[1], host[2], host[3],
                                                host[4], K, cfg, dev)
    loop_pairs = [(a, b) for a, b, _, _ in edges]
    loop_matches = tref._loop_pair_matches(kfs[[a for a, _ in loop_pairs]],
                                           kfs[[b for _, b in loop_pairs]], host[1],
                                           feats[1], host[2], host[3], host[4], K, cfg, dev)
    prob = tref._build_global_problem(kfs, host[0], host[1], feats[1], host[2], host[3],
                                      host[4], K, cfg, kfs, all_pairs, loop_pairs,
                                      loop_matches, device=dev)
    prob_path = os.path.splitext(path)[0] + "_global_ba.npz"
    np.savez(prob_path, **{k: v.cpu().numpy() for k, v in prob._asdict().items()
                           if v is not None})
    print(f"global problem: P {prob.poses.shape[0]}, L {prob.points.shape[0]}, M "
          f"{prob.obs_lm.shape[1]}, {len(edges)} loop edges -> {prob_path}")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for tree in (other, here, here, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "_time_tree", path,
                              prob_path, tree], capture_output=True, text=True, timeout=900)
        print(out.stdout.strip() or out.stderr[-2000:])


def _time_tree(path: str, prob_path: str, tree: str) -> None:
    """One turn of ``timing``: ``tree``'s port on the card."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import vo_tpu_torch
    from vo_tpu_torch.ba import BAConfig, BAProblem, bundle_adjust
    from vo_tpu_torch.engine.refine import refine_full

    dev = torch.device("cuda")
    with np.load(prob_path) as p:
        prob = BAProblem(**{k: torch.from_numpy(p[k]).to(dev) for k in p.files})
    ts = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, info = bundle_adjust(prob, BAConfig(), device=dev)
        float(info["final_cost"])
        ts.append(time.perf_counter() - t0)
    d = np.load(path)
    bits = np.unpackbits(d["desc_bits"], axis=-1).astype(np.float32) * 2.0 - 1.0
    args = (torch.from_numpy(d["kp"]).to(dev), torch.from_numpy(bits).to(dev, torch.bfloat16),
            torch.from_numpy(d["valid"]).to(dev), torch.from_numpy(d["kp3d"]).to(dev))
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refine_full(d["poses"], *args, K, diag_promoted=d["promoted"], device=dev)
        walls.append(time.perf_counter() - t0)
    print(f"{os.path.dirname(vo_tpu_torch.__file__)} on {torch.cuda.get_device_name(0)}: "
          f"global BA solve median {np.median(ts[1:]) * 1e3:.2f} ms (warm calls "
          f"{[round(t * 1e3, 2) for t in ts[1:]]}), refine_full cold {walls[0]:.3f} s, "
          f"warm {walls[1]:.3f} s")


MODES = {"save": save, "compare": compare, "engine": engine, "extract": extract}

if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "timing":
        timing(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 5 and sys.argv[1] == "_time_tree":
        _time_tree(*sys.argv[2:])
    elif len(sys.argv) == 3 and sys.argv[1] in MODES:
        MODES[sys.argv[1]](sys.argv[2])
    else:
        raise SystemExit(__doc__)
