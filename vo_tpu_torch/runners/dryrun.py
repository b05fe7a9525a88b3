"""The distributed dry run: the counterpart of ``__graft_entry__.py``.

    python -m vo_tpu_torch.runners.dryrun --nprocs 1 --backend nccl          # the card
    python -m vo_tpu_torch.runners.dryrun --nprocs 4 --backend gloo --device cpu

``entry`` is the one-device forward step (extraction + back-projection) with its
example inputs. ``dryrun_multichip`` runs, over ``n_ranks`` ranks of one group and in
the JAX dry run's order:

1. inference: frames split over ``data`` (``shard_frames``) through extraction,
   back-projection and consecutive-frame matching (``ratio_match_fused``: the wgmma
   kernel on the card); the pair that crosses into the next data row takes that row's
   first frame through an ``all_gather``. Held to the same steps in one process;
2. training: the data-parallel ``train_step_batch`` on a batch made once and split
   over ``data``, with the per-rank batch, the gradient all-reduce and the loss held
   against the step in one process on the whole batch (the JAX dry run's 1e-3
   relative gate), and every rank's new state equal;
3. BA: ``bundle_adjust_sharded`` over a one-axis ``kf`` mesh of every rank against
   ``bundle_adjust`` on the JAX dry run's problem (0.5 px noise, so the cost floor is
   not zero), with the collectives and bytes per iteration and the per-rank FLOPs of
   both (``FlopCounterMode``), which must be below the single solve's on more than
   one rank;
4. the time per sharded and per single solve on this device at the production window
   (64 keyframes x 512 observations, 8192 landmarks), a consistent noisy problem.

The JAX dry run's TPU interconnect projection is not carried over. The report is
printed as one JSON line and written to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from vo_tpu_torch import prng
from vo_tpu_torch.ba import BAConfig, bundle_adjust
from vo_tpu_torch.ba.distributed import bundle_adjust_sharded
from vo_tpu_torch.device import resolve_device, to_device
from vo_tpu_torch.engine.pipeline import extract_and_backproject
from vo_tpu_torch.features.extractor import OrbLikeExtractor
from vo_tpu_torch.models.patchnet import FAST_QUAD_L2NET_CONFCFS, apply_patchnet
from vo_tpu_torch.ops.match import ratio_match_fused
from vo_tpu_torch.parallel import comm, launch, make_mesh, make_mesh_1d, shard_frames
from vo_tpu_torch.port_state import ba_problem_from_numpy
from vo_tpu_torch.train import trainer
from vo_tpu_torch.train.losses import r2d2_loss
from vo_tpu_torch.train.pairs import synthetic_pair_batch

K_ENTRY = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
K_DRY = np.array([[130.0, 0.0, 80.0], [0.0, 130.0, 60.0], [0.0, 0.0, 1.0]], np.float32)
RATIO = 0.85
WINDOW = (64, 512, 8192)      # keyframes, observations per keyframe, landmarks
BA_ITERATIONS = 4
TIMED_SOLVES = 3              # timed solves of each form in the dry run


def entry(device=None):
    """(fn, example_args): the batched extraction + keypoint back-projection step of
    ``OrbLikeExtractor(max_kp=512)`` and four 240 x 320 random frames, on ``device``."""
    dev = resolve_device(device)
    extractor = OrbLikeExtractor(max_kp=512)
    K = torch.from_numpy(K_ENTRY).to(dev)

    def fn(images, depths):
        feats, kp3d = extract_and_backproject(extractor, images, depths, K)
        return feats.kp, feats.desc, feats.valid, kp3d

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 255, (4, 240, 320)).astype(np.float32))
    depths = torch.from_numpy(rng.uniform(1, 50, (4, 240, 320)).astype(np.float32))
    return fn, (images.to(dev), depths.to(dev))


def _match_consecutive(desc_a, desc_b, valid_a, valid_b):
    """Frame i of ``desc_a`` against frame i of ``desc_b``: (idx, mask), (n, N) each."""
    res = [ratio_match_fused(a, b, va, vb, ratio=RATIO, binary_dim=a.shape[-1])
           for a, b, va, vb in zip(desc_a, desc_b, valid_a, valid_b)]
    if not res:
        n = desc_a.shape[1]
        return (torch.zeros((0, n), dtype=torch.int64, device=desc_a.device),
                torch.zeros((0, n), dtype=torch.bool, device=desc_a.device))
    return torch.stack([r.idx for r in res]), torch.stack([r.mask for r in res])


def inference_rank(rank, images, depths, K, max_kp=256, border=21, n_model=1) -> dict:
    """Data-parallel extraction + back-projection and consecutive-frame matching of
    this rank's block of ``images`` / ``depths`` (the whole arrays, numpy).

    Returns this rank's features (kp, desc, valid, kp3d), ``pair0`` (the global index
    of its first pair), the (idx, mask) of its pairs (its frames with their
    successors; the last with the next data row's first frame) and ``n_matches`` over
    every data row."""
    mesh = make_mesh(n_model=n_model)
    dev = resolve_device(mesh.device_type)
    data = mesh.get_group("data")
    n_data, row = dist.get_world_size(data), mesh.get_local_rank("data")
    imgs, deps = (to_device(a, dev) for a in shard_frames(mesh, images, depths))
    feats, kp3d = extract_and_backproject(OrbLikeExtractor(max_kp=max_kp, border=border),
                                          imgs, deps, to_device(K, dev))
    desc_b, valid_b = feats.desc[1:], feats.valid[1:]
    if n_data > 1:
        first_desc = comm.all_gather(feats.desc[:1], data, "first frame descriptors")
        first_valid = comm.all_gather(feats.valid[:1], data, "first frame validity")
        if row + 1 < n_data:
            desc_b = torch.cat([desc_b, first_desc[row + 1:row + 2]])
            valid_b = torch.cat([valid_b, first_valid[row + 1:row + 2]])
    idx, mask = _match_consecutive(feats.desc, desc_b, feats.valid, valid_b)
    n_matches = comm.all_reduce(mask.sum().reshape(1), data, "match count")
    return {"kp": feats.kp, "desc": feats.desc.float(), "valid": feats.valid, "kp3d": kp3d,
            "pair0": row * imgs.shape[0], "idx": idx, "mask": mask, "n_matches": n_matches[0]}


def reference_inference(images, depths, K, max_kp=256, border=21, device=None) -> dict:
    """The same steps in one process over every frame."""
    dev = resolve_device(device)
    feats, kp3d = extract_and_backproject(OrbLikeExtractor(max_kp=max_kp, border=border),
                                          to_device(images, dev), to_device(depths, dev),
                                          to_device(K, dev))
    idx, mask = _match_consecutive(feats.desc[:-1], feats.desc[1:], feats.valid[:-1],
                                   feats.valid[1:])
    return {"kp": feats.kp, "desc": feats.desc.float(), "valid": feats.valid, "kp3d": kp3d,
            "idx": idx, "mask": mask}


def _rank_state(mesh, spec, cfg, leaves, batch):
    """(device, data group, state of ``leaves``, this rank's block of ``batch``)."""
    dev = resolve_device(mesh.device_type)
    state = trainer.state_from_leaves(trainer.create_train_state(spec, cfg, device=dev),
                                      [to_device(a, dev) for a in leaves])
    local = tuple(to_device(a, dev) for a in shard_frames(mesh, *batch))
    return dev, mesh.get_group("data"), state, local


def train_rank(rank, spec, cfg, leaves, batch, n_model=1, timed_steps=0) -> dict:
    """One data-parallel ``train_step_batch`` on this rank's block of ``batch`` (the
    whole (img1, img2, flow, mask) batch, numpy) from the state of ``leaves`` (numpy, in
    ``trainer._state_leaves`` order).

    Returns the new state (``state/<i>``), the metrics, ``batch_per_rank``, the
    all-reduces of the step by label and, with ``timed_steps``, the median ms of that
    many further steps from the same state and batch (``ms_per_step``) and of as many
    steps with no group on this rank's share (``ms_per_step_local``), in turns."""
    dev, group, state, local = _rank_state(make_mesh(n_model=n_model), spec, cfg, leaves,
                                           batch)
    comm.COUNTS.reset()
    new_state, metrics = trainer.train_step_batch(state, local, spec, cfg, group=group)
    all_reduces = {label: [n, comm.COUNTS.bytes[op, label]]
                   for (op, label), n in comm.COUNTS.calls.items() if op == "all_reduce"}
    out = {f"state/{i}": t for i, (_, t) in enumerate(trainer._state_leaves(new_state))}
    out.update(metrics)
    out.update(batch_per_rank=local[0].shape[0], all_reduces=json.dumps(all_reduces))
    if timed_steps:
        out.update(_timed_in_turns(
            {"ms_per_step": lambda: trainer.train_step_batch(state, local, spec, cfg, group),
             "ms_per_step_local": lambda: trainer.train_step_batch(state, local, spec, cfg)},
            dev, timed_steps))
    return out


def bn_moments_rank(rank, spec, cfg, leaves, batch) -> dict:
    """The train-mode BatchNorm moments of this rank's block of ``batch``'s first images
    over the data group (``bn_mean/<l>``, ``bn_var/<l>``) and on their own
    (``local_mean/<l>``, ``local_var/<l>``: what per-rank BatchNorm uses), and
    ``local_bn_total``, the loss with the rank-local moments, averaged over the ranks."""
    _, group, state, (img1, img2, flow, mask) = _rank_state(make_mesh(), spec, cfg, leaves,
                                                            batch)
    dt = trainer._leaves(state.params)[0].dtype
    with torch.no_grad():
        x1, x2 = (trainer._normalize(x.to(dt)) for x in (img1, img2))
        shared = apply_patchnet(state.params, spec, x1, train=True, compute_dtype=dt,
                                group=group)
        own = [apply_patchnet(state.params, spec, x, train=True, compute_dtype=dt)
               for x in (x1, x2)]
        total = r2d2_loss(*own, flow, mask, w_cosim=cfg.w_cosim, w_peaky=cfg.w_peaky,
                          w_ap=cfg.w_ap, stride=cfg.sample_stride, sampler=cfg.sampler)[0]
    out = {}
    for l, ((m, v), (lm, lv)) in enumerate(zip(shared["bn_stats"], own[0]["bn_stats"])):
        out.update({f"bn_mean/{l}": m, f"bn_var/{l}": v, f"local_mean/{l}": lm,
                    f"local_var/{l}": lv})
    out["local_bn_total"] = (comm.all_reduce(total.reshape(1), group, "metrics")[0]
                             / dist.get_world_size(group))
    return out


def noisy_problem(P: int, L: int, M: int, seed: int, reach: float | None = None) -> dict:
    """The JAX dry run's BA problem (``__graft_entry__.py:130-153``): cameras 0.3 m
    apart along x looking down z at landmarks 6-20 m away, 0.5 px noise on the
    observations, the landmarks' start 0.05 m off. With ``reach`` the landmarks span
    the whole path (``reach`` m beyond each end) and each camera observes M of those
    within ``reach`` m of it, so neighbouring cameras share landmarks; without it,
    every camera draws from all of them (the JAX problem, draw for draw)."""
    rng = np.random.default_rng(seed)
    span = 0.3 * (P - 1)
    x = rng.uniform(-5, 5, L) if reach is None else rng.uniform(-reach, span + reach, L)
    points = np.stack([x, rng.uniform(-2, 2, L), rng.uniform(6, 20, L)], -1).astype(np.float32)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (P, 4, 4)).copy()
    poses[:, 0, 3] = -0.3 * np.arange(P)
    if reach is None:
        obs_lm = np.stack([rng.choice(L, M, replace=False) for _ in range(P)])
    else:
        obs_lm = np.stack([rng.choice(np.flatnonzero(np.abs(x - 0.3 * p) < reach), M,
                                      replace=False) for p in range(P)])
    Y = points[obs_lm] + poses[:, None, :3, 3]
    uv = (Y[..., :2] / Y[..., 2:]) * K_DRY[0, 0] + np.array([K_DRY[0, 2], K_DRY[1, 2]])
    uv = uv + rng.normal(0.0, 0.5, uv.shape)
    return dict(poses=poses, points=points + 0.05, obs_lm=obs_lm.astype(np.int32),
                obs_uv=uv.astype(np.float32), obs_valid=np.ones((P, M), bool), K=K_DRY)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_in_turns(fns: dict, dev, repeats: int) -> dict:
    """{name: median ms of ``repeats`` calls} of each callable, called in turns and in
    reversed order every other round (a, b, b, a, ...), so that a drift of the host or
    the card falls on both alike."""
    times = {k: [] for k in fns}
    for i in range(repeats):
        for k in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            _sync(dev)
            t0 = time.perf_counter()
            fns[k]()
            _sync(dev)
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def solve_rank(rank, cases, repeats) -> dict:
    """Sharded solves: case i is (problem arrays, axis, n_model, iterations); axis
    ``kf`` is a one-axis mesh of every rank, any other an axis of the (data, model)
    mesh. For each case, under ``case<i>/``: the sharded result (poses, points, costs,
    final_cost, mean_reproj), whether a second sharded solve gave the same bits,
    the collectives of one solve by label (``collectives``, JSON) and, on the axis's
    rank 0, ``bundle_adjust``'s result (``single_*``); then the median ms of
    ``repeats`` sharded and (on that rank) single solves, timed in turns, the per-rank
    FLOPs of each, and on the card the peak device memory of a sharded solve."""
    out = {}
    for i, (arrays, axis, n_model, iterations) in enumerate(cases):
        mesh = make_mesh_1d(axis) if axis == "kf" else make_mesh(n_model=n_model)
        dev = resolve_device(mesh.device_type)
        cfg = BAConfig(iterations=iterations)
        prob = ba_problem_from_numpy(arrays, dev)
        comm.COUNTS.reset()
        poses, points, info = bundle_adjust_sharded(prob, mesh, cfg, axis)
        collectives = comm.COUNTS.summary()
        again = bundle_adjust_sharded(prob, mesh, cfg, axis)
        same = all(torch.equal(a, b) for a, b in
                   zip((poses, points, info["costs"]), (again[0], again[1], again[2]["costs"])))
        p = f"case{i}/"
        out.update({p + "poses": poses, p + "points": points, p + "costs": info["costs"],
                    p + "final_cost": info["final_cost"],
                    p + "mean_reproj": info["mean_reproj"], p + "repeat_equal": same,
                    p + "collectives": json.dumps(collectives),
                    p + "shards": dist.get_world_size(mesh.get_group(axis))})
        lead = mesh.get_local_rank(axis) == 0
        forms = {p + "ms_sharded": lambda: bundle_adjust_sharded(prob, mesh, cfg, axis)}
        if lead:
            forms[p + "ms_single"] = lambda: bundle_adjust(prob, cfg, device=dev)
        out.update(_timed_in_turns(forms, dev, repeats))
        with FlopCounterMode(display=False) as fc:
            bundle_adjust_sharded(prob, mesh, cfg, axis)
        out[p + "flops_sharded"] = fc.get_total_flops()
        if dev.type == "cuda":
            _sync(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            bundle_adjust_sharded(prob, mesh, cfg, axis)
            out[p + "peak_mib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        if lead:
            with FlopCounterMode(display=False) as fc:
                single = bundle_adjust(prob, cfg, device=dev)
            out.update({p + "single_poses": single[0], p + "single_points": single[1],
                        p + "single_final_cost": single[2]["final_cost"],
                        p + "flops_single": fc.get_total_flops()})
    return out


def dryrun_rank(rank, images, depths, spec, cfg, leaves, batch, cases, n_model):
    """The dry run's work on one rank: inference, the training step and the solves."""
    out = {f"inference/{k}": v for k, v in
           inference_rank(rank, images, depths, K_DRY, 256, 21, n_model).items()}
    out.update({f"train/{k}": v for k, v in
                train_rank(rank, spec, cfg, leaves, batch, n_model).items()})
    out.update(solve_rank(rank, cases, TIMED_SOLVES))
    return out


def _per_iteration(collectives: str, iterations: int) -> dict:
    """{"op label": [calls, bytes]} of a solve -> the same per iteration (the final
    cost's all-reduces included, spread over the iterations)."""
    return {k: [c / iterations, b / iterations] for k, (c, b) in json.loads(collectives).items()}


def dryrun_multichip(n_ranks: int, backend: str = "nccl", device: str = "cuda") -> dict:
    """The dry run over ``n_ranks`` ranks (see the module docstring); raises on any
    failed check. Returns the report."""
    launch.check_backend(backend, device)
    dev = resolve_device(device)
    n_model = 2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1
    n_data = n_ranks // n_model
    B = max(2 * n_data, 4)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (B, 120, 160)).astype(np.float32)
    depths = rng.uniform(1, 50, (B, 120, 160)).astype(np.float32)

    spec = FAST_QUAD_L2NET_CONFCFS
    cfg = trainer.TrainConfig(batch=B, height=64, width=64)
    state = trainer.create_train_state(spec, cfg, device=dev)
    batch = synthetic_pair_batch(prng.key(0, dev), B, 64, 64)
    leaves = [t.cpu().numpy() for _, t in trainer._state_leaves(state)]
    batch_np = tuple(x.cpu().numpy() for x in batch)
    small = noisy_problem(8, 64, 48, seed=1)
    P, M, L = WINDOW
    window = noisy_problem(P, L, M, seed=2, reach=6.0)
    cases = [(small, "kf", 1, BA_ITERATIONS), (window, "kf", 1, BA_ITERATIONS)]

    t0 = time.perf_counter()
    res = launch.run(dryrun_rank, n_ranks, backend, device, images, depths, spec, cfg,
                    leaves, batch_np, cases, n_model)
    wall = time.perf_counter() - t0
    report = {"ranks": n_ranks, "backend": backend, "device": str(dev),
              "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "mesh": {"data": n_data, "model": n_model}, "wall_s": wall}

    # 1. inference against one process.
    ref = {k: v.cpu().numpy() for k, v in
           reference_inference(images, depths, K_DRY, 256, 21, dev).items()}
    rows = [res[r * n_model] for r in range(n_data)]
    for k in ("kp", "desc", "valid"):
        got = np.concatenate([r[f"inference/{k}"] for r in rows])
        if not np.array_equal(got, ref[k]):
            raise AssertionError(f"data-parallel extraction differs from one process: {k}")
    mask = np.concatenate([r["inference/mask"] for r in rows])
    idx = np.concatenate([r["inference/idx"] for r in rows])
    if not (np.array_equal(mask, ref["mask"]) and np.array_equal(idx[mask], ref["idx"][mask])):
        raise AssertionError("data-parallel matches differ from one process")
    n_matches = int(res[0]["inference/n_matches"])
    if n_matches != int(ref["mask"].sum()):
        raise AssertionError(f"match count {n_matches} != {int(ref['mask'].sum())}")
    report["inference"] = {"frames": B, "pairs": B - 1, "matches": n_matches}
    print(f"[dryrun] inference mesh=(data {n_data}, model {n_model}) frames {B} "
          f"matches={n_matches} (equal to one process) ok")

    # 2. the data-parallel training step against one process on the whole batch.
    _, m1 = trainer.train_step_batch(state, batch, spec, cfg)
    loss, loss_1 = float(res[0]["train/total"]), float(m1["total"])
    n_leaves = len(leaves)
    all_reduces = json.loads(str(res[0]["train/all_reduces"]))
    for r in res[1:]:
        for i in range(n_leaves):
            if not np.array_equal(r[f"train/state/{i}"], res[0][f"train/state/{i}"]):
                raise AssertionError(f"rank states differ after the data-parallel step (leaf {i})")
    if {int(r["train/batch_per_rank"]) for r in res} != {B // n_data}:
        raise AssertionError("the batch is not split over data")
    if all_reduces.get("gradients", [0])[0] != 1:
        raise AssertionError(f"the step issued {all_reduces.get('gradients', [0])[0]} "
                             f"gradient all-reduces, expected 1")
    d_loss = abs(loss - loss_1)
    if not (np.isfinite(loss) and d_loss <= 1e-3 * max(abs(loss_1), 1.0)):
        raise AssertionError(f"data-parallel loss {loss} != one-process loss {loss_1}")
    report["train"] = {"batch": B, "per_rank": B // n_data, "loss": loss, "loss_one": loss_1,
                       "all_reduces": all_reduces}
    print(f"[dryrun] train step mesh=(data {n_data}, model {n_model}) loss={loss:.6f} "
          f"(batch {B}//{n_data} per rank, 1 gradient all-reduce of "
          f"{all_reduces['gradients'][1] / 2**20:.2f} MiB, "
          f"{sum(n for n, _ in all_reduces.values())} all-reduces in all; one-process loss "
          f"{loss_1:.6f}, delta {d_loss:.2e}) ok")

    # 3. the sharded solve against one process, FLOPs and collectives.
    for i, name in enumerate(("small", "window")):
        p = f"case{i}/"
        r0 = res[0]
        for r in res[1:]:
            if not all(np.array_equal(r[p + k], r0[p + k]) for k in ("poses", "points", "costs")):
                raise AssertionError(f"ranks disagree on the sharded solve ({name})")
        c1, cn = float(r0[p + "single_final_cost"]), float(r0[p + "final_cost"])
        if not (c1 > 1e-3 and np.isfinite(cn) and abs(cn - c1) <= 1e-2 * max(abs(c1), 1.0)):
            raise AssertionError(f"sharded BA cost {cn} against one process {c1} ({name})")
        if not bool(r0[p + "repeat_equal"]):
            raise AssertionError(f"two sharded solves differ ({name})")
        f1, fn_ = int(r0[p + "flops_single"]), int(r0[p + "flops_sharded"])
        if n_ranks > 1 and not fn_ < f1:
            raise AssertionError(f"per-rank FLOPs {fn_} not below one process's {f1}")
        per_it = _per_iteration(str(r0[p + "collectives"]), BA_ITERATIONS)
        report[f"ba_{name}"] = {
            "P": int(r0[p + "poses"].shape[0]), "L": int(r0[p + "points"].shape[0]),
            "shards": int(r0[p + "shards"]), "final_cost": cn, "final_cost_one": c1,
            "pose_max_diff": float(np.abs(r0[p + "poses"] - r0[p + "single_poses"]).max()),
            "flops_per_rank": fn_, "flops_one": f1, "collectives_per_iteration": per_it,
            "ms_sharded": float(r0[p + "ms_sharded"]), "ms_one": float(r0[p + "ms_single"])}
        if p + "peak_mib" in r0:
            report[f"ba_{name}"]["peak_mib"] = float(r0[p + "peak_mib"])
        print(f"[dryrun] sharded BA ({name}, P={report[f'ba_{name}']['P']}, "
              f"L={report[f'ba_{name}']['L']}) over {n_ranks} rank(s): cost {cn:.6f} "
              f"(one process {c1:.6f}); per-rank FLOPs {fn_:.4g} vs one process {f1:.4g} "
              f"(1/{n_ranks} = {f1 / n_ranks:.4g}); per iteration "
              + ", ".join(f"{k} x{c:g} {b / 1024:.1f} KiB" for k, (c, b) in per_it.items())
              + f"; {report[f'ba_{name}']['ms_sharded']:.3f} ms per sharded solve, "
              f"{report[f'ba_{name}']['ms_one']:.3f} ms per single solve on "
              f"{report['device_name']} ({BA_ITERATIONS} iterations) ok")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nprocs", type=int, default=1)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="write the report here as JSON")
    args = ap.parse_args(argv)
    report = dryrun_multichip(args.nprocs, args.backend, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
