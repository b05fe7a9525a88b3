"""Distributed windowed Schur BA: keyframe blocks sharded over one axis of a mesh.

Port of ``vo_tpu/ba/distributed.py``. Each rank of the axis owns a contiguous block of
keyframes (their observation slots) and a block of landmarks; the Schur reduction is
assembled with the collectives of ``parallel/comm.py``, one for each of the JAX
program's:

  1. per-rank residuals and Jacobians of the local keyframe block;
  2. ``reduce_scatter`` of the landmark blocks Hll and rhs bl (``psum_scatter``):
     after it each rank holds the fully summed 3x3 blocks of the landmarks it owns;
  3. ``all_to_all`` of the pose-landmark couplings U: rank s sends the couplings its
     keyframes give rank t's landmarks;
  4. the Schur correction over the owned landmarks, then ``all_reduce`` of the
     reduced camera system S (6P x 6P) and of g, solved on every rank;
  5. the landmark back-substitution on the owner, then ``all_gather`` of the
     updates (the JAX program sums disjoint blocks: the same bits).

The costs are all-reduced too. The iteration is ``bundle_adjust``'s: the same
Jacobians, ``damped_inv3``, LM acceptance by a ``torch.where`` and ``solve_ex`` with no
error check, and nothing is read back to the host. The sums run in another order than
the single-device solve's (the collectives add the ranks' partial sums), so the two
agree to rounding, not bit for bit; on one rank they compute the same sums.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vo_tpu_torch.ba.bundle_adjust import (
    BAConfig,
    BAProblem,
    _residuals_and_jacobians,
    _segment_plans,
    _total_cost,
    damped_inv3,
)
from vo_tpu_torch.ba.segment import segment_sum
from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.geometry.se3 import se3_exp
from vo_tpu_torch.parallel import comm


def _pad_problem(prob: BAProblem, n_shards: int) -> tuple[BAProblem, int, int]:
    """Pad poses to a multiple of ``n_shards`` (identity poses with no observations)
    and landmarks likewise (zero points), so every rank gets equal blocks."""
    P, L = prob.poses.shape[0], prob.points.shape[0]
    P_pad = -(-P // n_shards) * n_shards
    L_pad = -(-L // n_shards) * n_shards
    if P_pad == P and L_pad == L:
        return prob, P, L

    dP = P_pad - P

    def cat(x, rows):
        return torch.cat([x, x.new_zeros((rows,) + x.shape[1:])])

    eye = torch.eye(4, dtype=prob.poses.dtype, device=prob.poses.device).expand(dP, 4, 4)
    prob = BAProblem(
        poses=torch.cat([prob.poses, eye]), points=cat(prob.points, L_pad - L),
        obs_lm=cat(prob.obs_lm, dP), obs_uv=cat(prob.obs_uv, dP),
        obs_valid=cat(prob.obs_valid, dP), K=prob.K,
        obs_z=None if prob.obs_z is None else cat(prob.obs_z, dP))
    return prob, P, L


def _ba_shard_body(poses, points, local: BAProblem, cfg: BAConfig, group, n_fixed: int):
    """One rank's part of the solve. ``poses`` (P_tot, 4, 4), ``points`` (L_tot, 3) and
    ``local.K`` are the same on every rank; ``local.obs_*`` hold this rank's keyframe
    block. The trailing ``n_fixed`` poses (the padding) are held at identity.
    Returns (poses, points, costs (iterations, 2), final_cost, mean_reproj)."""
    D, me = dist.get_world_size(group), dist.get_rank(group)
    P_tot, L_tot = poses.shape[0], points.shape[0]
    P_loc = local.obs_lm.shape[0]
    L_loc = L_tot // D
    p0 = me * P_loc
    dev, dt = poses.device, poses.dtype

    # Gauge / padding mask over the replicated 6P camera system: pose 0 and the padded
    # poses are frozen as bundle_adjust's fix_first_pose mask freezes pose 0.
    keep = torch.ones(P_tot, dtype=dt, device=dev)
    if cfg.fix_first_pose:
        keep[0] = 0.0
    if n_fixed:
        keep[P_tot - n_fixed:] = 0.0
    mask = keep.repeat_interleave(6)
    unfixed = torch.diag(1.0 - mask)
    eye_loc = torch.eye(P_loc, dtype=dt, device=dev)
    rows = slice(6 * p0, 6 * (p0 + P_loc))
    by_lm, by_lm_pose = _segment_plans(local.obs_lm, L_tot)

    def reduced_system(r, Jp, Jl, w, damping):
        """Distributed Schur assembly -> replicated (S, g) + the owner's landmark terms."""
        Hpp = torch.einsum("pmik,pmil,pm->pkl", Jp, Jp, w)                 # (P_loc, 6, 6)
        bp = -torch.einsum("pmik,pmi,pm->pk", Jp, r, w)                    # (P_loc, 6)

        # Landmark blocks: partial sums over the local observations, reduce-scattered so
        # each rank owns the fully summed blocks of its landmark range.
        Hll_part = segment_sum(
            torch.einsum("pmik,pmil,pm->pmkl", Jl, Jl, w).reshape(-1, 3, 3), by_lm)
        bl_part = segment_sum(-torch.einsum("pmik,pmi,pm->pmk", Jl, r, w).reshape(-1, 3),
                              by_lm)
        Hll_own = comm.reduce_scatter(Hll_part, group, "Hll")              # (L_loc, 3, 3)
        bl_own = comm.reduce_scatter(bl_part, group, "bl")                 # (L_loc, 3)

        # Couplings U: local (L_tot, P_loc, 6, 3), exchanged so the owner of each
        # landmark sees its couplings to every keyframe block; the blocks arrive in
        # source-rank order, which is the global pose order.
        Wpl = torch.einsum("pmik,pmil,pm->pmkl", Jp, Jl, w).reshape(-1, 6, 3)
        U_part = segment_sum(Wpl, by_lm_pose).reshape(L_tot, P_loc, 6, 3)
        U_own = (comm.all_to_all(U_part, group, "U")                      # (D, L_loc, P_loc, 6, 3)
                 .transpose(0, 1).reshape(L_loc, P_tot * 6, 3))

        inv3_own = damped_inv3(Hll_own, damping)                           # (L_loc, 3, 3)
        Hinv_Ut = inv3_own @ U_own.transpose(1, 2)                         # (L_loc, 3, 6P)
        U_rows = U_own.permute(1, 0, 2).reshape(6 * P_tot, 3 * L_loc)
        S_corr = U_rows @ Hinv_Ut.reshape(3 * L_loc, 6 * P_tot)
        g_corr = U_rows @ (inv3_own @ bl_own[..., None]).reshape(3 * L_loc)

        # The local Hpp / bp at their global block-diagonal positions.
        S = -S_corr
        S[rows, rows] += torch.einsum("pkl,pq->pkql", Hpp, eye_loc).reshape(6 * P_loc,
                                                                           6 * P_loc)
        g = -g_corr
        g[rows] += bp.reshape(-1)
        S = comm.all_reduce(S, group, "S")
        g = comm.all_reduce(g, group, "g")
        return S, g, (inv3_own, bl_own, U_own)

    def cost(r, w):
        return comm.all_reduce(_total_cost(r, w), group, "cost")

    damping = torch.tensor(cfg.damping_init, dtype=dt, device=dev)
    costs = []
    for _ in range(cfg.iterations):
        r, Jp, Jl, w = _residuals_and_jacobians(poses[p0:p0 + P_loc], points, local, cfg)
        cost0 = cost(r, w)
        S, g, (inv3_own, bl_own, U_own) = reduced_system(r, Jp, Jl, w, damping)

        S = S + damping * torch.diag(torch.clamp(torch.diagonal(S), min=1e-6))
        S = S * mask[:, None] * mask[None, :] + unfixed
        g = g * mask
        delta_p = torch.linalg.solve_ex(S, g, check_errors=False)[0]      # replicated

        Ut_dp = torch.einsum("lak,a->lk", U_own, delta_p)
        delta_l_own = (inv3_own @ (bl_own - Ut_dp)[..., None])[..., 0]
        delta_l = comm.all_gather(delta_l_own, group, "delta_l")          # (L_tot, 3)

        new_poses = se3_exp(delta_p.reshape(P_tot, 6)) @ poses
        new_points = points + delta_l
        r2, _, _, w2 = _residuals_and_jacobians(new_poses[p0:p0 + P_loc], new_points, local,
                                                cfg, jacobians=False)
        cost1 = cost(r2, w2)
        improved = cost1 < cost0
        poses = torch.where(improved, new_poses, poses)
        points = torch.where(improved, new_points, points)
        damping = torch.where(improved, damping * 0.5, damping * 4.0)
        costs.append(torch.stack([cost0, cost1]))

    r, _, _, w = _residuals_and_jacobians(poses[p0:p0 + P_loc], points, local, cfg,
                                          jacobians=False)
    final = cost(r, w)
    wsum = comm.all_reduce(torch.sum(w), group, "wsum")
    costs = torch.stack(costs) if costs else r.new_zeros((0, 2))
    return poses, points, costs, final, torch.sqrt(final / torch.clamp(wsum, min=1.0))


def bundle_adjust_sharded(prob: BAProblem, mesh, cfg: BAConfig = BAConfig(),
                          axis: str = "model"):
    """Keyframe-block distributed Schur BA over ``mesh[axis]`` (a ``DeviceMesh``).

    Same contract as ``bundle_adjust``: returns (poses, points, info) as tensors on
    this rank's device (``cuda`` under NCCL, ``cpu`` under gloo), the same on every rank
    of the axis; info holds ``costs``, ``final_cost`` and ``mean_reproj``. Every rank
    passes the whole problem and keeps its own keyframe block of it."""
    group = mesh.get_group(axis)
    D, me = dist.get_world_size(group), dist.get_rank(group)
    dev = resolve_device(mesh.device_type)
    prob = prob.to(dev)._replace(obs_lm=prob.obs_lm.to(dev, torch.int64))
    padded, P, L = _pad_problem(prob, D)
    P_loc = padded.poses.shape[0] // D
    block = slice(me * P_loc, (me + 1) * P_loc)
    local = BAProblem(poses=None, points=None, obs_lm=padded.obs_lm[block],
                      obs_uv=padded.obs_uv[block], obs_valid=padded.obs_valid[block],
                      K=padded.K,
                      obs_z=None if padded.obs_z is None else padded.obs_z[block])
    poses, points, costs, final, mean_reproj = _ba_shard_body(
        padded.poses, padded.points, local, cfg, group, padded.poses.shape[0] - P)
    info = {"costs": costs, "final_cost": final, "mean_reproj": mean_reproj}
    return poses[:P], points[:L], info
