"""Pose-graph optimization (PGO): SE(3) relative-constraint smoothing on the device.

Port of ``vo_tpu/ba/pose_graph.py``. Nodes are camera-to-world poses; edges carry
measured relative transforms Z_ij ~ T_i^-1 T_j (odometry and loop closures).
Gauss-Newton with right-multiplicative perturbations T_k <- T_k exp(xi_k), residual
e_ij = log(Z_ij^-1 T_i^-1 T_j), Jacobians J_j = I, J_i = -Ad(T_j^-1 T_i); a fixed
iteration count, LM damping, node 0 gauge-fixed, a dense (6N, 6N) solve.

As in ``ba/bundle_adjust.py``: a Python loop with the carry on the device, step
acceptance by ``torch.where``, ``torch.linalg.solve_ex`` without its error check (a
singular system gives a non-finite step, which is rejected), and ``ba/segment.py``'s
fixed-order ``segment_sum`` for the block sums, so a solve on the card is bitwise
repeatable.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vo_tpu_torch.ba.segment import segment_sum, segments
from vo_tpu_torch.device import resolve_device, to_device
from vo_tpu_torch.geometry.se3 import pose_inverse, se3_exp, se3_log
from vo_tpu_torch.geometry.so3 import hat


@dataclass(frozen=True)
class PoseGraphConfig:
    """The JAX package's PoseGraphConfig: same fields, same defaults."""

    iterations: int = 20
    damping: float = 1e-4        # initial LM damping, adapted per iteration
    fix_first: bool = True


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint for twist order [v, w]: (..., 6, 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    top = torch.cat([R, hat(t) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def optimize_pose_graph(poses, edges_ij, edges_z, edges_w,
                        cfg: PoseGraphConfig = PoseGraphConfig(),
                        n_nodes: int | None = None,
                        device: str | torch.device | None = None):
    """Returns (optimized poses (N, 4, 4), per-iteration cost (iters,)) on ``device``
    (default cuda; raises if there is no GPU).

    poses (N, 4, 4) camera-to-world initial estimates; edges_ij (E, 2) node indices;
    edges_z (E, 4, 4) measured T_i^-1 T_j; edges_w (E,) scalar or (E, 6) per-component
    information weights in twist order [v, w] (0 disables an edge). Arrays or tensors;
    the solve runs in fp32.
    """
    dev = resolve_device(device)
    T = to_device(poses, dev, torch.float32)
    edges_ij = to_device(edges_ij, dev, torch.int64)
    edges_z = to_device(edges_z, dev, torch.float32)
    edges_w = to_device(edges_w, dev, torch.float32)
    N = n_nodes if n_nodes is not None else T.shape[0]
    E = edges_ij.shape[0]
    ii = edges_ij[:, 0]
    jj = edges_ij[:, 1]
    z_inv = pose_inverse(edges_z)
    w6 = edges_w if edges_w.ndim == 2 else edges_w[:, None] * torch.ones(
        (1, 6), device=dev)
    w = w6[:, :, None]          # scales residual rows: J^T diag(w6) J
    Jj = torch.eye(6, device=dev).expand(E, 6, 6)
    by_block = segments(torch.cat([ii * N + ii, jj * N + jj, ii * N + jj, jj * N + ii]),
                        N * N)
    by_node = segments(torch.cat([ii, jj]), N)
    gauge = torch.ones(6 * N, device=dev)
    gauge[:6] = 0.0

    def residuals(T):
        rel = pose_inverse(T[ii]) @ T[jj]
        return se3_log(z_inv @ rel), rel                      # (E, 6)

    damping = torch.tensor(cfg.damping, device=dev)
    costs = []
    for _ in range(cfg.iterations):
        e, rel = residuals(T)
        cost = torch.sum(w6 * e * e)

        Ji = -adjoint(pose_inverse(rel))
        Hii = Ji.transpose(-1, -2) @ (w * Ji)
        Hjj = Jj.transpose(-1, -2) @ (w * Jj)
        Hij = Ji.transpose(-1, -2) @ (w * Jj)
        bi = -torch.einsum("eab,ea->eb", w * Ji, e)
        bj = -torch.einsum("eab,ea->eb", w * Jj, e)

        # Dense block assembly: block sums on (i*N + j) block ids.
        blocks = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)], dim=0)
        Hgrid = segment_sum(blocks, by_block)
        H = Hgrid.reshape(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
        g = segment_sum(torch.cat([bi, bj], dim=0), by_node).reshape(6 * N)

        # LM damping scaled to H's own diagonal.
        H = H + damping * torch.diag(torch.clamp(torch.diagonal(H), min=1e-6))
        if cfg.fix_first:
            H = H * gauge[:, None] * gauge[None, :] + torch.diag(1.0 - gauge)
            g = g * gauge
        delta = torch.linalg.solve_ex(H, g, check_errors=False)[0].reshape(N, 6)
        T_new = T @ se3_exp(delta)

        # Step acceptance: reject non-improving or non-finite steps and raise the
        # damping instead (an unconditional step once diverged on a converged graph).
        e2, _ = residuals(T_new)
        cost1 = torch.sum(w6 * e2 * e2)
        improved = torch.isfinite(cost1) & (cost1 < cost)
        T = torch.where(improved, T_new, T)
        damping = torch.where(improved, damping * 0.5, damping * 10.0)
        costs.append(cost)
    return T, (torch.stack(costs) if costs else T.new_zeros((0,)))
