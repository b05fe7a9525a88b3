"""Monocular VO engine: essential-matrix motion + triangulated-structure scale.

Port of ``vo_tpu/engine/mono.py``. Per frame: match keyframe and current frame ->
``essential_ransac`` (rotation + unit translation) -> triangulate the inliers in the
keyframe's frame (unit-scale structure) -> the metric scale against the keyframe's
depth-backed 3D points (``relative_scale``) -> motion gate and keyframe policy.

As in the RGB-D engine (``engine/vo.py``), the JAX package's ``lax.scan`` is a Python
loop over frames with the state on the device and no host sync of its own per frame,
and the keyframe swap (a ``lax.cond``) is a ``torch.where`` per state field. Mono's
own rules differ from the RGB-D engine's: keyframe depth validity 0 < z < 80 m, a
non-finite step is rejected, no re-orthonormalisation of the chained pose, and a
keyframe refresh after ``bad_pnp_limit`` rejections without a lost-tracking clause.

The ratio matchers go through ``ops.match``'s fused wrappers (the match kernels on the
card, the plain matcher for CPU tensors) where the JAX mono engine always calls the
XLA matcher; ``use_match_kernel=False`` selects the plain matcher everywhere.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vo_tpu_torch import prng
from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.engine.vo import VOEngine, VOState, VOStepDiagnostics
from vo_tpu_torch.estimation.essential import (EssentialConfig, essential_ransac,
                                               relative_scale)
from vo_tpu_torch.geometry.se3 import pose_inverse
from vo_tpu_torch.geometry.triangulation import triangulate


@dataclass(frozen=True)
class MonoVOConfig:
    """The JAX package's MonoVOConfig, plus ``use_match_kernel`` (VOConfig's field);
    the dataclass hash covers every field."""

    matcher: str = "ratio_binary"
    ratio: float = 0.85
    mnn_threshold: float = 0.9
    min_displacement_px: float = 3.0
    max_speed: float = 1.5
    kf_min_matches: int = 200
    kf_min_inliers: int = 100
    kf_max_step: float = 1.5
    bad_pnp_limit: int = 3
    essential: EssentialConfig = EssentialConfig()
    min_scale: float = 1e-3
    max_scale: float = 1e3
    seed: int = 8214
    use_match_kernel: bool = True   # ratio matchers through ops.match.top2_mutual


class MonoVOEngine:
    """Offline monocular sequence VO over pre-extracted features on ``device``
    (default cuda); the scale comes from the keyframe's depth-backed structure."""

    def __init__(self, config: MonoVOConfig = MonoVOConfig(),
                 device: str | torch.device | None = None):
        self.config = config
        self.device = resolve_device(device)

    # The RGB-D engine's matcher dispatch: it reads the matcher fields and
    # use_match_kernel, which MonoVOConfig shares with VOConfig.
    _match = VOEngine._match

    def _step(self, K, state: VOState, kp, desc, valid, kp3d, kp3d_valid, frame_id, key):
        cfg = self.config
        k_e, k_s = prng.split(key)

        m = self._match(state.ref_desc, desc, state.ref_valid, valid)
        cur_kp_m = kp[m.idx]
        disp = torch.linalg.vector_norm(state.ref_kp - cur_kp_m, dim=-1)
        corr_valid = m.mask & (disp >= cfg.min_displacement_px)
        n_matches = corr_valid.sum().to(torch.int32)

        # ess.pose: x_cur = R x_ref + t_unit (keyframe camera -> current, |t| = 1).
        ess = essential_ransac(k_e, state.ref_kp, cur_kp_m, corr_valid, K, cfg.essential)

        # Unit-scale structure in the keyframe camera frame.
        X_w, _, _ = triangulate(state.ref_kp, cur_kp_m, torch.eye(4, device=kp.device),
                                ess.pose, K)
        tri_valid = ess.inliers & (X_w[:, 2] > 0.1)

        # Metric scale against the keyframe's depth-backed 3D points.
        s = relative_scale(k_s, X_w, state.ref_3d, tri_valid & state.ref_3d_valid)
        s = torch.clamp(s, cfg.min_scale, cfg.max_scale)

        rel = pose_inverse(ess.pose)          # current -> keyframe, unit translation
        rel[:3, 3] = rel[:3, 3] * s
        step_norm = torch.linalg.vector_norm(rel[:3, 3])
        frame_gap = (frame_id - state.ref_id).to(torch.float32)
        motion_ok = step_norm <= cfg.max_speed * torch.clamp(frame_gap, min=1.0)
        accepted = ess.ok & motion_ok & torch.isfinite(step_norm)

        cur_pose = torch.where(accepted, state.ref_pose @ rel, state.ref_pose)
        bad = torch.where(accepted, torch.zeros_like(state.bad_pnp), state.bad_pnp + 1)
        promote = accepted & ((n_matches < cfg.kf_min_matches)
                              | (ess.n_inliers < cfg.kf_min_inliers)
                              | (step_norm > cfg.kf_max_step))
        new_kf = promote | (bad > cfg.bad_pnp_limit)

        def pick(new, old):
            cond = new_kf.reshape((1,) * old.ndim) if old.ndim else new_kf
            return torch.where(cond, new, old)

        new_state = VOState(
            ref_kp=pick(kp, state.ref_kp), ref_desc=pick(desc, state.ref_desc),
            ref_valid=pick(valid, state.ref_valid), ref_3d=pick(kp3d, state.ref_3d),
            ref_3d_valid=pick(kp3d_valid, state.ref_3d_valid),
            ref_pose=pick(cur_pose, state.ref_pose), ref_id=pick(frame_id, state.ref_id),
            bad_pnp=bad, cur_pose=cur_pose,
        )
        diag = VOStepDiagnostics(n_matches=n_matches, n_inliers=ess.n_inliers,
                                 accepted=accepted, promoted_keyframe=new_kf,
                                 step_norm=step_norm)
        return new_state, cur_pose, diag

    def run_sequence(self, kp, desc, valid, kp3d, K, init_pose=None):
        """Run mono VO over a pre-extracted sequence (tensors on one device) ->
        ((F, 4, 4) poses, diagnostics of (F - 1,) tensors). Frame 0 seeds the
        keyframe; its emitted pose is ``init_pose`` (identity)."""
        dev = kp.device
        z = kp3d[..., 2]
        kp3d_valid = valid & (z > 0.0) & (z < 80.0)
        pose0 = (torch.eye(4, device=dev) if init_pose is None
                 else torch.as_tensor(init_pose, dtype=torch.float32, device=dev))
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        state = VOState(ref_kp=kp[0], ref_desc=desc[0], ref_valid=valid[0],
                        ref_3d=kp3d[0], ref_3d_valid=kp3d_valid[0], ref_pose=pose0,
                        ref_id=zero, bad_pnp=zero.clone(), cur_pose=pose0)
        ids = torch.arange(1, kp.shape[0], dtype=torch.int32, device=dev)
        keys = prng.fold_in(prng.key(self.config.seed, device=dev), ids)
        poses, diags = [pose0], []
        for i in range(1, kp.shape[0]):
            state, pose, diag = self._step(K, state, kp[i], desc[i], valid[i], kp3d[i],
                                           kp3d_valid[i], ids[i - 1], keys[i - 1])
            poses.append(pose)
            diags.append(diag)
        return (torch.stack(poses),
                VOStepDiagnostics(*(torch.stack(x) for x in zip(*diags))))
