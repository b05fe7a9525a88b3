"""Online VO: the per-frame ``process_frame`` API, for frames that arrive one at a time.

Port of ``vo_tpu/engine/online.py``. The same step as the offline engine (its step
entry ``VOEngine.steps``: a CUDA-graph replay on the card), with the keyframe state on
the device between calls; per frame one extraction and one step, and the pose read
back.

    vo = OnlineVO(K)
    for i, (img, depth) in enumerate(stream):
        pose = vo.process_frame(img, depth, i)       # (4, 4) np camera-to-world
"""

from __future__ import annotations

import numpy as np
import torch

from vo_tpu_torch import prng
from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.engine.vo import VOConfig, VOEngine, VOState, VOStepDiagnostics
from vo_tpu_torch.features.extractor import OrbLikeExtractor
from vo_tpu_torch.geometry.camera import depth_to_3d_at
from vo_tpu_torch.utils.profiling import span


class OnlineVO:
    """Runs on ``device`` (default cuda; raises if there is no GPU)."""

    def __init__(self, K, config: VOConfig = VOConfig(), extractor=None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.K = torch.from_numpy(np.asarray(K, np.float32)).to(self.device)
        self.engine = VOEngine(config, device=self.device)
        self.extractor = extractor if extractor is not None else OrbLikeExtractor()
        self.state: VOState | None = None
        self.last_diagnostics: VOStepDiagnostics | None = None
        self._key = prng.key(config.seed, device=self.device)

    def _extract(self, img, depth):
        img = torch.from_numpy(np.ascontiguousarray(img)[None]).to(self.device)
        feats = self.extractor(img, device=self.device)
        depth = torch.from_numpy(np.asarray(depth, np.float32)).to(self.device)
        kp3d = depth_to_3d_at(depth, feats.kp[0], self.K)
        return feats.kp[0], feats.desc[0], feats.valid[0], kp3d

    def process_frame(self, img, depth, frame_no: int) -> np.ndarray:
        """-> the (4, 4) camera-to-world pose estimate of this frame (np).

        Spans: ``online.frame`` > ``online.extract``, the engine's ``engine.step``
        (``engine.match``, ``pnp.ransac`` when it runs eagerly), ``online.readback``."""
        with span("online.frame", frame=frame_no):
            with span("online.extract", device=True):
                kp, desc, valid, kp3d = self._extract(img, depth)
            kp3d_valid = self.engine._depth_valid(valid, kp3d)
            frame_id = torch.full((), frame_no, dtype=torch.int32, device=self.device)

            if self.state is None or frame_no == 0:
                pose0 = torch.eye(4, device=self.device)
                self.state = VOState(
                    ref_kp=kp, ref_desc=desc, ref_valid=valid,
                    ref_3d=kp3d, ref_3d_valid=kp3d_valid,
                    ref_pose=pose0, ref_id=frame_id,
                    bad_pnp=torch.zeros((), dtype=torch.int32, device=self.device),
                    cur_pose=pose0,
                )
                return np.eye(4)

            key = prng.fold_in(self._key, frame_id)
            self.state, pose, diag = self.engine.steps(
                self.K, self.state, kp[None], desc[None], valid[None], kp3d[None],
                kp3d_valid[None], frame_id[None], key[None], frames=[frame_no])
            with span("online.readback"):
                self.last_diagnostics = VOStepDiagnostics(*(d[0].cpu().numpy() for d in diag))
                return pose[0].cpu().numpy()

    def reset(self):
        self.state = None
