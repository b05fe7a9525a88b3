"""Pose estimation. The essential-matrix names of ``vo_tpu/estimation/__init__.py``
(``EssentialConfig``, ``EssentialResult``, ``essential_ransac``, ``relative_scale``)
wait for the mono slice (ROADMAP queue 1, item 10)."""

from vo_tpu_torch.estimation.pnp import PnPConfig, PnPResult, pnp_ransac
from vo_tpu_torch.estimation.procrustes import kabsch
