"""Pose estimation. Mirrors ``vo_tpu/estimation/__init__.py``."""

from vo_tpu_torch.estimation.pnp import PnPConfig, PnPResult, pnp_ransac
from vo_tpu_torch.estimation.procrustes import kabsch
from vo_tpu_torch.estimation.essential import (
    EssentialConfig,
    EssentialResult,
    essential_ransac,
    relative_scale,
)
