"""Batched geometry: SO(3) / SE(3) Lie ops and the pinhole camera.

Mirrors ``vo_tpu/geometry/__init__.py``, but for the names that wait for the mono
slice (``triangulate``, ``umeyama_alignment``: ROADMAP queue 1, item 10).
"""

from vo_tpu_torch.geometry.so3 import (
    hat,
    vee,
    so3_exp,
    so3_log,
    rodrigues,
    inv_rodrigues,
)
from vo_tpu_torch.geometry.se3 import (
    se3_exp,
    se3_log,
    pose_from_rt,
    pose_inverse,
    pose_compose,
    transform_points,
    chain_relative_poses,
    identity_pose,
)
from vo_tpu_torch.geometry.camera import (
    PinholeCamera,
    project,
    unproject,
    normalize_kp,
    depth_to_3d_at,
    depth_to_3d,
)
