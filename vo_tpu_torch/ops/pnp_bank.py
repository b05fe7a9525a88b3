"""PnP-RANSAC's hypothesis bank as one hand-written CUDA kernel (``csrc/pnp_bank.cu``).

``launch_bank`` draws the bank's minimal sets from the threefry key, solves each
hypothesis (the 3-point Kabsch bank when the frame has depth, the m-point DLT bank),
scores every hypothesis over all N correspondences and picks the first maximum, in two
launches on the current stream and with no host read. The plain version is
``estimation/pnp.py::_bank_plain``, which ``_bank`` takes for CPU tensors; for CUDA
tensors it launches this kernel or raises. The kernel is built with the others, into
one library (``kernels.build_kernels``).

``launch_bank.launches`` counts calls (two launches each) like
``pnp_gn.launch_gn.launches`` counts solves: a call recorded into a CUDA graph is
counted at each replay of the graph (``ops/kernels.py``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from vo_tpu_torch.ops import kernels

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_BANK_ARGTYPES = [_P] * 7 + [_I] * 4 + [_F] * 2 + [_P] * 6 + [_P]

# The sample sizes the kernel takes (the DLT needs 6 points; its shared arrays hold 16).
SAMPLE_SIZES = range(6, 17)


class Bank(NamedTuple):
    """The bank's pick and the bank itself."""

    pose: torch.Tensor      # (4, 4) fp32, the first hypothesis with the most inliers
    count: torch.Tensor     # () int64, its inliers
    inliers: torch.Tensor   # (N,) bool, its inlier mask
    idx: torch.Tensor       # (H, m) int32, each hypothesis's drawn points (-1 past 3)
    poses: torch.Tensor     # (H, 4, 4) fp32, every hypothesis
    counts: torch.Tensor    # (H,) int32, their inliers


def _inputs(key, X, x_px, valid, K, X_cur, valid_cur):
    """Validate the bank's operands -> contiguous tensors (X_cur and valid_cur may be
    None), N."""
    dev = X.device
    n = X.shape[0]
    if n == 0:
        raise ValueError("the bank needs at least one correspondence")
    floats = [("X", X, (n, 3)), ("x_px", x_px, (n, 2)), ("K", K, (3, 3))]
    if X_cur is not None:
        floats.append(("X_cur", X_cur, (n, 3)))
    for name, t, shape in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32, got {t.dtype}")
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be a {shape} tensor on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in (("valid", valid), ("valid_cur", valid_cur)):
        if t is not None and (t.dtype != torch.bool or tuple(t.shape) != (n,)
                              or t.device != dev):
            raise ValueError(f"{name} must be a ({n},) bool tensor on {dev}")
    if key.dtype != torch.int64 or tuple(key.shape) != (2,) or key.device != dev:
        raise ValueError(f"key must be a (2,) int64 tensor on {dev}")
    return [None if t is None else t.contiguous()
            for t in (key, X, x_px, valid, K, X_cur, valid_cur)], n


@kernels.counted("bank")
def launch_bank(key, X, x_px, valid, K, n_hyp: int, m: int, thr: float, min_depth: float,
                X_cur=None, valid_cur=None) -> Bank:
    """The bank of ``n_hyp`` hypotheses over X (N, 3), x_px (N, 2), valid (N,), K (3, 3)
    from the threefry ``key`` (2,): 3/4 of them Kabsch solves on X_cur (N, 3) (masked by
    ``valid & valid_cur``) when X_cur is given, the rest DLT solves on ``m`` points;
    scored with the inlier rule ``res < thr``, ``z > min_depth``, ``valid``."""
    if m not in SAMPLE_SIZES:
        raise ValueError(f"the bank kernel takes sample sizes {SAMPLE_SIZES.start}-"
                         f"{SAMPLE_SIZES.stop - 1}, not {m}")
    if n_hyp < 1:
        raise ValueError(f"the bank needs at least one hypothesis, not {n_hyp}")
    if X_cur is None and valid_cur is not None:
        raise ValueError("valid_cur without X_cur")
    if X.device.type != "cuda":
        raise ValueError(f"the bank kernel runs on cuda, not {X.device}")
    (key, X, x_px, valid, K, X_cur, valid_cur), n = _inputs(key, X, x_px, valid, K, X_cur,
                                                             valid_cur)
    n_kab = 0 if X_cur is None else (3 * n_hyp) // 4
    dev = X.device
    idx = torch.empty((n_hyp, m), dtype=torch.int32, device=dev)
    poses = torch.empty((n_hyp, 4, 4), dtype=torch.float32, device=dev)
    counts = torch.empty((n_hyp,), dtype=torch.int32, device=dev)
    pose = torch.empty((4, 4), dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    inliers = torch.empty((n,), dtype=torch.bool, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    bank = kernels.entry("vo_pnp_bank", _BANK_ARGTYPES)
    with torch.cuda.device(dev):
        err = bank(*map(ptr, (key, X, X_cur, x_px, valid, valid_cur, K)), n, n_hyp, n_kab, m,
                   thr, min_depth, *map(ptr, (idx, poses, counts, pose, count, inliers)),
                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bank kernel launch failed: error {err}")
    kernels.count("bank")
    return Bank(pose, count, inliers, idx, poses, counts)
