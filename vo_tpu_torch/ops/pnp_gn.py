"""PnP's Gauss-Newton solve as one hand-written CUDA kernel (``csrc/pnp_gn.cu``).

``launch_gn`` runs a whole threshold schedule of ``estimation/pnp.py``'s reweighted
Gauss-Newton solve over SE(3) in one launch on the current stream: one thread block
carries the solve from the start pose to the final one. The plain version is
``estimation/pnp.py::_gn_refine_plain``, which ``_gn_refine`` takes for CPU tensors;
for CUDA tensors it launches this kernel or raises. The kernel is built with the match
kernels, into one library (``kernels.build_kernels``).

``launch_gn.launches`` counts kernel launches like ``match.launch_wgmma.launches``: a
launch recorded into a CUDA graph is counted at each replay of the graph
(``ops/kernels.py``). A schedule of up to 64 thresholds takes one launch.
"""

from __future__ import annotations

import ctypes

import torch

from vo_tpu_torch.ops import kernels

# The kernel's C entry points: the solve, and the launches a schedule of n steps takes.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GN_ARGTYPES = [_P, _P, _P, _P, _P, ctypes.POINTER(_F), _I, _F, _I, _P, _P]


def _inputs(pose, X, x_px, valid, K):
    """Validate the solve's operands -> contiguous tensors, N."""
    dev = X.device
    n = X.shape[0]
    for name, t, shape in (("pose", pose, (4, 4)), ("X", X, (n, 3)), ("x_px", x_px, (n, 2)),
                           ("K", K, (3, 3))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32, got {t.dtype}")
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be a {shape} tensor on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,) or valid.device != dev:
        raise ValueError(f"valid must be a ({n},) bool tensor on {dev}")
    return [t.contiguous() for t in (pose, X, x_px, valid, K)], n


@kernels.counted("gn")
def launch_gn(pose, X, x_px, valid, K, thresholds, min_depth: float):
    """The solve from ``pose`` (4, 4) over X (N, 3), x_px (N, 2), valid (N,), K (3, 3)
    with one iteration per entry of ``thresholds`` (px) -> the final (4, 4) pose; an
    empty schedule returns ``pose``."""
    if X.device.type != "cuda":
        raise ValueError(f"the Gauss-Newton kernel runs on cuda, not {X.device}")
    (pose, X, x_px, valid, K), n = _inputs(pose, X, x_px, valid, K)
    steps = len(thresholds)
    if steps == 0:
        return pose
    solve = kernels.entry("vo_pnp_gn", _GN_ARGTYPES)
    launches = kernels.entry("vo_pnp_gn_launches", [_I])
    out = torch.empty((4, 4), dtype=torch.float32, device=X.device)
    thr = (ctypes.c_float * steps)(*thresholds)
    with torch.cuda.device(X.device):
        err = solve(pose.data_ptr(), X.data_ptr(), x_px.data_ptr(), valid.data_ptr(),
                    K.data_ptr(), thr, steps, min_depth, n, out.data_ptr(),
                    torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"Gauss-Newton kernel launch failed: error {err}")
    kernels.count("gn", launches(steps))
    return out
