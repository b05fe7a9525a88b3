"""Device choice and the fp32 geometry policy of the PyTorch port.

Counterpart of ``vo_tpu/ops/precision.py::geometry_precision``. The pose solvers
(DLT normal equations, Gauss-Newton JTJ, Kabsch covariances, reprojection scoring)
need true fp32 matmuls: reduced-precision geometry breaks the pose chain
(docs/PERF.md rule 3). On the card that means TF32 off for both cuBLAS and cuDNN.

Entry points run on ``cuda`` unless the caller asks for the CPU. There is no silent
fallback: asking for ``cuda`` on a machine without one raises.
"""

from __future__ import annotations

import numpy as np
import torch


def use_fp32_geometry() -> None:
    """Pin fp32 matmuls and convolutions (no TF32) for the whole process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    use_fp32_geometry()
    return dev


def to_device(x, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A tensor on ``device`` from a tensor, a numpy array or a nested list (no copy
    when it is already there in that dtype)."""
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(x)
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    return x.to(device=device, dtype=dtype)
