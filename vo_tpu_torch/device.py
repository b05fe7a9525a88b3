"""Device choice and the fp32 geometry policy of the PyTorch port.

Counterpart of ``vo_tpu/ops/precision.py::geometry_precision``. The pose solvers
(DLT normal equations, Gauss-Newton JTJ, Kabsch covariances, reprojection scoring)
need true fp32 matmuls: reduced-precision geometry breaks the pose chain
(docs/PERF.md rule 3). On the card that means TF32 off for both cuBLAS and cuDNN.

Entry points run on ``cuda`` unless the caller asks for the CPU. There is no silent
fallback: asking for ``cuda`` on a machine without one raises.
"""

from __future__ import annotations

import subprocess

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
    when it is already there in that dtype), of the same shape: a 0-d array stays 0-d
    (``np.ascontiguousarray`` alone returns at least one dimension)."""
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(x).reshape(np.shape(x))
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    return x.to(device=device, dtype=dtype)


def device_for(x, device: str | torch.device | None = None) -> torch.device:
    """``device`` when given, else the device of ``x`` when it is a tensor, else cuda
    (through ``resolve_device``): functions that take arrays run where their tensors
    already are."""
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    return resolve_device(device)


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"), torch's
    name of the card when nvidia-smi cannot be read, and ``str(dev)`` off the card."""
    if dev.type != "cuda":
        return str(dev)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)} (power limit not read)"
