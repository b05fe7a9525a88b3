"""Upright BRIEF at the keypoints: one hand-written CUDA kernel (``csrc/brief.cu``) and
its plain version.

``keypoint_brief`` compares, at each keypoint and for each pair of an integer offsets
table, two pixels of the blurred image rounded to bf16 (zero outside the image), and
returns the +-1 bf16 descriptors, 0 rows for invalid keypoints. These are the bits of
``features/dense_brief.py``'s dense path (``dense_packed_brief`` then
``gather_brief_descriptors``) without building the compares at every pixel. It launches
the kernel for CUDA tensors (``launch_brief``) and runs ``keypoint_brief_plain`` for CPU
tensors; both refuse what the kernel does not take. The kernel is built with the others,
into one library (``kernels.build_kernels``).

``launch_brief.launches`` counts kernel launches, one a call, like
``pnp_gn.launch_gn.launches``: a launch recorded into a CUDA graph is counted at each
replay of the graph (``ops/kernels.py``).
"""

from __future__ import annotations

import ctypes

import torch

from vo_tpu_torch.ops import kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
_BRIEF_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P, _P]

# The kernel keeps the table in shared memory: 16 bytes a pair.
MAX_BITS = 2048


def _inputs(smoothed, kp, valid, offsets):
    """Validate the operands -> (B, H, W, K, bits)."""
    if smoothed.dtype != torch.float32 or smoothed.ndim != 3:
        raise ValueError(f"the blurred image must be a (B, H, W) fp32 tensor, got "
                         f"{tuple(smoothed.shape)} {smoothed.dtype}")
    B, H, W = smoothed.shape
    dev = smoothed.device
    if kp.dtype != torch.float32 or kp.ndim != 3 or kp.shape[0] != B or kp.shape[2] != 2:
        raise ValueError(f"kp must be a ({B}, K, 2) fp32 tensor, got {tuple(kp.shape)} "
                         f"{kp.dtype}")
    K = kp.shape[1]
    if valid.dtype != torch.bool or tuple(valid.shape) != (B, K):
        raise ValueError(f"valid must be a ({B}, {K}) bool tensor, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    bits = offsets.shape[0] if offsets.ndim == 3 else 0
    if offsets.dtype != torch.int32 or tuple(offsets.shape[1:]) != (2, 2):
        raise ValueError(f"offsets must be a (bits, 2, 2) int32 table, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if bits <= 0 or bits % 32 or bits > MAX_BITS:
        raise ValueError(f"the BRIEF kernel takes a multiple of 32 bits up to {MAX_BITS}, "
                         f"not {bits}")
    for name, t in (("kp", kp), ("valid", valid), ("offsets", offsets)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the image on {dev}")
    if max(B, H, W, K) >= 2 ** 31:
        raise ValueError(f"the BRIEF kernel takes sizes below 2**31, not B {B}, H {H}, "
                         f"W {W}, K {K}")
    return B, H, W, K, bits


def keypoint_brief(smoothed: torch.Tensor, kp: torch.Tensor, valid: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """smoothed (B, H, W) fp32, kp (B, K, 2) fp32 [x, y], valid (B, K) bool, offsets
    (bits, 2, 2) int32 [pair, point, (dx, dy)] on one device -> (B, K, bits) +-1 bf16,
    0 rows where not valid: the kernel on CUDA, the plain version elsewhere."""
    if smoothed.device.type == "cuda":
        return launch_brief(smoothed, kp, valid, offsets)
    _inputs(smoothed, kp, valid, offsets)
    return keypoint_brief_plain(smoothed, kp, valid, offsets)


def keypoint_brief_plain(smoothed, kp, valid, offsets) -> torch.Tensor:
    """The plain version: the kernel's arithmetic in PyTorch ops, a (B, K, bits) gather
    per point of the pairs."""
    B, H, W = smoothed.shape
    xi = kp[..., 0].to(torch.int64).clamp(0, W - 1)[..., None]
    yi = kp[..., 1].to(torch.int64).clamp(0, H - 1)[..., None]
    img = smoothed.to(torch.bfloat16).reshape(B, H * W)
    off = offsets.to(torch.int64)

    def at(point):
        x, y = xi + off[:, point, 0], yi + off[:, point, 1]              # (B, K, bits)
        inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        idx = y.clamp(0, H - 1) * W + x.clamp(0, W - 1)
        v = torch.gather(img, 1, idx.reshape(B, -1)).reshape(idx.shape)
        return torch.where(inside, v, 0.0)

    desc = torch.where(at(0) < at(1), 1.0, -1.0).to(torch.bfloat16)
    return torch.where(valid[..., None], desc, 0.0)


@kernels.counted("brief")
def launch_brief(smoothed, kp, valid, offsets) -> torch.Tensor:
    """``keypoint_brief`` on the card in one launch on the current stream."""
    if smoothed.device.type != "cuda":
        raise ValueError(f"the BRIEF kernel runs on cuda, not {smoothed.device}")
    B, H, W, K, bits = _inputs(smoothed, kp, valid, offsets)
    smoothed, kp, valid, offsets = (t.contiguous() for t in (smoothed, kp, valid, offsets))
    if offsets.data_ptr() % 16:
        raise ValueError("the offsets table must be 16-byte aligned")
    out = torch.empty((B, K, bits), dtype=torch.bfloat16, device=smoothed.device)
    brief = kernels.entry("vo_brief", _BRIEF_ARGTYPES)
    with torch.cuda.device(smoothed.device):
        err = brief(smoothed.data_ptr(), kp.data_ptr(), valid.data_ptr(), offsets.data_ptr(),
                    B, H, W, K, bits, out.data_ptr(),
                    torch.cuda.current_stream(smoothed.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"BRIEF kernel launch failed: error {err}")
    kernels.count("brief")
    return out
