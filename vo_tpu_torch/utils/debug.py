"""Interactive debug helpers. Port of ``vo_tpu/utils/debug.py``.

The reference's helpers are a blocking ``input()`` breakpoint and a ``cv2.imshow``
viewer with 'q' to exit. A headless host has no display, so ``display_image`` writes
a PNG into a directory the caller names (and blocks on input only when a TTY is
attached and ``block=True``); ``breakpoint_prompt`` is the same guarded input gate.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def breakpoint_prompt(message: str = "breakpoint") -> str:
    """Blocking prompt, or a no-op when stdin is not a TTY."""
    if not sys.stdin.isatty():
        return ""
    return input(f"{message} — press Enter to continue (or type a note): ")


def display_image(image, name: str = "debug", *, out_dir: str, block: bool = False) -> str:
    """Save an (H, W) or (H, W, 3) image (float or uint8, a numpy array or a tensor on
    any device) as ``out_dir/name.png``, and optionally pause. Float images in [0, 1]
    are scaled to [0, 255]. Returns the written path."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    im = image.detach().cpu().numpy() if isinstance(image, torch.Tensor) else np.asarray(image)
    if im.dtype != np.uint8:
        lo, hi = float(im.min()), float(im.max())
        if hi <= 1.0 and lo >= 0.0:
            im = im * 255.0
        im = np.clip(im, 0, 255).astype(np.uint8)
    if im.ndim == 2:
        im = np.stack([im] * 3, -1)
    path = os.path.join(out_dir, f"{name}.png")
    Image.fromarray(im).save(path)
    if block:
        breakpoint_prompt(f"wrote {path}")
    return path
