"""RGB-D sequence reader: sorted ``*.png`` + ``*_depth.npy`` pairs from a directory.

A copy of ``vo_tpu/io/dataset.py``: the reference's on-disk contract (its offline loop
globs both patterns, sorts them and zips them pairwise). Yields RGB uint8 + float32
metre depth. PIL is imported only when a PNG is read, so the module imports without
it; the native C++ loader (``vo_tpu_torch.io.native``) reads the same directories
without PIL. ``write_gray_u16mm_dir`` writes such a directory with the standard
library.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np


def _read_png_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_rgbd_pair(png_path: str, depth_path: str) -> tuple[np.ndarray, np.ndarray]:
    d = np.load(depth_path)
    if d.dtype == np.uint16:  # millimetre-quantised depth (half the disk bytes)
        d = d.astype(np.float32) * 1e-3
    else:
        d = d.astype(np.float32)
    return _read_png_rgb(png_path), d


@dataclass
class RGBDSequence:
    """Sorted (*.png, *_depth.npy) pairs from a directory, globbed as the reference does."""

    image_files: list
    depth_files: list

    @classmethod
    def from_dir(cls, img_dir: str) -> "RGBDSequence":
        pngs = sorted(glob.glob(os.path.join(img_dir, "*.png")))
        deps = sorted(glob.glob(os.path.join(img_dir, "*_depth.npy")))
        return cls(image_files=pngs, depth_files=deps)

    def __len__(self) -> int:
        return min(len(self.image_files), len(self.depth_files))

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        return load_rgbd_pair(self.image_files[i], self.depth_files[i])

    def iter_batches(self, batch: int, limit: int = 0):
        """Yield (idx0, rgb [B,H,W,3] uint8, depth [B,H,W] f32) contiguous batches.

        The last batch is padded by repeating the final frame so every batch has the
        same shape; the caller trims by sequence length.
        """
        n = len(self) if not limit else min(limit, len(self))
        for start in range(0, n, batch):
            idxs = list(range(start, min(start + batch, n)))
            idxs = idxs + [n - 1] * (batch - len(idxs))
            imgs, deps = zip(*(self[i] for i in idxs))
            yield start, np.stack(imgs), np.stack(deps)


def encode_png_gray(img: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit grayscale, non-interlaced PNG of ``img`` (H, W) uint8, every row with
    filter 0, written with zlib and struct alone."""
    H, W = img.shape
    raw = np.zeros((H, W + 1), np.uint8)
    raw[:, 1:] = img

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def write_gray_u16mm_dir(out_dir: str, images: np.ndarray, depths: np.ndarray) -> None:
    """Write frames as ``{i:06d}.png`` (8-bit gray: ``clip(img, 0, 255)`` truncated to
    uint8) + ``{i:06d}_depth.npy`` (``<u2`` millimetres: metres clipped to
    [0, 65.535] and rounded), the layout of the JAX package's io-included bench."""
    os.makedirs(out_dir, exist_ok=True)
    for i, (img, dep) in enumerate(zip(images, depths)):
        with open(os.path.join(out_dir, f"{i:06d}.png"), "wb") as f:
            f.write(encode_png_gray(np.clip(img, 0, 255).astype(np.uint8)))
        mm = np.round(np.clip(dep, 0.0, 65.535) * 1000.0).astype(np.uint16)
        np.save(os.path.join(out_dir, f"{i:06d}_depth.npy"), mm)
