"""A drive on disk as a logged RGB-D sequence is stored: ``{i:06d}.png`` (8-bit gray,
every row with filter 0, zlib level 6) and ``{i:06d}_depth.npy`` (``<u2``
millimetres), the layout the program's loaders read."""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def encode_png_gray(img: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit grayscale, non-interlaced PNG of ``img`` (H, W) uint8."""
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


def write_drive(out_dir: str, gray: np.ndarray, mm: np.ndarray, threads: int = 4) -> None:
    """Write every frame of (F, H, W) uint8 ``gray`` and uint16 ``mm`` under
    ``out_dir`` (zlib releases the interpreter lock, so a few threads share the
    encoding)."""
    os.makedirs(out_dir, exist_ok=True)

    def one(i: int) -> None:
        with open(os.path.join(out_dir, f"{i:06d}.png"), "wb") as f:
            f.write(encode_png_gray(gray[i]))
        np.save(os.path.join(out_dir, f"{i:06d}_depth.npy"), mm[i].astype("<u2"))

    with ThreadPoolExecutor(threads) as pool:
        for fut in [pool.submit(one, i) for i in range(gray.shape[0])]:
            fut.result()
