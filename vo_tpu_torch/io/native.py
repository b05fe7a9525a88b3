"""ctypes binding of the native prefetching RGB-D loader (``native/vo_loader.cpp``).

Port of ``vo_tpu/io/native.py``. The port builds the loader itself, at first use:
``g++`` with the flags of ``native/Makefile`` into ``vo_tpu_torch/_build/libvoloader_
<hash of the source>.so`` (``ops/kernels.py::compile_library``). A failed build raises
with the compiler's output. ``NativeRGBDSequence.try_open`` returns ``None`` only where
the loader's ``vol_open`` does: a directory without frame pairs, or a first PNG that
does not decode.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from vo_tpu_torch.ops.kernels import compile_library

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "native", "vo_loader.cpp")

_lib = None
_lock = threading.Lock()


def build_loader() -> str:
    """Compile the loader unless a library built from the same source exists; -> its
    path."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found to build the native loader")
    return compile_library("libvoloader", [_SRC], lambda out: [
        cxx, "-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", _SRC, "-o", out, "-lz",
        "-lpthread"])[0]


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_loader())
            p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
            lib.vol_open.restype = p
            lib.vol_open.argtypes = [ctypes.c_char_p, i, i]
            lib.vol_meta.restype = i
            lib.vol_meta.argtypes = [p, ip, ip, ip]
            lib.vol_next.restype = i
            lib.vol_next.argtypes = [p, p, p]
            lib.vol_next2.restype = i
            lib.vol_next2.argtypes = [p, i, i, p, p]
            lib.vol_close.restype = None
            lib.vol_close.argtypes = [p]
            _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the loader builds and loads here (built at the first call)."""
    try:
        _load_lib()
    except (OSError, RuntimeError):
        return False
    return True


class NativeRGBDSequence:
    """Streaming reader over (*.png, *_depth.npy) pairs with C++ decode + prefetch."""

    def __init__(self, handle, lib, n_frames, H, W):
        self._h = handle
        self._lib = lib
        self.n_frames = n_frames
        self.H = H
        self.W = W
        self._emitted = 0

    @classmethod
    def try_open(cls, img_dir: str, prefetch_depth: int = 8,
                 n_threads: int = 0) -> "NativeRGBDSequence | None":
        lib = _load_lib()
        h = lib.vol_open(img_dir.encode(), prefetch_depth, n_threads)
        if not h:
            return None
        n, H, W = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        lib.vol_meta(h, ctypes.byref(n), ctypes.byref(H), ctypes.byref(W))
        return cls(h, lib, n.value, H.value, W.value)

    def __len__(self):
        return self.n_frames

    def _next_into(self, img_fmt: int, depth_fmt: int, img: np.ndarray,
                   depth: np.ndarray) -> bool:
        """Decode the next frame into ``img`` and ``depth``; False at the end.
        ctypes releases the GIL for the call."""
        rc = self._lib.vol_next2(self._h, img_fmt, depth_fmt,
                                 img.ctypes.data_as(ctypes.c_void_p),
                                 depth.ctypes.data_as(ctypes.c_void_p))
        if rc == -2:
            return False
        if rc != 0:
            raise RuntimeError(f"native loader: decode failure rc={rc} "
                               f"at frame {self._emitted}")
        self._emitted += 1
        return True

    def next_frame(self) -> tuple[np.ndarray, np.ndarray] | None:
        """Sequential read: (rgb uint8 (H, W, 3), depth f32 (H, W)) or None at the end.

        Raises RuntimeError on a decode failure (corrupt frame)."""
        if self._emitted >= self.n_frames:
            return None
        rgb = np.empty((self.H, self.W, 3), np.uint8)
        depth = np.empty((self.H, self.W), np.float32)
        return (rgb, depth) if self._next_into(0, 0, rgb, depth) else None

    def __iter__(self):
        while True:
            fr = self.next_frame()
            if fr is None:
                return
            yield fr

    def iter_batches(self, batch: int, limit: int = 0, gray: bool = False,
                     depth: str = "f32"):
        """Yield (start, imgs (B, H, W[, 3]) uint8, depth (B, H, W)) fixed-size batches;
        the tail is padded by repeating the final frame (as ``RGBDSequence``). The C++
        prefetch pool keeps decoding ahead while the caller computes.

        ``gray=True`` emits single-channel uint8 (BT.601 luma for colour sources) and
        ``depth="u16mm"`` rounded uint16 millimetres: the fewest bytes to move. The
        loader writes straight into the batch arrays. ``start`` is the absolute frame
        index of the shared sequential cursor, and ``limit`` counts from frame 0.
        """
        if depth not in ("f32", "u16mm"):
            raise ValueError(f"depth must be 'f32' or 'u16mm', got {depth!r}")
        n = self.n_frames if not limit else min(limit, self.n_frames)
        img_fmt, depth_fmt = int(gray), int(depth == "u16mm")
        ishape = (batch, self.H, self.W) if gray else (batch, self.H, self.W, 3)
        start = self._emitted
        while start < n:
            imgs = np.empty(ishape, np.uint8)
            deps = np.empty((batch, self.H, self.W), np.uint16 if depth_fmt else np.float32)
            got = 0
            while got < min(batch, n - start) and self._next_into(img_fmt, depth_fmt,
                                                                  imgs[got], deps[got]):
                got += 1
            if got == 0:
                return
            imgs[got:] = imgs[got - 1]   # pad the tail with the final frame
            deps[got:] = deps[got - 1]
            yield start, imgs, deps
            start += batch

    def close(self):
        if self._h:
            self._lib.vol_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
