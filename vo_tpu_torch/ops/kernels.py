"""The one place that knows how the port's native code is built (``compile_library``)
and loaded (``library``, ``entry``), and how kernel launches are counted across CUDA
graph captures (``counted``, ``count``, ``begin_capture``, ``end_capture``). Each kernel
module declares its own entry points and registers its wrappers; no kernel is named
here, and importing this module builds nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, NamedTuple

import torch

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")
_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


def compile_library(name: str, sources: list[str],
                    command: Callable[[str], list[str]]) -> tuple[str, float, str]:
    """Build ``BUILD_DIR/<name>_<12 hex of the sha256 of the sources' names and
    contents>.so`` with ``command(out)``, unless it exists -> (path, seconds, the
    compiler's stderr). The compiler writes a temporary file that is renamed into
    place, so processes that build at once never load a half-written library."""
    digest = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    lib = os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = command(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        with contextlib.suppress(FileNotFoundError):
            os.remove(tmp)
        raise RuntimeError(f"building {name} failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, proc.stderr


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (shutil.which("nvcc"), CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def build_kernels() -> tuple[str, float, str]:
    """Compile every ``.cu`` of ``csrc/`` for sm_90a into one library -> (path, seconds,
    compiler output with ptxas's register and spill lines)."""
    files = sorted(glob.glob(os.path.join(_CSRC, "*.cu*")))
    return compile_library("libvo_kernels", files, lambda out: [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", out,
        *(f for f in files if f.endswith(".cu"))])


_lib = None


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded at the first call."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build_kernels()[0])
    return _lib


@contextlib.contextmanager
def library_at(path: str):
    """Within the block the kernels launch from the library at ``path``."""
    global _lib
    saved, _lib = _lib, ctypes.CDLL(path)
    try:
        yield
    finally:
        _lib = saved


def entry(name: str, argtypes: list, restype=ctypes.c_int):
    """The kernel library's entry point ``name`` with its signature."""
    fn = getattr(library(), name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


# Registered wrappers, launches tallied by the current capture (both by kernel name), and
# the takers of per-stream state.
_counted: dict = {}
_captured: dict = {}
_stream_state: list = []


def counted(name: str):
    """Register a kernel's wrapper: its ``launches`` counts the kernel's launches."""
    def register(fn):
        fn.launches = 0
        _counted[name] = fn
        return fn
    return register


def counters() -> dict:
    """The registered wrappers by kernel name."""
    return dict(_counted)


def count(name: str, n: int = 1) -> None:
    """``n`` launches of kernel ``name``: on its wrapper's ``launches``, or on the
    capture's tally when the current stream is capturing a CUDA graph."""
    fn = _counted[name]
    if torch.cuda.is_current_stream_capturing():
        _captured[name] = _captured.get(name, 0) + n
    else:
        fn.launches += n


def per_stream_state(take):
    """Register ``take(dev, stream)``: it takes a kernel module's state for ``stream``
    (a ``cuda_stream`` handle) out of the module's cache -> that state, or None."""
    _stream_state.append(take)
    return take


class Capture(NamedTuple):
    """What a CUDA graph holds of the kernels: its launches by kernel name, and the
    per-stream state it keeps alive."""

    launches: dict
    state: list

    def replayed(self) -> None:
        """Count one replay of the graph."""
        for name, n in self.launches.items():
            _counted[name].launches += n


def begin_capture(dev, stream: int) -> None:
    """Before the eager warm-up of a capture on ``stream``: fresh per-stream state for
    the kernels there, and a new tally."""
    for take in _stream_state:
        take(dev, stream)
    _captured.clear()


def end_capture(dev, stream: int) -> Capture:
    """After the capture: its tally, and its per-stream state, out of the kernels'
    caches so that no later call on that stream (torch hands streams out from a pool),
    and no later capture, can regrow or share it."""
    state = [s for s in (take(dev, stream) for take in _stream_state) if s is not None]
    launches = {name: _captured.get(name, 0) for name in _counted}
    _captured.clear()
    return Capture(launches, state)
