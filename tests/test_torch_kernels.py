"""The seam of the port's hand-written kernels (``vo_tpu_torch/ops/kernels.py``), on the
CPU: launches counted across CUDA-graph captures (the capture is faked, so no card is
needed), the compile helper's reuse by source content (through the native loader's g++
build), and the modules that may not reach past the seam. The kernels themselves run on
the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import ast
import os
import pathlib
import shutil

import pytest
import torch

from vo_tpu_torch.io import native
from vo_tpu_torch.ops import brief, kernels, match, pnp_bank, pnp_gn

PORT = pathlib.Path(__file__).resolve().parents[1] / "vo_tpu_torch"
CPU = torch.device("cpu")


@pytest.fixture
def capturing(monkeypatch):
    """A switch for ``torch.cuda.is_current_stream_capturing``, and a fresh tally."""
    state = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: state[0])
    monkeypatch.setattr(kernels, "_captured", {})
    return state


@pytest.mark.parametrize("kernel,wrapper", [("wgmma", match.launch_wgmma),
                                            ("gn", pnp_gn.launch_gn),
                                            ("bank", pnp_bank.launch_bank),
                                            ("brief", brief.launch_brief)])
def test_capture_tally_and_replay_counts(monkeypatch, capturing, kernel, wrapper):
    """A launch while the stream captures goes to the capture's tally, not to the
    counters; ``end_capture`` hands the tally over once; each replay of the graph adds
    it to the counters; outside a capture a launch counts at once."""
    wrappers = kernels.counters()
    assert wrappers[kernel] is wrapper
    for fn in wrappers.values():
        monkeypatch.setattr(fn, "launches", 10)
    zeros = dict.fromkeys(wrappers, 0)
    kernels.begin_capture(CPU, 0)
    capturing[0] = True
    kernels.count(kernel)
    kernels.count(kernel, 2)
    kernels.count("simt")
    capture = kernels.end_capture(CPU, 0)
    assert capture.launches == {**zeros, kernel: 3, "simt": 1}
    assert kernels.end_capture(CPU, 0).launches == zeros
    assert all(fn.launches == 10 for fn in wrappers.values())
    for _ in range(4):
        capture.replayed()
    kernels.Capture({**zeros, "simt": 1}, []).replayed()
    assert {k: fn.launches for k, fn in wrappers.items()} == {
        **dict.fromkeys(wrappers, 10), kernel: 22, "simt": 15}
    capturing[0] = False
    kernels.count(kernel)
    assert wrapper.launches == 23 and kernels.end_capture(CPU, 0).launches[kernel] == 0


def test_a_registered_stand_in_is_counted_and_keeps_its_state(monkeypatch, capturing):
    """A wrapper and a per-stream cache registered from outside ``kernels.py``: its
    launches are tallied under a capture and counted at each replay, the capture
    starts from fresh state and the graph keeps the state its warm-up made."""
    monkeypatch.setattr(kernels, "_counted", dict(kernels._counted))
    monkeypatch.setattr(kernels, "_stream_state", list(kernels._stream_state))
    cache = {}

    @kernels.per_stream_state
    def take_state(dev, stream):
        return cache.pop(stream, None)

    @kernels.counted("stand_in")
    def launch_stand_in(x):
        cache.setdefault(7, f"state of stream 7 for {x}")
        kernels.count("stand_in")
        return x + 1

    assert launch_stand_in(1) == 2 and launch_stand_in.launches == 1
    assert kernels.counters()["stand_in"] is launch_stand_in
    kernels.begin_capture(CPU, 7)
    assert 7 not in cache
    launch_stand_in(2)                       # the eager warm-up makes the state
    capturing[0] = True
    launch_stand_in(3)
    launch_stand_in(4)
    capturing[0] = False
    capture = kernels.end_capture(CPU, 7)
    assert capture.launches["stand_in"] == 2 and launch_stand_in.launches == 2
    assert capture.state == ["state of stream 7 for 2"] and 7 not in cache
    for _ in range(3):
        capture.replayed()
    assert launch_stand_in.launches == 8


def test_compile_helper_reuses_a_library_until_a_source_changes(tmp_path, monkeypatch):
    """The native loader's build: the same source reuses its library (a newer mtime
    alone rebuilds nothing), a changed source builds another one beside it."""
    src = tmp_path / "vo_loader.cpp"
    shutil.copy(native._SRC, src)
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    first = native.build_loader()
    assert os.path.dirname(first) == str(tmp_path / "build")
    assert os.path.basename(first).startswith("libvoloader_")
    stamp = os.stat(first).st_mtime_ns
    os.utime(src)
    assert native.build_loader() == first and os.stat(first).st_mtime_ns == stamp
    src.write_text(src.read_text() + "\n// changed\n")
    second = native.build_loader()
    assert second != first and os.path.exists(second) and os.path.exists(first)
    lib, seconds, _ = kernels.compile_library("libvoloader", [str(src)], None)
    assert (lib, seconds) == (second, 0.0)
    assert not [p for p in os.listdir(tmp_path / "build") if p.endswith(".tmp")]


def _imports(path: pathlib.Path) -> set[str]:
    """The modules ``path`` imports, and each ``from`` module's names as dotted paths."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


def _names(path: pathlib.Path) -> set[str]:
    return {n.id if isinstance(n, ast.Name) else n.attr for n in ast.walk(
        ast.parse(path.read_text())) if isinstance(n, (ast.Name, ast.Attribute))}


def test_only_ops_reaches_into_the_kernels():
    """The streaming entry imports nothing of ``vo_tpu_torch.ops``, PnP's and BRIEF's
    kernel modules do not import the match module, and the engine names no kernel's scratch or
    tally: those stay behind ``ops/kernels.py``."""
    assert not [m for m in _imports(PORT / "engine" / "pipeline.py")
                if m.startswith("vo_tpu_torch.ops")]
    assert "vo_tpu_torch.ops.match" not in _imports(PORT / "ops" / "pnp_gn.py")
    assert "vo_tpu_torch.ops.match" not in _imports(PORT / "ops" / "pnp_bank.py")
    assert "vo_tpu_torch.ops.match" not in _imports(PORT / "ops" / "brief.py")
    for path in (PORT / "engine").glob("*.py"):
        assert not _names(path) & {"take_scratch", "take_captured", "count_replay",
                                   "_scratch", "_captured"}, path.name
