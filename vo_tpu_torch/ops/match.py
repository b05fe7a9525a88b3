"""Fused descriptor matching: the counterpart of ``vo_tpu/ops/pallas_match.py``.

``top2_mutual`` returns (nn12, top2_sim, nn21), everything the ratio and mutual-NN
matchers need, without materialising the (Na, Nb) similarity matrix:
- on a CPU tensor it runs ``top2_mutual_plain``, the plain PyTorch version;
- on a CUDA tensor it launches one of two hand-written kernels (built at first use and
  bound through ctypes by ``ops/kernels.py``) or raises. bf16 operands go to the
  tensor-core kernel in ``csrc/match_wgmma.cu`` (``launch_wgmma``), fp32 operands to
  the CUDA-core kernel in ``csrc/match_kernel.cu`` (``launch_simt``). Both take one
  launch per call, cut the call alike (``match_grid``) and share their cached scratch.
  There is no fallback from the card to the plain version or from one kernel to the
  other.

``launch_wgmma.launches`` and ``launch_simt.launches`` count kernel launches, so a run
can show that its matches went through a kernel; a launch recorded into a CUDA graph is
counted at each replay (``ops/kernels.py``). A graph keeps the scratch of its capture
stream (``take_scratch``). The fused matchers apply the plain matchers' rules
(``matching/matchers.py``) to the kernels' top-2.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vo_tpu_torch.matching.matchers import (MatchResult, _mutual_ratio_mask, _ratio_mask,
                                            _result)
from vo_tpu_torch.ops import kernels

_NEG = -1e30
# The match kernels' C entry points (``csrc/match_kernel.cu``, ``csrc/match_wgmma.cu``).
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P]


def _col_key(value: float, row: int) -> int:
    """The kernels' packed column key (``match_common.cuh: col_key``): unsigned order
    is the order of the fp32 value, then of the lower row."""
    (u,) = struct.unpack("<I", struct.pack("<f", value + 0.0))   # -0 -> +0
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | (0xFFFFFFFF - row)


def _col_key_init() -> int:
    """The key of (-1e30, row 0): XLA's argmax of an all-invalid column."""
    return _col_key(_NEG, 0)


class MatchGrid(NamedTuple):
    """How a kernel cuts (Na, Nb, D): ``n_row_tiles`` x ``splits`` blocks, each over
    ``tiles_per_split`` tiles of ``bn`` columns (the last split may hold fewer);
    operands padded along D to ``d_pad``."""

    bm: int
    bn: int
    n_row_tiles: int
    n_col_tiles: int
    splits: int
    tiles_per_split: int
    d_pad: int

    @property
    def cols_per_split(self) -> int:
        return self.tiles_per_split * self.bn


def match_grid(na: int, nb: int, d: int, bf16: bool, sms: int) -> MatchGrid:
    """The grid of a call on a card with ``sms`` SMs.

    Both kernels: 128 x 128 tiles, one block per SM (each holds ~130 KiB of shared
    memory for its operand ring), D padded to 16 bytes (TMA needs 16-byte row strides:
    a multiple of 8 in bf16, of 4 in fp32). The columns are cut into as many splits as
    fill the SMs, none of them empty.
    """
    tile = 128
    step = 8 if bf16 else 4
    d_pad = -(-d // step) * step
    n_row_tiles = -(-na // tile)
    n_col_tiles = -(-nb // tile)
    splits = min(max(1, sms // n_row_tiles), n_col_tiles)
    tiles_per_split = -(-n_col_tiles // splits)
    splits = -(-n_col_tiles // tiles_per_split)
    return MatchGrid(tile, tile, n_row_tiles, n_col_tiles, splits, tiles_per_split, d_pad)


def _prepare(desc_a, desc_b, valid_a, valid_b, bf16):
    """Validate the operands and bring them to the working dtype."""
    for name, t in (("desc_a", desc_a), ("desc_b", desc_b)):
        if t.ndim != 2:
            raise ValueError(f"{name} must be (N, D), got shape {tuple(t.shape)}")
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name} must be bf16 or fp32, got {t.dtype}")
    if desc_a.shape[1] != desc_b.shape[1]:
        raise ValueError(f"descriptor widths differ: {desc_a.shape[1]} vs {desc_b.shape[1]}")
    if desc_a.device != desc_b.device:
        raise ValueError(f"descriptors on {desc_a.device} and {desc_b.device}")
    na, nb = desc_a.shape[0], desc_b.shape[0]
    if valid_a is None:
        valid_a = torch.ones(na, dtype=torch.bool, device=desc_a.device)
    if valid_b is None:
        valid_b = torch.ones(nb, dtype=torch.bool, device=desc_b.device)
    for name, v, n in (("valid_a", valid_a, na), ("valid_b", valid_b, nb)):
        if v.dtype != torch.bool or v.shape != (n,) or v.device != desc_a.device:
            raise ValueError(f"{name} must be a ({n},) bool tensor on {desc_a.device}")
    dt = torch.bfloat16 if bf16 else torch.float32
    return desc_a.to(dt), desc_b.to(dt), valid_a, valid_b


def top2_mutual_plain(desc_a, desc_b, valid_a=None, valid_b=None, bf16: bool = False):
    """Plain PyTorch version: (nn12 (Na,) int32, top2 (Na, 2) fp32, nn21 (Nb,) int32).

    The similarity is the fp32 product of the operands rounded to bf16 when ``bf16``
    (exact for +-1 descriptors), else of the fp32 operands.
    """
    a, b, va, vb = _prepare(desc_a, desc_b, valid_a, valid_b, bf16)
    sim = a.to(torch.float32) @ b.to(torch.float32).T
    sim = torch.where(va[:, None] & vb[None, :], sim, _NEG)
    nn21 = torch.argmax(sim, dim=0)
    nn12 = torch.argmax(sim, dim=1)
    best = sim.gather(1, nn12[:, None])[:, 0]
    second = torch.amax(sim.scatter_(1, nn12[:, None], _NEG), dim=1)
    return (nn12.to(torch.int32), torch.stack([best, second], dim=1),
            nn21.to(torch.int32))


def _check_operands(a, b, va, vb):
    if not all(t.is_contiguous() for t in (a, b, va, vb)):
        raise ValueError("descriptors and masks must be contiguous")
    na, d = a.shape
    nb = b.shape[0]
    if na == 0 or nb == 0 or d == 0:
        raise ValueError(f"empty descriptor set: ({na}, {d}) x ({nb}, {d})")
    return na, nb, d


def _outputs(na, nb, dev):
    return (torch.empty(na, dtype=torch.int32, device=dev),
            torch.empty((na, 2), dtype=torch.float32, device=dev),
            torch.empty(nb, dtype=torch.int32, device=dev))


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# The kernels' scratch, per (device, stream): partial rows, column keys and tickets.
# Each kernel leaves the keys and tickets as it found them, so they are filled only
# when the scratch is made or grown, and both kernels share it. A CUDA graph that
# captured launches keeps their scratch (``take_scratch``), which then never changes.
_scratch: dict = {}


@kernels.per_stream_state
def take_scratch(dev, stream: int) -> dict | None:
    """Take the scratch of ``stream`` (a ``cuda_stream`` handle) out of the cache."""
    return _scratch.pop((dev.index, stream), None)


def _match_scratch(dev, stream, n_part, nb, n_tickets):
    key = (dev.index, stream)
    s = _scratch.get(key)
    if torch.cuda.is_current_stream_capturing() and (
            s is None or s["best"].numel() < n_part or s["colkey"].numel() < nb
            or s["tickets"].numel() < n_tickets):
        raise RuntimeError("a CUDA graph capture would make the match scratch: run the "
                           "call once on the capture stream before capturing it")
    if s is None or s["best"].numel() < n_part:
        n = max(n_part, 0 if s is None else s["best"].numel())
        s = dict(s or {}, best=torch.empty(n, dtype=torch.float32, device=dev),
                 sec=torch.empty(n, dtype=torch.float32, device=dev),
                 idx=torch.empty(n, dtype=torch.int32, device=dev))
    if "colkey" not in s or s["colkey"].numel() < nb:
        s["colkey"] = torch.full((nb,), _col_key_init(), dtype=torch.int64, device=dev)
    if "tickets" not in s or s["tickets"].numel() < n_tickets:
        s["tickets"] = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
    _scratch[key] = s
    return s


def _aligned16(t):
    """TMA needs a 16-byte aligned base address: copy a view that lacks it."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(kernel, label, a, b, va, vb, bf16):
    """One launch of the C entry point ``vo_top2_mutual_<kernel>`` on (Na, D) x (Nb, D),
    bf16 or fp32 operands as ``bf16`` says. A D that is not a multiple of 16 bytes is
    padded with zero columns here, which leaves every product as it was."""
    if a.dtype != b.dtype or a.dtype != (torch.bfloat16 if bf16 else torch.float32):
        raise TypeError(f"the {label} kernel takes {'bf16' if bf16 else 'fp32'} operands, "
                        f"got {a.dtype}, {b.dtype}")
    entry = kernels.entry(f"vo_top2_mutual_{kernel}", _ARGTYPES)
    na, nb, d = _check_operands(a, b, va, vb)
    dev = a.device
    g = match_grid(na, nb, d, bf16, _sms(dev))
    if g.d_pad != d:
        a, b = F.pad(a, (0, g.d_pad - d)), F.pad(b, (0, g.d_pad - d))
    a, b = _aligned16(a), _aligned16(b)
    stream = torch.cuda.current_stream(dev).cuda_stream
    s = _match_scratch(dev, stream, g.splits * na, nb, g.n_row_tiles + g.splits)
    nn12, top2, nn21 = _outputs(na, nb, dev)
    with torch.cuda.device(dev):
        err = entry(
            a.data_ptr(), b.data_ptr(), va.data_ptr(), vb.data_ptr(), na, nb, g.d_pad,
            g.n_row_tiles, g.splits, g.tiles_per_split, s["best"].data_ptr(),
            s["sec"].data_ptr(), s["idx"].data_ptr(), s["colkey"].data_ptr(),
            s["tickets"].data_ptr(), nn12.data_ptr(), top2.data_ptr(), nn21.data_ptr(),
            stream)
    if err != 0:
        _scratch.pop((dev.index, stream), None)   # a failed launch may leave it dirty
        raise RuntimeError(f"{label} match kernel launch failed: error {err}")
    kernels.count(kernel)
    return nn12, top2, nn21


@kernels.counted("simt")
def launch_simt(a, b, va, vb):
    """The CUDA-core kernel on fp32 (Na, D) x (Nb, D): one launch."""
    return _launch("simt", "SIMT", a, b, va, vb, False)


@kernels.counted("wgmma")
def launch_wgmma(a, b, va, vb):
    """The tensor-core kernel on bf16 (Na, D) x (Nb, D): one launch."""
    return _launch("wgmma", "wgmma", a, b, va, vb, True)


def top2_mutual(desc_a, desc_b, valid_a=None, valid_b=None, bf16: bool = False):
    """Fused (nn12, top2_sim, nn21): the plain version on the CPU, a kernel on CUDA.

    bf16=True rounds the operands to bf16 (exact for +-1 descriptors) before the fp32
    accumulation, as the TPU kernel does, and takes the wgmma kernel; bf16=False takes
    the fp32 operands to the SIMT kernel.
    """
    if desc_a.device.type == "cpu":
        return top2_mutual_plain(desc_a, desc_b, valid_a, valid_b, bf16)
    if desc_a.device.type != "cuda":
        raise ValueError(f"top2_mutual runs on cpu or cuda, not {desc_a.device}")
    launch = launch_wgmma if bf16 else launch_simt
    return launch(*_prepare(desc_a, desc_b, valid_a, valid_b, bf16))


def ratio_mutual_nn_match_fused(desc_a, desc_b, valid_a=None, valid_b=None,
                                ratio: float = 0.90, bf16: bool = False) -> MatchResult:
    """Lowe ratio on unit-descriptor L2 distances + mutual-NN, through ``top2_mutual``.

    Like ``ratio_mutual_nn_match_pallas`` it also drops rows whose best hit is masked,
    which ``matchers.ratio_mutual_nn_match`` does not (they differ only when every
    column is invalid).
    """
    nn12, top2_sim, nn21 = top2_mutual(desc_a, desc_b, valid_a, valid_b, bf16=bf16)
    mask = _mutual_ratio_mask(nn12, top2_sim, nn21, ratio, valid_a)
    return _result(nn12, top2_sim, mask & (top2_sim[:, 0] > _NEG * 0.5))


def ratio_match_fused(desc_a, desc_b, valid_a=None, valid_b=None, ratio: float = 0.85,
                      binary_dim: int | None = None, bf16: bool | None = None) -> MatchResult:
    """kNN(k=2) + Lowe ratio through ``top2_mutual``; bf16 defaults on for binary."""
    if bf16 is None:
        bf16 = binary_dim is not None
    nn12, top2_sim, _ = top2_mutual(desc_a, desc_b, valid_a, valid_b, bf16=bf16)
    return _result(nn12, top2_sim, _ratio_mask(top2_sim, ratio, binary_dim, valid_a))
