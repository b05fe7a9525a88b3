"""Descriptor matching as one similarity GEMM + fixed-shape row/column reductions.

Port of ``vo_tpu/matching/matchers.py``. Results are per-row ``(idx, mask, sim)``
tensors. Binary (+-1) descriptors use hamming = (D - a.b) / 2. The similarity is
accumulated in fp32; +-1 bf16 products are exact there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_NEG = -1e30


class MatchResult(NamedTuple):
    """Fixed-shape matches from set A (rows) into set B."""

    idx: torch.Tensor   # (Na,) index into B
    mask: torch.Tensor  # (Na,) bool, passed all tests
    sim: torch.Tensor   # (Na,) similarity of the accepted pair (0 where masked)


def similarity_matrix(desc_a, desc_b, valid_a=None, valid_b=None) -> torch.Tensor:
    """(Na, D) x (Nb, D) -> (Na, Nb) fp32; invalid rows/cols pushed to -1e30."""
    sim = desc_a.to(torch.float32) @ desc_b.to(torch.float32).T
    if valid_a is not None:
        sim = torch.where(valid_a[:, None], sim, _NEG)
    if valid_b is not None:
        sim = torch.where(valid_b[None, :], sim, _NEG)
    return sim


def _top2(sim: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row argmax and [best, second], second excluding only the argmax column."""
    best = torch.argmax(sim, dim=1)
    rows = torch.arange(sim.shape[0], device=sim.device)
    best_sim = sim[rows, best]
    sim_wo_best = sim.clone()
    # The fill value as a device tensor: a Python scalar would be copied up from the host,
    # which waits on the stream and cannot be captured in a CUDA graph.
    sim_wo_best[rows, best] = torch.full((), _NEG, dtype=sim.dtype, device=sim.device)
    second_sim = torch.amax(sim_wo_best, dim=1)
    return best, torch.stack([best_sim, second_sim], dim=1)


def _unit_dist(s: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(2.0 - 2.0 * torch.clamp(s, -1.0, 1.0), min=0.0))


def mutual_nn_match(desc_a, desc_b, valid_a=None, valid_b=None,
                    threshold: float = 0.9) -> MatchResult:
    """Mutual nearest neighbours with a similarity floor."""
    sim = similarity_matrix(desc_a, desc_b, valid_a, valid_b)
    nn12 = torch.argmax(sim, dim=1)
    nn21 = torch.argmax(sim, dim=0)
    ids = torch.arange(sim.shape[0], device=sim.device)
    best_sim = sim[ids, nn12]
    mask = (best_sim >= threshold) & (nn21[nn12] == ids)
    return MatchResult(idx=nn12, mask=mask, sim=torch.where(mask, best_sim, 0.0))


def _ratio_mask(top2_sim, ratio: float, binary_dim: int | None = None, valid_a=None):
    """Lowe ratio on the top-2 similarities' distances (hamming with ``binary_dim``)."""
    if binary_dim is not None:
        d1 = (binary_dim - top2_sim[:, 0]) * 0.5
        d2 = (binary_dim - top2_sim[:, 1]) * 0.5
    else:
        d1 = _unit_dist(top2_sim[:, 0])
        d2 = _unit_dist(top2_sim[:, 1])
    mask = d1 < ratio * d2
    if valid_a is not None:
        mask = mask & valid_a
    # Rows whose best hit was an invalid (masked) column carry sim ~ _NEG: drop them.
    return mask & (top2_sim[:, 0] > _NEG * 0.5)


def _mutual_ratio_mask(nn12, top2_sim, nn21, ratio: float, valid_a=None):
    """Mutual-NN + Lowe ratio on the top-2 similarities' unit-descriptor L2 distances."""
    dists = _unit_dist(top2_sim)
    ratios = dists[:, 0] / (dists[:, 1] + 1e-8)
    ids = torch.arange(nn12.shape[0], dtype=nn12.dtype, device=nn12.device)
    mask = (nn21[nn12.long()] == ids) & (ratios <= ratio)
    if valid_a is not None:
        mask = mask & valid_a
    return mask


def _result(nn12, top2_sim, mask) -> MatchResult:
    return MatchResult(idx=nn12.long(), mask=mask,
                       sim=torch.where(mask, top2_sim[:, 0], 0.0))


def ratio_mutual_nn_match(desc_a, desc_b, valid_a=None, valid_b=None,
                          ratio: float = 0.90) -> MatchResult:
    """Lowe ratio on unit-descriptor L2 distances + mutual-NN."""
    sim = similarity_matrix(desc_a, desc_b, valid_a, valid_b)
    nn12, top2_sim = _top2(sim)
    nn21 = torch.argmax(sim, dim=0)
    return _result(nn12, top2_sim, _mutual_ratio_mask(nn12, top2_sim, nn21, ratio, valid_a))


def ratio_match(desc_a, desc_b, valid_a=None, valid_b=None, ratio: float = 0.85,
                binary_dim: int | None = None) -> MatchResult:
    """kNN(k=2) + Lowe ratio on distances (hamming when ``binary_dim`` is given)."""
    sim = similarity_matrix(desc_a, desc_b, valid_a, valid_b)
    nn12, top2_sim = _top2(sim)
    return _result(nn12, top2_sim, _ratio_mask(top2_sim, ratio, binary_dim, valid_a))


def matches_to_pairs(result: MatchResult) -> np.ndarray:
    """The accepted matches as a host (M, 2) int64 array of [idx_a, idx_b] rows."""
    idx = result.idx.cpu().numpy()
    rows = np.nonzero(result.mask.cpu().numpy())[0]
    return np.stack([rows, idx[rows]], axis=1) if rows.size else np.zeros((0, 2), np.int64)
