"""Fixed-order segment sums: the port's ``jax.ops.segment_sum``.

``index_add_`` sums with atomics on CUDA, so the order of the additions, and with it
the last bits of each sum, changes from run to run. Here the ids are sorted once
(stable, so each segment keeps its values in their original order), and each segment
is summed by ``torch.segment_reduce`` over the sorted values: one thread per output
element adds its segment's values one after another. The same inputs give the same
bits on every call; on the CPU the result equals ``index_add_``'s.

A problem's ids stay fixed over its solver iterations: ``segments`` sorts them once
and ``segment_sum`` reuses the plan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Segments(NamedTuple):
    """A sorted grouping of ids into ``num_segments`` segments."""

    perm: torch.Tensor      # (n,) stable order of the ids
    offsets: torch.Tensor   # (num_segments + 1,) start of each segment in that order


def segments(ids: torch.Tensor, num_segments: int) -> Segments:
    """The plan for ``segment_sum`` over (n,) int ``ids`` in [0, num_segments).
    No host synchronisation."""
    ids = ids.reshape(-1)
    sorted_ids, perm = torch.sort(ids, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=sorted_ids.dtype, device=ids.device)
    return Segments(perm, torch.searchsorted(sorted_ids, bounds))


def segment_sum(values: torch.Tensor, ids: torch.Tensor | Segments,
                num_segments: int | None = None) -> torch.Tensor:
    """(n, ...) values summed by id -> (num_segments, ...); empty segments are 0.

    ``ids`` is an (n,) int tensor (then ``num_segments`` is required) or a plan from
    ``segments``."""
    plan = ids if isinstance(ids, Segments) else segments(ids, num_segments)
    return torch.segment_reduce(values[plan.perm], "sum", offsets=plan.offsets, axis=0,
                                unsafe=True)
