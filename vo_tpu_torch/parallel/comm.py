"""Counted collectives over a ``torch.distributed`` group.

The port's counterparts of XLA's collectives in the JAX package's ``shard_map`` and
GSPMD programs: ``all_reduce`` (``psum``), ``reduce_scatter`` (``psum_scatter`` with
``tiled=True``), ``all_to_all`` (``all_to_all`` on the leading axis) and
``all_gather`` (``all_gather`` with ``tiled=True``), on NCCL for CUDA tensors and on
gloo for CPU tensors. ``AllReduceSum`` is the differentiable sum: its backward
all-reduces the upstream gradient.

Each wrapper adds one call and the bytes of the tensor it sends to ``COUNTS`` under
(op, label), where it issues its collective and nowhere else, so a run can show which
collectives it issued and how much it passed to them: the counterpart of reading the
collectives off the compiled HLO.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

# torch 2.13 renames two collectives and warns on the old names; older releases have
# only the old ones.
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class CollectiveCounts:
    """Calls and bytes sent per (op, label), summed since the last ``reset``."""

    def __init__(self):
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def add(self, op: str, label: str, t: torch.Tensor) -> None:
        self.calls[op, label] += 1
        self.bytes[op, label] += t.numel() * t.element_size()

    def summary(self) -> dict:
        """{"op label": [calls, bytes]}, JSON-ready."""
        return {f"{op} {label}": [n, self.bytes[op, label]]
                for (op, label), n in sorted(self.calls.items())}


COUNTS = CollectiveCounts()


def all_reduce(t: torch.Tensor, group, label: str) -> torch.Tensor:
    """The sum of ``t`` over the group, in place; returns ``t``."""
    COUNTS.add("all_reduce", label, t)
    dist.all_reduce(t, group=group)
    return t


def reduce_scatter(t: torch.Tensor, group, label: str) -> torch.Tensor:
    """The sum over the group of ``t`` (n * D, ...) -> this rank's block (n, ...) of it:
    rank r keeps rows [r n, (r + 1) n)."""
    d = dist.get_world_size(group)
    out = t.new_empty((t.shape[0] // d,) + t.shape[1:])
    COUNTS.add("reduce_scatter", label, t)
    _reduce_scatter(out, t.contiguous(), group=group)
    return out


def all_to_all(t: torch.Tensor, group, label: str) -> torch.Tensor:
    """(n * D, ...) -> (D, n, ...): block s of the result is block r (this rank's) of
    rank s's input."""
    d = dist.get_world_size(group)
    out = torch.empty_like(t)
    COUNTS.add("all_to_all", label, t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out.reshape((d, t.shape[0] // d) + t.shape[1:])


def all_gather(t: torch.Tensor, group, label: str) -> torch.Tensor:
    """(n, ...) on each rank -> (n * D, ...), the ranks' blocks in rank order."""
    d = dist.get_world_size(group)
    out = t.new_empty((t.shape[0] * d,) + t.shape[1:])
    COUNTS.add("all_gather", label, t)
    _all_gather(out, t.contiguous(), group=group)
    return out


class AllReduceSum(torch.autograd.Function):
    """The sum over a group, differentiable: the backward all-reduces the upstream
    gradient, since every rank's loss depends on every rank's addend."""

    @staticmethod
    def forward(ctx, t, group, label):
        ctx.group, ctx.label = group, label
        return all_reduce(t.clone(), group, label)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group, ctx.label + " (backward)"), None, None


def all_reduce_sum(t: torch.Tensor, group, label: str) -> torch.Tensor:
    """``AllReduceSum`` applied to ``t``."""
    return AllReduceSum.apply(t, group, label)
