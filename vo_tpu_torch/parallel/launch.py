"""Run a rank function over a ``torch.distributed`` group.

``spawn`` starts ``nprocs`` processes (``torch.multiprocessing.spawn``), each of which
joins a group through a ``FileStore`` in a fresh temporary directory (no TCP port,
so concurrent launches cannot collide), calls ``fn(rank, *args)`` and writes what it
returns to a file that ``spawn`` reads back. ``run_one_rank`` runs ``fn(0, *args)``
in the calling process over a group of one rank: kernels it launches are counted in
this process, and its result is returned as it is.

NCCL runs on CUDA devices and gloo on the CPU; any other pairing raises. On the CPU
each rank runs one thread; on the card rank r takes device r.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = datetime.timedelta(seconds=600)


def check_backend(backend: str, device: str) -> None:
    """NCCL needs ``cuda`` and gloo ``cpu``: no silent switch of either."""
    want = {"nccl": "cuda", "gloo": "cpu"}.get(backend)
    if want is None:
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if torch.device(device).type != want:
        raise ValueError(f"backend {backend!r} runs on {want} devices, not {device!r}")
    if want == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass backend='gloo', device='cpu'")


def _join(rank: int, world: int, backend: str, device: str, store_dir: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method="file://" + os.path.join(store_dir, "store"),
                            rank=rank, world_size=world, timeout=TIMEOUT)


def to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _rank_main(rank, fn, world, backend, device, store_dir, args):
    _join(rank, world, backend, device, store_dir)
    try:
        out = fn(rank, *args) or {}
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(store_dir, f"rank{rank}.npz"),
             **{k: to_numpy(v) for k, v in out.items()})


def spawn(fn, nprocs: int, backend: str, device: str, *args) -> list[dict]:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes; returns each rank's result
    as a dict of numpy arrays, in rank order. ``fn`` must be importable (a module-level
    function) and return a flat dict of tensors, arrays, numbers or strings, or None."""
    check_backend(backend, device)
    with tempfile.TemporaryDirectory(prefix="vo_dist_") as store_dir:
        mp.spawn(_rank_main, args=(fn, nprocs, backend, device, store_dir, args),
                 nprocs=nprocs, join=True)
        results = []
        for r in range(nprocs):
            with np.load(os.path.join(store_dir, f"rank{r}.npz"), allow_pickle=False) as f:
                results.append({k: f[k] for k in f.files})
    return results


def run_one_rank(fn, backend: str, device: str, *args):
    """``fn(0, *args)`` in this process over a group of one rank; the group is destroyed
    before this returns."""
    check_backend(backend, device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    with tempfile.TemporaryDirectory(prefix="vo_dist_") as store_dir:
        threads = torch.get_num_threads()
        _join(0, 1, backend, device, store_dir)
        try:
            return fn(0, *args)
        finally:
            dist.destroy_process_group()
            torch.set_num_threads(threads)


def run(fn, nprocs: int, backend: str, device: str, *args) -> list[dict]:
    """``fn(rank, *args)`` over ``nprocs`` ranks, in this process for one rank and in
    spawned processes for more; each rank's result as a dict of numpy arrays."""
    if nprocs == 1:
        return [{k: to_numpy(v) for k, v in (run_one_rank(fn, backend, device, *args)
                                             or {}).items()}]
    return spawn(fn, nprocs, backend, device, *args)
