"""Device meshes and data sharding over ``torch.distributed`` ranks.

Port of ``vo_tpu/parallel/mesh.py``. The JAX package names a ``jax.sharding.Mesh``
of devices and lets XLA place the work; here every rank is a process with one device,
the mesh is a ``DeviceMesh`` over the initialised default group, and a rank takes its
own block of the data explicitly.

Axis conventions, as in the JAX package:
  - ``data``  : frames / batch (extraction, training batch): pure data parallelism;
  - ``model`` : the BA landmark and keyframe blocks (``ba/distributed.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type() -> str:
    """``cuda`` under NCCL, ``cpu`` under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_data: int | None = None, n_model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over every rank of the default group, rank-major: ranks
    r * n_model ... (r + 1) * n_model - 1 form data row r."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"{n_data}x{n_model} != {world} ranks")
    return DeviceMesh(_device_type(), torch.arange(world).reshape(n_data, n_model),
                      mesh_dim_names=("data", "model"))


def make_mesh_1d(axis: str) -> DeviceMesh:
    """A one-axis mesh named ``axis`` over every rank of the default group."""
    return DeviceMesh(_device_type(), torch.arange(dist.get_world_size()),
                      mesh_dim_names=(axis,))


def shard_frames(mesh: DeviceMesh, *arrays):
    """This rank's contiguous block of each array's leading (frame / batch) axis along
    ``data``; the ranks of one ``model`` row get the same block. The axis must split
    evenly, as ``device_put`` with ``P("data")`` requires."""
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    r = mesh.get_local_rank("data")
    out = []
    for a in arrays:
        if a.shape[0] % n:
            raise ValueError(f"leading axis {a.shape[0]} does not split over {n} ranks")
        b = a.shape[0] // n
        out.append(a[r * b:(r + 1) * b])
    return out[0] if len(out) == 1 else tuple(out)
