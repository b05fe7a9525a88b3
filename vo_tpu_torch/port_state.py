"""Carry configuration and a running VO state across from the JAX package.

What moves is configuration (the JAX dataclasses, given as ``dataclasses.asdict``
dicts), the engine's loop carry (``VOState``, given in the ``save_vo_checkpoint`` npz
layout), so that a run started with the JAX package can be continued by the port, a
bundle-adjustment problem (``BAProblem``'s arrays), and the R2D2 patchnet's learned
parameters (its params pytree as numpy arrays).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from vo_tpu_torch.ba.bundle_adjust import BAConfig, BAProblem
from vo_tpu_torch.ba.pose_graph import PoseGraphConfig
from vo_tpu_torch.device import resolve_device, to_device
from vo_tpu_torch.engine.loop_closure import LoopClosureConfig
from vo_tpu_torch.engine.refine import RefineConfig
from vo_tpu_torch.engine.vo import VOConfig, VOState
from vo_tpu_torch.estimation.pnp import PnPConfig
from vo_tpu_torch.features.extractor import OrbLikeExtractor


def config_from_jax(fields: Mapping):
    """The port's counterpart of a JAX config dataclass, from its fields.

    Which dataclass is meant follows from the fields: ``matcher`` (VOConfig, whose
    nested ``pnp`` dict becomes a PnPConfig and whose ``use_pallas_match`` becomes
    ``use_match_kernel``), ``n_hypotheses`` (PnPConfig), ``max_kp`` (extractor),
    ``obs_per_pose`` (RefineConfig, nested ``ba``), ``min_gap`` (LoopClosureConfig,
    nested ``pgo``), ``damping_init`` (BAConfig) or ``fix_first`` (PoseGraphConfig).
    """
    fields = dict(fields)
    if "matcher" in fields:
        fields["pnp"] = config_from_jax(fields["pnp"])
        fields["use_match_kernel"] = fields.pop("use_pallas_match")
        return VOConfig(**fields)
    if "n_hypotheses" in fields:
        fields["anneal"] = tuple(fields["anneal"])
        return PnPConfig(**fields)
    if "max_kp" in fields:
        return OrbLikeExtractor(**fields)
    if "obs_per_pose" in fields:
        fields["ba"] = config_from_jax(fields["ba"])
        return RefineConfig(**fields)
    if "min_gap" in fields:
        fields["pgo"] = config_from_jax(fields["pgo"])
        return LoopClosureConfig(**fields)
    if "damping_init" in fields:
        return BAConfig(**fields)
    if "fix_first" in fields:
        return PoseGraphConfig(**fields)
    raise ValueError(f"unrecognised config fields: {sorted(fields)}")


def ba_problem_from_numpy(problem, device: str | torch.device | None = None) -> BAProblem:
    """The port's BAProblem on ``device`` (default cuda) from the JAX one's arrays:
    a ``BAProblem`` of arrays (anything with its fields) or a mapping of them.
    ``obs_z`` may be absent or None."""
    fields = dict(problem) if isinstance(problem, Mapping) else problem._asdict()
    dev = resolve_device(device)
    return BAProblem(*(None if fields.get(k) is None else to_device(np.asarray(fields[k]), dev)
                       for k in BAProblem._fields))


def state_from_numpy(arrays: Mapping, device: str | torch.device | None = None) -> VOState:
    """VOState from the ``save_vo_checkpoint`` layout: ``state_{i}`` arrays, with bf16
    fields stored as uint16 bit patterns under ``state_{i}__bf16``."""
    dev = resolve_device(device)
    fields = []
    for i in range(len(VOState._fields)):
        if f"state_{i}__bf16" in arrays:
            bits = np.asarray(arrays[f"state_{i}__bf16"], np.uint16).view(np.int16)
            t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arrays[f"state_{i}"]))
        fields.append(t.to(dev))
    return VOState(*fields)


def patchnet_params_from_jax(params: Mapping, device: str | torch.device | None = None) -> dict:
    """The port's patchnet parameters on ``device`` (default cuda) from the JAX params
    pytree as numpy arrays: convolutions HWIO -> OIHW (the heads' 1 x 1 too), biases and
    BatchNorm running statistics as they are."""
    dev = resolve_device(device)

    def t(a, conv=False):
        a = np.asarray(a, np.float32)
        return to_device(np.transpose(a, (3, 2, 0, 1)) if conv else a, dev)

    convs = [{k: t(v, conv=k == "w") for k, v in layer.items()} for layer in params["convs"]]
    return {"convs": convs, **{h: {"w": t(params[h]["w"], conv=True), "b": t(params[h]["b"])}
                               for h in ("clf", "sal")}}
