"""Carry configuration and a running VO state across from the JAX package.

What moves is configuration (the JAX dataclasses, given as ``dataclasses.asdict``
dicts), the engine's loop carry (``VOState``, given in the ``save_vo_checkpoint`` npz
layout), so that a run started with the JAX package can be continued by the port, a
bundle-adjustment problem (``BAProblem``'s arrays), the R2D2 patchnet's learned
parameters (its params pytree as numpy arrays), its whole training state (params,
optax's AdamW state and step, from memory or from a ``save_checkpoint`` file), so that
a training run started with the JAX package can be resumed by the port, and the road
segmentation net's parameters.
"""

from __future__ import annotations

import json
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
from vo_tpu_torch.models.patchnet import PatchNetSpec
from vo_tpu_torch.train.trainer import AdamWState, TrainConfig, TrainState, leaf_paths


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


def _oihw(a) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(a, np.float32), (3, 2, 0, 1)))


def segnet_params_from_jax(params: Mapping, device: str | torch.device | None = None) -> dict:
    """The port's road-segmentation parameters on ``device`` (default cuda) from the
    JAX pytree as numpy arrays: weights HWIO -> OIHW, biases as they are."""
    dev = resolve_device(device)
    return {name: {"w": to_device(_oihw(layer["w"]), dev),
                   "b": to_device(np.array(layer["b"], np.float32), dev)}
            for name, layer in params.items()}


def _train_state(params, count, mu, nu, step, dev) -> TrainState:
    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32).to(dev)

    return TrainState(patchnet_params_from_jax(params, dev),
                      AdamWState(scalar(count), patchnet_params_from_jax(mu, dev),
                                 patchnet_params_from_jax(nu, dev)),
                      scalar(step))


def train_state_from_jax(params: Mapping, opt_state, step,
                         device: str | torch.device | None = None) -> TrainState:
    """The port's TrainState on ``device`` (default cuda) from the JAX trainer's, as
    numpy arrays: the params pytree, optax's adamw state (the tuple whose
    ``ScaleByAdamState`` holds count, mu and nu; with the cosine schedule also a
    ``ScaleByScheduleState`` whose count must equal Adam's) and the step."""
    dev = resolve_device(device)
    fields = [(s, getattr(s, "_fields", ())) for s in opt_state]
    adam = next(s for s, f in fields if "mu" in f)
    for s, f in fields:
        if f == ("count",) and int(np.asarray(s.count)) != int(np.asarray(adam.count)):
            raise ValueError(f"schedule count {int(np.asarray(s.count))} differs from "
                             f"the Adam count {int(np.asarray(adam.count))}")
    return _train_state(params, adam.count, adam.mu, adam.nu, step, dev)


def load_jax_train_checkpoint(path: str, spec: PatchNetSpec, cfg: TrainConfig,
                              device: str | torch.device | None = None) -> TrainState:
    """Read a file written by the JAX package's ``trainer.save_checkpoint`` for
    ``spec`` and ``cfg`` into the port's TrainState on ``device`` (default cuda).

    Its leaves are ``jax.tree.flatten`` of the JAX TrainState: the params (dict keys
    sorted), Adam's count, mu and nu (each in the params' order), the schedule's
    count when ``cfg`` has the cosine schedule, then the step. A file whose spec, leaf
    count or optimizer does not match raises.
    """
    cosine = cfg.lr_schedule == "cosine" and cfg.total_steps > 0
    template = {"clf": {"b": 0, "w": 0},
                "convs": [{k: 0 for k in (("b", "bn_mean", "bn_var", "w") if cs.bn
                                          else ("b", "w"))} for cs in spec.convs],
                "sal": {"b": 0, "w": 0}}
    paths = leaf_paths(template)
    n = len(paths)
    n_leaves = 3 * n + 2 + cosine
    with open(path, "rb") as f:
        blob = np.load(f)
        meta = json.loads(bytes(blob["__meta__"].tobytes()).decode())
        treedef = meta["treedef"]
        if (meta["spec"] != spec.name or meta["n_leaves"] != n_leaves
                or "ScaleByAdamState" not in treedef
                or ("ScaleByScheduleState" in treedef) != cosine):
            raise ValueError(f"{path} holds {meta['n_leaves']} leaves of {meta['spec']} "
                             f"({treedef[:80]}...); expected {n_leaves} of {spec.name}"
                             f"{' with the cosine schedule' if cosine else ''}")
        leaves = [blob[f"leaf_{i:05d}"] for i in range(n_leaves)]

    def tree(part):
        out = {"clf": {}, "convs": [{} for _ in spec.convs], "sal": {}}
        for (group, i, k), a in zip(paths, part):
            (out[group][i] if group == "convs" else out[group])[k] = a
        return out

    if cosine and int(leaves[3 * n + 1]) != int(leaves[n]):
        raise ValueError(f"{path}: schedule count {int(leaves[3 * n + 1])} differs from "
                         f"the Adam count {int(leaves[n])}")
    return _train_state(tree(leaves[:n]), leaves[n], tree(leaves[n + 1:2 * n + 1]),
                        tree(leaves[2 * n + 1:3 * n + 1]), leaves[-1], resolve_device(device))
