"""Read the published R2D2 checkpoints (``.pt``) into the port's patchnet parameters.
Port of ``vo_tpu/models/port_weights.py``.

A checkpoint is a dict with the architecture string under ``net`` (e.g.
``"Fast_Quad_L2Net_ConfCFS()"``) and a state dict under ``state_dict`` whose keys may
carry a ``module.`` prefix. The trunk's layers sit in one ``ops`` list, conv -> [bn]
-> [relu] -> [pool], so the indices skip the parameter-free ReLU and pool entries
(for ``faster2d2_WASF_N16.pt``: convs at ``ops.{0,3,6,10,13,16,19,21,23}``, affine-free
BatchNorms at ``ops.{1,4,7,11,14,17,20,22}``); the heads are ``clf`` and ``sal``.
``PatchNet`` has that layout, so the state dict loads into it as it is; its
convolutions are OIHW, as the checkpoint's.

The published files are not in the repository: ``load_pretrained`` reads them from
``models_dir`` (default ``vo_tpu_torch/models/weights/``) and raises when one is
missing. It never falls back to random weights.
"""

from __future__ import annotations

import os

import torch

from vo_tpu_torch.models.patchnet import (FAST_QUAD_L2NET_CONFCFS, QUAD_L2NET_CONFCFS,
                                          PatchNet, PatchNetSpec)

MODELS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")

ARCH_TO_SPEC = {
    "Fast_Quad_L2Net_ConfCFS()": FAST_QUAD_L2NET_CONFCFS,
    "Quad_L2Net_ConfCFS()": QUAD_L2NET_CONFCFS,
}


def load_torch_checkpoint(path: str) -> tuple[PatchNetSpec, dict]:
    """A reference ``.pt`` checkpoint -> (spec, parameter dict on the CPU)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    arch = ckpt["net"].strip()
    if arch not in ARCH_TO_SPEC:
        raise ValueError(f"unsupported architecture string {arch!r}")
    spec = ARCH_TO_SPEC[arch]
    state = {k.replace("module.", ""): v for k, v in ckpt["state_dict"].items()}
    net = PatchNet(spec)
    missing, unexpected = net.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"{path}: checkpoint does not fit {arch}: missing {missing}, "
                         f"unexpected {unexpected}")
    return spec, net.params()


def load_pretrained(name: str = "faster2d2_WASF_N16", models_dir: str | None = None):
    """One of the published models by its short name (``faster2d2_WASF_N16``,
    ``r2d2_WASF_N16``, ...): ``<models_dir>/<name>.pt``, by default in
    ``MODELS_DIR``."""
    path = os.path.join(models_dir or MODELS_DIR, f"{name}.pt")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"R2D2 checkpoint {path} not found: put the published "
                                f"{name}.pt there or pass models_dir")
    return load_torch_checkpoint(path)
