"""R2D2 patch-descriptor networks in PyTorch. Port of ``vo_tpu/models/patchnet.py``.

The two published architectures (``QUAD_L2NET_CONFCFS``: a dilated full-resolution
trunk; ``FAST_QUAD_L2NET_CONFCFS``: one 2x max-pool early and a bilinear 2x upsample
at the end) with the JAX package's layer tuples, and a forward that repeats its
arithmetic: dilated convolutions padded symmetrically by ``((k-1)*d)//2``,
affine-free BatchNorm as ``(x - mean) * rsqrt(var + eps)`` (from the running
statistics, or in train mode from the batch's moments), 128-d L2-normed descriptors,
and the reliability (2-channel softmax) and repeatability (softplus ratio) heads on
x^2. The train-mode forward is differentiable like the JAX one: its gradients follow
``jax.grad`` of ``vo_tpu/models/patchnet.py::apply_patchnet(train=True)``.

Parameters are a dict like the JAX pytree, holding torch tensors with convolutions
in OIHW: ``{"convs": [{"w", "b"[, "bn_mean", "bn_var"]}, ...], "clf": {"w", "b"},
"sal": {"w", "b"}}``. ``PatchNet`` holds the same tensors in the reference
checkpoints' module layout (``ops.{i}`` = conv -> [bn] -> [relu] -> [pool], ``clf``,
``sal``), so a checkpoint's state dict loads into it as it is.

The convolutions are cuDNN's on the card (``F.conv2d``): the JAX package leaves them
to XLA (``lax.conv_general_dilated``), outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from vo_tpu_torch import prng
from vo_tpu_torch.ops.image import resize_bilinear

BN_EPS = 1e-5


@dataclass(frozen=True)
class ConvSpec:
    in_ch: int
    out_ch: int
    k: int
    dilation: int = 1
    bn: bool = True
    relu: bool = True
    pool_after: int = 1  # max-pool window/stride applied after this layer (1 = none)

    @property
    def pad(self) -> int:
        return ((self.k - 1) * self.dilation) // 2


@dataclass(frozen=True)
class PatchNetSpec:
    name: str
    convs: tuple
    out_dim: int = 128
    upsample: int = 1  # bilinear upsample factor applied after the trunk


def _quad_specs(mchan: int = 4, dim: int = 128) -> tuple:
    c = lambda i, o, k, d, bn=True, relu=True, pool=1: ConvSpec(i, o, k, d, bn, relu, pool)
    m = mchan
    return (
        c(3, 8 * m, 3, 1),
        c(8 * m, 8 * m, 3, 1),
        c(8 * m, 16 * m, 3, 1),       # stride->dilation: next layers d*=2
        c(16 * m, 16 * m, 3, 2),
        c(16 * m, 32 * m, 3, 2),      # d*=2
        c(32 * m, 32 * m, 3, 4),
        c(32 * m, 32 * m, 2, 4, relu=False),
        c(32 * m, 32 * m, 2, 8, relu=False),
        c(32 * m, dim, 2, 16, bn=False, relu=False),
    )


def _fast_quad_specs(mchan: int = 4, dim: int = 128, down: int = 2) -> tuple:
    c = lambda i, o, k, d, bn=True, relu=True, pool=1: ConvSpec(i, o, k, d, bn, relu, pool)
    m = mchan
    return (
        c(3, 8 * m, 3, 1),
        c(8 * m, 8 * m, 3, 1),
        c(8 * m, 16 * m, 3, 1, pool=down),  # max-pool downsample instead of a dilation step
        c(16 * m, 16 * m, 3, 1),
        c(16 * m, 32 * m, 3, 1),            # stride->dilation from here
        c(32 * m, 32 * m, 3, 2),
        c(32 * m, 32 * m, 2, 2, relu=False),
        c(32 * m, 32 * m, 2, 4, relu=False),
        c(32 * m, dim, 2, 8, bn=False, relu=False),
    )


QUAD_L2NET_CONFCFS = PatchNetSpec(name="Quad_L2Net_ConfCFS", convs=_quad_specs())
FAST_QUAD_L2NET_CONFCFS = PatchNetSpec(
    name="Fast_Quad_L2Net_ConfCFS", convs=_fast_quad_specs(), upsample=2)


def init_patchnet_params(key: torch.Tensor, spec: PatchNetSpec,
                         dtype: torch.dtype = torch.float32) -> dict:
    """He-initialised parameters drawn from the ``prng`` key ``key``, on its device, as
    the JAX package draws them from the same key: conv weights N(0, 2 / fan_in) (one
    ``normal`` per layer in HWIO, transposed to OIHW), zero biases, running mean 0 and
    variance 1, heads N(0, 0.05^2)."""
    keys = prng.split(key, len(spec.convs) + 2)

    def normal(k, i, o, kh, kw):
        return prng.normal(k, (kh, kw, i, o)).permute(3, 2, 0, 1).contiguous().to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=key.device)

    convs = []
    for k, cs in zip(keys, spec.convs):
        fan_in = cs.k * cs.k * cs.in_ch
        scale = torch.sqrt(torch.tensor(2.0 / fan_in, dtype=torch.float32)).item()
        layer = {"w": normal(k, cs.in_ch, cs.out_ch, cs.k, cs.k) * scale, "b": zeros(cs.out_ch)}
        if cs.bn:
            layer["bn_mean"] = zeros(cs.out_ch)
            layer["bn_var"] = torch.ones_like(layer["bn_mean"])
        convs.append(layer)
    d = spec.out_dim
    return {"convs": convs,
            "clf": {"w": normal(keys[-2], d, 2, 1, 1) * 0.05, "b": zeros(2)},
            "sal": {"w": normal(keys[-1], d, 1, 1, 1) * 0.05, "b": zeros(1)}}


def params_to(params: dict, device) -> dict:
    """The parameter dict on ``device`` (tensors already there are not copied)."""
    return {"convs": [{k: v.to(device) for k, v in layer.items()}
                      for layer in params["convs"]],
            **{h: {k: v.to(device) for k, v in params[h].items()} for h in ("clf", "sal")}}


class PatchNet(nn.Module):
    """The network's tensors in the reference checkpoints' layout; ``forward`` is
    ``apply_patchnet``. ``load_state_dict`` takes a checkpoint's state dict with the
    ``module.`` prefix removed."""

    def __init__(self, spec: PatchNetSpec, params: dict | None = None):
        super().__init__()
        self.spec = spec
        self.ops = nn.ModuleList()
        for cs in spec.convs:
            self.ops.append(nn.Conv2d(cs.in_ch, cs.out_ch, cs.k, padding=cs.pad,
                                      dilation=cs.dilation))
            if cs.bn:
                self.ops.append(nn.BatchNorm2d(cs.out_ch, affine=False))
            if cs.relu:
                self.ops.append(nn.ReLU())
            if cs.pool_after > 1:
                self.ops.append(nn.MaxPool2d(cs.pool_after))
        self.clf = nn.Conv2d(spec.out_dim, 2, 1)
        self.sal = nn.Conv2d(spec.out_dim, 1, 1)
        self.requires_grad_(False)
        if params is not None:
            self.load_params(params)

    def _layers(self):
        """(conv, bn or None) per layer of the spec."""
        ops = list(self.ops)
        out, i = [], 0
        for cs in self.spec.convs:
            conv, i = ops[i], i + 1
            bn = None
            if cs.bn:
                bn, i = ops[i], i + 1
            i += cs.relu + (cs.pool_after > 1)
            out.append((conv, bn))
        return out

    def params(self) -> dict:
        """The parameter dict of the module's tensors (no copy)."""
        convs = []
        for conv, bn in self._layers():
            layer = {"w": conv.weight, "b": conv.bias}
            if bn is not None:
                layer["bn_mean"], layer["bn_var"] = bn.running_mean, bn.running_var
            convs.append(layer)
        return {"convs": convs, "clf": {"w": self.clf.weight, "b": self.clf.bias},
                "sal": {"w": self.sal.weight, "b": self.sal.bias}}

    def load_params(self, params: dict) -> None:
        """Copy a parameter dict into the module (shapes must agree)."""
        mine = self.params()
        pairs = [(mine[h][k], params[h][k]) for h in ("clf", "sal") for k in ("w", "b")]
        for dst, src in zip(mine["convs"], params["convs"]):
            pairs += [(dst[k], src[k]) for k in dst]
        for dst, src in pairs:
            dst.copy_(torch.as_tensor(src))

    def forward(self, images: torch.Tensor, compute_dtype=torch.float32) -> dict:
        return apply_patchnet(self, self.spec, images, compute_dtype)


def _dtype(dt) -> torch.dtype:
    return getattr(torch, dt) if isinstance(dt, str) else dt


def _softplus_ratio(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) / (1 + softplus(x)), with softplus as ``jax.nn.softplus`` computes
    it (``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|)), gradient sigmoid(x))."""
    s = torch.logaddexp(x, torch.zeros_like(x))
    return s / (1.0 + s)


def apply_patchnet(params, spec: PatchNetSpec, images: torch.Tensor,
                   compute_dtype=torch.float32, train: bool = False) -> dict:
    """Forward pass.

    Args:
      params: a parameter dict (``init_patchnet_params``, ``load_torch_checkpoint``)
        or a ``PatchNet``; on the device of ``images``.
      images: (B, H, W, 3) ImageNet-normalised fp32 (H, W even for the Fast variant).
      compute_dtype: the trunk's dtype (a torch dtype or its name). Each convolution
        runs in it and then adds its bias in it; BatchNorm runs in fp32 and casts
        back; the heads run in fp32 (both in fp64 when the trunk is fp64, which gives
        an fp64 reference of the same computation).
      train: True normalises with the batch's moments over (B, H, W) in fp32 (the
        population variance, as ``jnp.var``) instead of the running statistics, and
        adds ``bn_stats``, the per-layer (mean, var), to the output for
        ``update_bn_running_stats``.
    Returns:
      dict(descriptors (B, H', W', D) L2-normalised fp32, reliability (B, H', W'),
           repeatability (B, H', W')[, bn_stats]).
    """
    if isinstance(params, PatchNet):
        params = params.params()
    dt = _dtype(compute_dtype)
    acc = torch.float64 if dt == torch.float64 else torch.float32
    bn_stats = []
    x = images.to(dt).permute(0, 3, 1, 2)          # NCHW view of NHWC memory
    for cs, layer in zip(spec.convs, params["convs"]):
        x = F.conv2d(x, layer["w"].to(dt), padding=cs.pad, dilation=cs.dilation)
        x = x + layer["b"].to(dt)[:, None, None]
        if cs.bn:
            xf = x.to(acc)
            if train:
                mean = torch.mean(xf, dim=(0, 2, 3))
                var = torch.mean(torch.square(xf - mean[:, None, None]), dim=(0, 2, 3))
                bn_stats.append((mean, var))
            else:
                mean, var = layer["bn_mean"], layer["bn_var"]
            scale = torch.rsqrt(var.to(acc) + BN_EPS)
            x = ((xf - mean[:, None, None]) * scale[:, None, None]).to(dt)
        if cs.relu:
            x = torch.relu(x)
        if cs.pool_after > 1:
            x = F.max_pool2d(x, cs.pool_after)
    x = x.permute(0, 2, 3, 1)                         # (B, H', W', C)
    if spec.upsample > 1:
        _, h, w, _ = x.shape
        x = resize_bilinear(x, (h * spec.upsample, w * spec.upsample))

    x = x.to(acc)
    x2 = x * x
    urel = x2 @ params["clf"]["w"][:, :, 0, 0].T + params["clf"]["b"]
    urep = x2 @ params["sal"]["w"][:, :, 0, 0].T + params["sal"]["b"]

    desc = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)
    # The max is a constant of the softmax, as in jax.nn.softmax's gradient.
    e = torch.exp(urel - torch.amax(urel, dim=-1, keepdim=True).detach())
    reliability = e[..., 1] / torch.sum(e, dim=-1)
    out = {"descriptors": desc, "reliability": reliability,
           "repeatability": _softplus_ratio(urep[..., 0])}
    if train:
        out["bn_stats"] = bn_stats
    return out


def update_bn_running_stats(params: dict, bn_stats: list, momentum: float = 0.9) -> dict:
    """Fold a train-mode forward's batch moments into the running statistics:
    ``momentum * old + (1 - momentum) * batch`` per BatchNorm layer (a new dict; the
    other tensors are shared)."""
    it = iter(bn_stats)
    convs = []
    for layer in params["convs"]:
        if "bn_mean" in layer:
            mean, var = next(it)
            layer = dict(layer, bn_mean=momentum * layer["bn_mean"] + (1 - momentum) * mean,
                         bn_var=momentum * layer["bn_var"] + (1 - momentum) * var)
        convs.append(layer)
    return {**params, "convs": convs}
