"""R2D2 training loop: AdamW as optax computes it, a NaN guard and npz checkpoints.
Port of ``vo_tpu/train/trainer.py``.

A step makes (or takes) a batch of pairs on the device, runs the train-mode patchnet
on both images, ``r2d2_loss``, the backward, the AdamW update and the BatchNorm
running-statistics update, with no host sync. The update repeats ``optax.adamw``
over the whole parameter dict: the Adam moments with bias correction by the update
count, the weight decay added to the update, then ``-lr`` (a constant, or the warmup
+ cosine schedule read at the count before the increment), on every leaf, the
running ``bn_mean`` / ``bn_var`` included: their gradient is zero, so they decay by
``lr * wd`` each step before the batch moments are folded in.
``torch.optim.AdamW`` does neither (it skips tensors without a gradient and decays
the parameter before the Adam step), so the update is written out here.

The step is repeatable on the card: it runs with deterministic algorithms (the
backward of the loss's gathers sums in a fixed order) and cuDNN's deterministic
convolution algorithms, scoped to the step.
"""

from __future__ import annotations

import contextlib
import json
import math
import warnings
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from vo_tpu_torch import prng
from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.models.patchnet import (
    PatchNetSpec,
    apply_patchnet,
    init_patchnet_params,
    params_to,
    update_bn_running_stats,
)
from vo_tpu_torch.train.losses import r2d2_loss
from vo_tpu_torch.train.pairs import synthetic_pair_batch

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class TrainConfig:
    batch: int = 8
    height: int = 192
    width: int = 192
    lr: float = 1e-4            # the reference's Adam lr 1e-4, weight decay 5e-4
    weight_decay: float = 5e-4
    w_cosim: float = 1.0
    w_peaky: float = 0.5
    w_ap: float = 1.0
    sample_stride: int = 8
    bn_momentum: float = 0.9
    seed: int = 8214
    photometric: bool = False   # gain/bias/gamma/pixel-noise jitter on the warped view
    sampler: str = "grid"       # "grid" (in-batch negatives) or "ngh" (NghSampler2-style
                                # ring positives/negatives + distractors)
    lr_schedule: str = "const"  # "const" or "cosine" (warmup + cosine decay to 5 %)
    total_steps: int = 0        # cosine decay horizon (required for lr_schedule="cosine")
    warmup_steps: int = 0


class AdamWState(NamedTuple):
    count: torch.Tensor         # int32 (): updates made (optax's ScaleByAdamState.count)
    mu: dict                    # first moments, the parameter dict's layout
    nu: dict                    # second moments


class TrainState(NamedTuple):
    params: dict
    opt_state: AdamWState
    step: torch.Tensor          # int32 ()


def leaf_paths(params: dict) -> list[tuple]:
    """The parameter dict's leaves as (group, index, key) paths, in the order of
    ``jax.tree.flatten`` of the JAX package's params pytree (dict keys sorted)."""
    paths = [("clf", None, k) for k in sorted(params["clf"])]
    for i, layer in enumerate(params["convs"]):
        paths += [("convs", i, k) for k in sorted(layer)]
    return paths + [("sal", None, k) for k in sorted(params["sal"])]


def _get(params: dict, path: tuple) -> torch.Tensor:
    group, i, k = path
    return params[group][i][k] if group == "convs" else params[group][k]


def _leaves(params: dict) -> list[torch.Tensor]:
    return [_get(params, p) for p in leaf_paths(params)]


def _rebuild(template: dict, leaves) -> dict:
    """A dict of ``template``'s layout holding ``leaves`` (``leaf_paths`` order)."""
    out = {"clf": {}, "convs": [{} for _ in template["convs"]], "sal": {}}
    for (group, i, k), t in zip(leaf_paths(template), leaves):
        (out[group][i] if group == "convs" else out[group])[k] = t
    return out


def learning_rate(cfg: TrainConfig, count: torch.Tensor) -> torch.Tensor | float:
    """The learning rate at update ``count`` (before its increment): ``cfg.lr``, or
    ``optax.warmup_cosine_decay_schedule`` as ``make_optimizer`` of the JAX package
    builds it, in fp32 on the count's device."""
    if not (cfg.lr_schedule == "cosine" and cfg.total_steps > 0):
        return cfg.lr
    warm = max(cfg.warmup_steps, 1)
    init = cfg.lr * (0.0 if cfg.warmup_steps else 1.0)
    decay = float(cfg.total_steps - warm)
    alpha = 0.05
    c = count.to(torch.float32)
    frac = 1 - torch.clamp(c, 0, warm) / warm
    linear = (init - cfg.lr) * frac + cfg.lr
    t = torch.minimum(c - warm, c.new_full((), decay))
    cosine = cfg.lr * ((1 - alpha) * (0.5 * (1 + torch.cos(math.pi * t / decay))) + alpha)
    return torch.where(c < warm, linear, cosine)


@dataclass(frozen=True)
class AdamW:
    """``optax.adamw(lr, weight_decay)`` over a parameter dict: b1 0.9, b2 0.999,
    eps 1e-8; ``lr`` is a number or a function of the update count."""

    lr: object
    weight_decay: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict) -> AdamWState:
        p = _leaves(params)
        zeros = lambda: _rebuild(params, [torch.zeros_like(t) for t in p])
        return AdamWState(torch.zeros((), dtype=torch.int32, device=p[0].device),
                          zeros(), zeros())

    def update(self, grads: list, state: AdamWState, params: dict):
        """(new params, new state) from ``grads`` in ``leaf_paths`` order."""
        p, mu, nu = _leaves(params), _leaves(state.mu), _leaves(state.nu)
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), torch._foreach_mul(mu, b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                                torch._foreach_mul(nu, b2))
        count = state.count + 1
        c = count.to(torch.float32)
        mu_hat = torch._foreach_div(mu, 1 - b1 ** c)
        nu_hat = torch._foreach_div(nu, 1 - b2 ** c)
        upd = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat),
                                                            self.eps))
        upd = torch._foreach_add(upd, torch._foreach_mul(p, self.weight_decay))
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        upd = torch._foreach_mul(upd, -lr)
        new = torch._foreach_add(p, upd)
        return (_rebuild(params, new),
                AdamWState(count, _rebuild(params, mu), _rebuild(params, nu)))


def make_optimizer(cfg: TrainConfig) -> AdamW:
    if cfg.lr_schedule == "cosine" and cfg.total_steps > 0:
        if cfg.total_steps <= max(cfg.warmup_steps, 1):
            raise ValueError(f"the cosine schedule needs total_steps > warmup_steps, "
                             f"got {cfg.total_steps} and {cfg.warmup_steps}")
        return AdamW(lambda count: learning_rate(cfg, count), cfg.weight_decay)
    return AdamW(cfg.lr, cfg.weight_decay)


def create_train_state(spec: PatchNetSpec, cfg: TrainConfig, params: dict | None = None,
                       device: str | torch.device | None = None) -> TrainState:
    """A fresh state on ``device`` (default cuda): ``params``, or the JAX package's
    initialisation from ``prng.key(cfg.seed)``; zero moments; step 0."""
    dev = resolve_device(device)
    if params is None:
        params = init_patchnet_params(prng.key(cfg.seed, dev), spec)
    params = params_to(params, dev)
    return TrainState(params, make_optimizer(cfg).init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def state_to(state: TrainState, device=None, dtype: torch.dtype | None = None) -> TrainState:
    """The state on ``device`` with its floating tensors in ``dtype`` (a step then runs
    in that dtype: fp64 gives a reference of the fp32 step); the counts stay int32."""
    def tree(t: dict) -> dict:
        return _rebuild(t, [x.to(device=device, dtype=dtype) for x in _leaves(t)])

    opt = state.opt_state
    return TrainState(tree(state.params),
                      AdamWState(opt.count.to(device), tree(opt.mu), tree(opt.nu)),
                      state.step.to(device))


def _normalize(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) gray in [0, 255] -> (B, H, W, 3) ImageNet-normalised fp32."""
    x = img / 255.0
    return torch.stack([(x - m) / s for m, s in zip(_IMAGENET_MEAN, _IMAGENET_STD)], dim=-1)


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms and cuDNN convolutions for the block (restored after).
    cuBLAS on one stream repeats its sums, so its workspace warning is silenced."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CUBLAS_WORKSPACE_CONFIG.*")
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[2:]


def train_step(state: TrainState, key: torch.Tensor, spec: PatchNetSpec, cfg: TrainConfig):
    """One step on a batch synthesised from ``key`` on the state's device.
    Returns (new_state, metrics)."""
    dev = state.step.device
    batch = synthetic_pair_batch(key.to(dev), cfg.batch, cfg.height, cfg.width,
                                 cfg.photometric)
    return train_step_batch(state, batch, spec, cfg)


def train_step_batch(state: TrainState, batch, spec: PatchNetSpec, cfg: TrainConfig):
    """One step on an explicit (img1, img2, flow, mask) batch on the state's device.

    Returns (new_state, metrics: cosim, peaky, ap, total and skipped, 0-d tensors).
    NaN-guarded: a non-finite loss keeps the parameters and optimizer state as they
    were (selected on the device, no host sync), and the step still counts.
    """
    img1, img2, flow, mask = batch
    paths = leaf_paths(state.params)
    leaves = _leaves(state.params)
    trainable = [i for i, (_, _, k) in enumerate(paths) if not k.startswith("bn_")]
    with _deterministic(), torch.enable_grad():
        leaves_g = [t.detach().requires_grad_(i in trainable) for i, t in enumerate(leaves)]
        params = _rebuild(state.params, leaves_g)
        dt = leaves[0].dtype                 # the step runs in its parameters' dtype
        out1 = apply_patchnet(params, spec, _normalize(img1.to(dt)), dt, train=True)
        out2 = apply_patchnet(params, spec, _normalize(img2.to(dt)), dt, train=True)
        total, metrics = r2d2_loss(out1, out2, flow, mask, w_cosim=cfg.w_cosim,
                                   w_peaky=cfg.w_peaky, w_ap=cfg.w_ap,
                                   stride=cfg.sample_stride, sampler=cfg.sampler)
        g = torch.autograd.grad(total, [leaves_g[i] for i in trainable])
    grads = [torch.zeros_like(t) for t in leaves]
    for i, gi in zip(trainable, g):
        grads[i] = gi

    new_params, new_opt = make_optimizer(cfg).update(grads, state.opt_state, state.params)
    bn_stats = [(m.detach(), v.detach()) for m, v in out1["bn_stats"]]
    new_params = update_bn_running_stats(new_params, bn_stats, cfg.bn_momentum)

    ok = torch.isfinite(total.detach())

    def keep(new: dict, old: dict) -> dict:
        return _rebuild(old, [torch.where(ok, a, b) for a, b in zip(_leaves(new), _leaves(old))])

    opt = state.opt_state
    new_state = TrainState(
        keep(new_params, state.params),
        AdamWState(torch.where(ok, new_opt.count, opt.count), keep(new_opt.mu, opt.mu),
                   keep(new_opt.nu, opt.nu)),
        state.step + 1)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["skipped"] = ~ok
    return new_state, metrics


def _state_leaves(state: TrainState) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf: params, the update count, mu, nu, step."""
    def named(prefix, tree):
        return [(f"{prefix}/{g}/{'' if i is None else f'{i}/'}{k}", _get(tree, (g, i, k)))
                for g, i, k in leaf_paths(tree)]

    opt = state.opt_state
    return (named("params", state.params) + [("opt_state/count", opt.count)]
            + named("opt_state/mu", opt.mu) + named("opt_state/nu", opt.nu)
            + [("step", state.step)])


def save_checkpoint(path: str, state: TrainState, spec_name: str) -> None:
    """The whole train state (params, optimizer state, step) as one npz at ``path``.

    Pickle-free: the leaves are indexed npz arrays (convolutions in OIHW) and their
    names, shapes and the spec name a JSON entry, so loading runs no stored code."""
    named = _state_leaves(state)
    meta = json.dumps({"spec": spec_name, "step": int(state.step),
                       "leaves": [[n, list(t.shape)] for n, t in named]})
    arrays = {f"leaf_{i:05d}": t.detach().cpu().numpy() for i, (_, t) in enumerate(named)}
    with open(path, "wb") as f:            # exact path (np.savez would append .npz)
        np.savez(f, __meta__=np.frombuffer(meta.encode(), np.uint8), **arrays)


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Load a ``save_checkpoint`` npz onto the template's device. The template's leaf
    names and shapes must equal the saved ones: a mismatched model or optimizer
    raises instead of mis-assigning leaves."""
    named = _state_leaves(template)
    with open(path, "rb") as f:
        blob = np.load(f)
        meta = json.loads(bytes(blob["__meta__"].tobytes()).decode())
        mine = [[n, list(t.shape)] for n, t in named]
        if meta["leaves"] != mine:
            raise ValueError(f"checkpoint tree mismatch: saved {len(meta['leaves'])} leaves "
                             f"({meta['spec']}), the template has {len(mine)}")
        leaves = [torch.from_numpy(blob[f"leaf_{i:05d}"]).to(t.device)
                  for i, (_, t) in enumerate(named)]
    n = len(leaf_paths(template.params))
    params = _rebuild(template.params, leaves[:n])
    count = leaves[n]
    mu = _rebuild(template.params, leaves[n + 1:2 * n + 1])
    nu = _rebuild(template.params, leaves[2 * n + 1:3 * n + 1])
    return TrainState(params, AdamWState(count, mu, nu), leaves[-1])
