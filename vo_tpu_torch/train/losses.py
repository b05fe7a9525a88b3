"""R2D2 self-supervised losses. Port of ``vo_tpu/train/losses.py``.

- ``cosim_loss``: 1 - the cosine similarity of 16 x 16 repeatability windows of image
  1 and of image 2 warped back through the flow;
- ``peaky_loss``: 1 - (local max - local mean) of repeatability windows;
- ``ap_reliability_loss`` / ``ngh_ap_reliability_loss``: a histogram-binned
  differentiable Average Precision per query pixel of a strided grid in image 1,
  blended with the predicted reliability as 1 - (AP * rel + kappa * (1 - rel)), with
  in-batch grid negatives or NghSampler2-style rings and a distractor grid.

What the JAX package ``vmap``s over images is batched tensor code here. Gradients
follow ``jax.grad``'s rules where a value is tied: ``_clip`` splits the gradient
0.5 / 0.5 at a bound as ``jnp.maximum`` / ``jnp.minimum`` do (``torch.clamp`` passes it
all), ``_abs`` has gradient +1 at 0 as ``jnp.abs`` has (``torch.abs`` has 0), and a
max-pool window sends its gradient to one element (the first, in both). Norms are
``sqrt(sum(x * x))``, as ``jnp.linalg.norm`` computes them.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from vo_tpu_torch.train.pairs import bilinear_at as _bilinear_at


def _clip(x: torch.Tensor, lo: float | None = None, hi: float | None = None) -> torch.Tensor:
    """``jnp.clip``: max with ``lo``, then min with ``hi``; a tie splits the gradient."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with ``jnp.abs``'s gradient: +1 at 0."""
    return torch.where(x >= 0, x, -x)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def _avg_pool(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, H, W) n x n windows, stride n, VALID: their sums / n^2."""
    B, H, W = x.shape
    Hc, Wc = H // n, W // n
    return x[:, :Hc * n, :Wc * n].reshape(B, Hc, n, Wc, n).sum(dim=(2, 4)) / (n * n)


def _max_pool(x: torch.Tensor, n: int) -> torch.Tensor:
    return F.max_pool2d(x[:, None], n)[:, 0]


def cosim_loss(rep1: torch.Tensor, rep2: torch.Tensor, flow: torch.Tensor,
               mask: torch.Tensor, window: int = 16) -> torch.Tensor:
    """1 - mean cosine similarity of n x n windows of rep1 and the flow-warped rep2."""
    B, H, W = rep1.shape
    rep2_w = _bilinear_at(rep2, flow.reshape(B, -1, 2)).reshape(B, H, W)
    rep2_w = torch.where(mask, rep2_w, 0.0)
    rep1m = torch.where(mask, rep1, 0.0)

    n = window
    Hc, Wc = H // n, W // n

    def windows(r):
        return (r[:, :Hc * n, :Wc * n].reshape(B, Hc, n, Wc, n).transpose(2, 3)
                .reshape(B, Hc * Wc, n * n))

    f1, f2 = windows(rep1m), windows(rep2_w)
    cos = torch.sum(f1 * f2, dim=-1) / _clip(_norm(f1) * _norm(f2), 1e-6)
    return 1.0 - torch.mean(cos)


def peaky_loss(rep: torch.Tensor, window: int = 16) -> torch.Tensor:
    """1 - mean(local max - local mean): rewards peaked repeatability."""
    return 1.0 - torch.mean(_max_pool(rep, window) - _avg_pool(rep, window))


def _quantized_ap(sim_pos: torch.Tensor, sim_neg: torch.Tensor,
                  n_bins: int = 25) -> torch.Tensor:
    """Histogram AP: soft-bin similarities in [-1, 1] and weigh the positive mass by
    the precision above it. sim_pos (..., P), sim_neg (..., N) -> AP (...,) in [0, 1].

    The cumulative sums over the bins are products with a triangular matrix of ones:
    ``torch.cumsum`` on the card may sum in a varying order.
    """
    # jnp.linspace(1, -1, n_bins) by its formula: 1 * (1 - t) + (-1) * t, t = i / (n - 1).
    t = torch.arange(n_bins - 1, dtype=sim_pos.dtype, device=sim_pos.device) / (n_bins - 1)
    centers = torch.cat([(1.0 - t) - t, t.new_full((1,), -1.0)])
    delta = 2.0 / (n_bins - 1)

    def soft_hist(s):                   # (..., M) -> (..., n_bins)
        w = _clip(1.0 - _abs(s[..., None] - centers) / delta, 0.0, 1.0)
        return w.sum(dim=-2)

    hp, hn = soft_hist(sim_pos), soft_hist(sim_neg)
    upper = torch.ones(n_bins, n_bins, dtype=hp.dtype, device=hp.device).triu()
    cp, cn = hp @ upper, hn @ upper
    prec = cp / _clip(cp + cn, 1e-8)
    n_pos = _clip(hp.sum(dim=-1), 1e-8)
    return torch.sum(prec * hp, dim=-1) / n_pos


def _query_grid(H: int, W: int, stride: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q,) rows and columns of the strided query grid, row-major."""
    ys = torch.arange(stride // 2, H - stride // 2, stride, device=device)
    xs = torch.arange(stride // 2, W - stride // 2, stride, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gy.reshape(-1), gx.reshape(-1)


def _reliability_blend(ap, q_rel, q_valid, kappa):
    """Per image: the valid queries' mean of 1 - (AP * rel + kappa * (1 - rel))."""
    loss_q = 1.0 - (ap * q_rel + kappa * (1.0 - q_rel))
    w = q_valid.to(ap.dtype)
    return torch.sum(loss_q * w, dim=-1) / torch.clamp(w.sum(dim=-1), min=1.0)


def ap_reliability_loss(desc1: torch.Tensor, desc2: torch.Tensor, rel1: torch.Tensor,
                        flow: torch.Tensor, mask: torch.Tensor, stride: int = 8,
                        kappa: float = 0.5, n_bins: int = 25) -> torch.Tensor:
    """AP-reliability loss with in-batch grid negatives.

    Args:
      desc1, desc2: (B, H, W, D) L2-normed dense descriptors.
      rel1: (B, H, W) reliability of image 1.
      flow: (B, H, W, 2) image-1 -> image-2 ground-truth correspondence.
      mask: (B, H, W) correspondence validity.
    """
    B, H, W, D = desc1.shape
    qy, qx = _query_grid(H, W, stride, desc1.device)
    q = desc1[:, qy, qx]                                        # (B, Q, D)
    q_rel, q_valid = rel1[:, qy, qx], mask[:, qy, qx]
    tgt = flow[:, qy, qx]                                       # (B, Q, 2) in image 2
    pos = _bilinear_at(desc2, tgt)
    pos = pos / _clip(_norm(pos, keepdim=True), 1e-8)

    sim_all = q @ pos.transpose(1, 2)                           # (B, Q, Q): diag = positives
    sim_pos = torch.diagonal(sim_all, dim1=1, dim2=2)[..., None]
    nq = sim_all.shape[-1]
    # Negatives: the other queries' targets, less near-duplicates (within ~stride px).
    d2_t = torch.sum((tgt[:, :, None] - tgt[:, None, :]) ** 2, dim=-1)
    neg = ~torch.eye(nq, dtype=torch.bool, device=desc1.device) & (d2_t > (stride * 0.75) ** 2)
    sim_neg = torch.where(neg, sim_all, -1.0)

    ap = _quantized_ap(sim_pos, sim_neg, n_bins)
    return torch.mean(_reliability_blend(ap, q_rel, q_valid, kappa))


@functools.lru_cache(maxsize=8)
def _rings(r: float, rad: float, device, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The positive ring (the centre, 4 offsets at r / 2 and 4 at r) and the 8-direction
    hard-negative ring at ``rad``, made once per device (a tensor made from a list is
    copied up from the host, a sync)."""
    pos = torch.tensor([[0.0, 0.0], [r * 0.5, 0.0], [-r * 0.5, 0.0], [0.0, r * 0.5],
                        [0.0, -r * 0.5], [r, 0.0], [-r, 0.0], [0.0, r], [0.0, -r]],
                       dtype=torch.float32).to(device, dtype)
    angs = torch.arange(8, dtype=torch.float32) * (2 * math.pi / 8)
    neg = (rad * torch.stack([torch.cos(angs), torch.sin(angs)], dim=-1)).to(device, dtype)
    return pos, neg


def ngh_ap_reliability_loss(desc1: torch.Tensor, desc2: torch.Tensor, rel1: torch.Tensor,
                            flow: torch.Tensor, mask: torch.Tensor, stride: int = 8,
                            kappa: float = 0.5, n_bins: int = 25, pos_d: int = 3,
                            neg_d: tuple[int, int] = (5, 18),
                            distractor_stride: int = 16) -> torch.Tensor:
    """NghSampler2-style AP-reliability loss: per query, positives on a ring of
    sub-pixel offsets within ``pos_d`` of the target; negatives on a hard ring at the
    middle of ``neg_d`` around it and on a coarse distractor grid over image 2, less
    the cells within ``neg_d[0]`` of the target. Fixed shapes throughout."""
    B, H, W, D = desc1.shape
    dev, dt = desc1.device, desc1.dtype
    qy, qx = _query_grid(H, W, stride, dev)
    pos_off, neg_off = _rings(float(pos_d), 0.5 * (neg_d[0] + neg_d[1]), dev, dt)

    dy = torch.arange(distractor_stride // 2, H, distractor_stride, device=dev)
    dx = torch.arange(distractor_stride // 2, W, distractor_stride, device=dev)
    dgy, dgx = torch.meshgrid(dy, dx, indexing="ij")
    dgy, dgx = dgy.reshape(-1), dgx.reshape(-1)
    d_xy = torch.stack([dgx, dgy], dim=-1).to(dt)              # (G, 2)

    q = desc1[:, qy, qx]                                        # (B, Q, D)
    q_rel, q_valid = rel1[:, qy, qx], mask[:, qy, qx]
    tgt = flow[:, qy, qx]                                       # (B, Q, 2)
    nq = tgt.shape[1]

    def ring(offsets):
        pts = tgt[:, :, None, :] + offsets                      # (B, Q, K, 2)
        d = _bilinear_at(desc2, pts.reshape(B, -1, 2)).reshape(B, nq, offsets.shape[0], D)
        return d / _clip(_norm(d, keepdim=True), 1e-8)

    sim_pos = torch.einsum("bqd,bqpd->bqp", q, ring(pos_off))
    sim_hneg = torch.einsum("bqd,bqrd->bqr", q, ring(neg_off))
    sim_dist = q @ desc2[:, dgy, dgx].transpose(1, 2)           # (B, Q, G)
    d2_t = torch.sum((tgt[:, :, None] - d_xy) ** 2, dim=-1)
    sim_dist = torch.where(d2_t > float(neg_d[0]) ** 2, sim_dist, -1.0)

    ap = _quantized_ap(sim_pos, torch.cat([sim_hneg, sim_dist], dim=-1), n_bins)
    return torch.mean(_reliability_blend(ap, q_rel, q_valid, kappa))


def r2d2_loss(out1: dict, out2: dict, flow: torch.Tensor, mask: torch.Tensor,
              w_cosim: float = 1.0, w_peaky: float = 0.5, w_ap: float = 1.0,
              stride: int = 8, sampler: str = "grid") -> tuple[torch.Tensor, dict]:
    """The weighted sum of the three losses -> (total, {cosim, peaky, ap, total}).
    ``sampler="grid"`` takes in-batch grid negatives, ``"ngh"`` the rings and the
    distractor grid."""
    l_cosim = cosim_loss(out1["repeatability"], out2["repeatability"], flow, mask)
    l_peaky = 0.5 * (peaky_loss(out1["repeatability"]) + peaky_loss(out2["repeatability"]))
    ap_fn = ngh_ap_reliability_loss if sampler == "ngh" else ap_reliability_loss
    l_ap = ap_fn(out1["descriptors"], out2["descriptors"], out1["reliability"], flow, mask,
                 stride=stride)
    total = w_cosim * l_cosim + w_peaky * l_peaky + w_ap * l_ap
    return total, {"cosim": l_cosim, "peaky": l_peaky, "ap": l_ap, "total": total}
