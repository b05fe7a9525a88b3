"""Mean Matching Accuracy (MMA) harness for feature extractors.
Port of ``vo_tpu/evalkit/mma.py``.

The HPatches protocol on pairs related by a known homography: mutual-nearest-neighbour
descriptor matching, and MMA@t = the mean fraction of matches whose ground-truth
reprojection error is at most t px. ``mma_on_warps`` builds the pairs from any image
batch by random homographies and photometric jitter (viewpoint and illumination).

On CUDA tensors the mutual nearest neighbours come from the fp32 match kernel
(``ops.match.top2_mutual``: one SIMT launch per pair; its nn12, best similarity and
nn21 with ``mutual_nn_match``'s 0.9 floor and mutual test); on CPU tensors from
``matching.matchers.mutual_nn_match``. ``mma_on_warps`` matches each pair once and
takes the match count from the same result (the JAX harness matches twice, with the
same numbers).
"""

from __future__ import annotations

import numpy as np
import torch

from vo_tpu_torch.device import device_for, to_device
from vo_tpu_torch.matching.matchers import mutual_nn_match
from vo_tpu_torch.ops.match import top2_mutual
from vo_tpu_torch.train.pairs import warp_eval_batch

MUTUAL_NN_FLOOR = 0.9       # mutual_nn_match's similarity floor


def _project(Hm: np.ndarray, xy: np.ndarray) -> np.ndarray:
    p = np.concatenate([xy, np.ones_like(xy[:, :1])], axis=1) @ Hm.T
    return p[:, :2] / np.clip(p[:, 2:], 1e-9, None)


def mutual_matches(desc1: torch.Tensor, desc2: torch.Tensor, valid1: torch.Tensor,
                   valid2: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(idx (N1,), mask (N1,)) numpy: mutual nearest neighbours with similarity at
    least 0.9, through the fp32 match kernel on the card, ``mutual_nn_match`` on the
    CPU."""
    if desc1.device.type == "cuda":
        nn12, top2, nn21 = top2_mutual(desc1.float().contiguous(), desc2.float().contiguous(),
                                       valid1.contiguous(), valid2.contiguous())
        nn12 = nn12.long()
        ids = torch.arange(nn12.shape[0], device=nn12.device)
        mask = (top2[:, 0] >= MUTUAL_NN_FLOOR) & (nn21[nn12].long() == ids)
        idx = nn12
    else:
        m = mutual_nn_match(desc1, desc2, valid1, valid2, threshold=MUTUAL_NN_FLOOR)
        idx, mask = m.idx, m.mask
    return idx.cpu().numpy(), mask.cpu().numpy()


def _mma(kp1, kp2, idx, mask, Hm, thresholds) -> np.ndarray:
    if mask.sum() == 0:
        return np.zeros(len(thresholds))
    k1 = np.asarray(kp1)[mask][:, :2]
    k2 = np.asarray(kp2)[idx[mask]][:, :2]
    err = np.linalg.norm(_project(np.asarray(Hm), k1) - k2, axis=1)
    return np.asarray([(err <= t).mean() for t in thresholds])


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mma_pair(feats1, feats2, Hm, thresholds) -> np.ndarray:
    """MMA@t for one pair: feats are Features-like (kp, desc, valid) of image 1 and 2;
    ``Hm`` maps image-1 pixels to image-2 pixels. Returns (len(thresholds),)."""
    idx, mask = mutual_matches(feats1.desc, feats2.desc, feats1.valid, feats2.valid)
    return _mma(_numpy(feats1.kp), _numpy(feats2.kp), idx, mask, _numpy(Hm), thresholds)


def mma_on_warps(extract_fn, images, key: torch.Tensor, thresholds=tuple(range(1, 11)),
                 photometric: bool = True, max_kp_note: str | None = None,
                 device: str | torch.device | None = None) -> dict:
    """MMA curve of an extractor over homography-warped versions of ``images``.

    Args:
      extract_fn: batched (B, H, W) [0, 255] tensor -> Features (kp / desc / valid).
      images: (B, H, W) gray batch (one warp per image), moved to ``device``
        (default: where a tensor lies, else cuda).
      key: ``prng`` key of the warps (a fixed key is a reproducible benchmark).
    Returns a dict with ``thresholds``, the per-threshold ``mma``, ``mma@3``,
    ``n_pairs`` and the mean mutual-NN ``n_matches``, as the JAX harness's.
    """
    dev = device_for(images, device)
    images = to_device(images, dev, torch.float32)
    B = images.shape[0]
    Hmats, img2 = warp_eval_batch(key.to(dev), images, photometric)

    f1 = extract_fn(images)
    f2 = extract_fn(img2)
    Hmats = _numpy(Hmats)
    kp1, kp2 = _numpy(f1.kp), _numpy(f2.kp)

    curves, n_matches = [], []
    for b in range(B):
        idx, mask = mutual_matches(f1.desc[b], f2.desc[b], f1.valid[b], f2.valid[b])
        curves.append(_mma(kp1[b], kp2[b], idx, mask, Hmats[b], thresholds))
        n_matches.append(int(mask.sum()))

    mma = np.stack(curves).mean(0)
    out = {"thresholds": list(thresholds), "mma": mma.tolist(),
           "n_pairs": B, "mean_matches": float(np.mean(n_matches)),
           "matches_per_pair": [int(m) for m in n_matches]}
    if 3 in thresholds:
        ti = list(thresholds).index(3)
        per_pair = [float(c[ti]) for c in curves]
        out["mma@3"] = float(mma[ti])
        out["mma@3_per_pair"] = per_pair
        out["mma@3_std"] = float(np.std(per_pair))
    return out
