"""Real-image training datasets and the random-window pair loader.
Port of ``vo_tpu/train/datasets.py`` (numpy and PIL on the host).

The host side of training on real images: image folders, pair sources with absolute
flow ("aflow"), the reference's x16 int16 flow-PNG format (read and write), and the
random-window crop search with its flow-scale heuristics and min(coverage,
occupancy) scoring (the reference's PairLoader). The device side
(``vo_tpu_torch.train.pairs`` and ``trainer``) adds the photometric jitter and runs
the step on the fixed-size batches this loader emits. ``SyntheticHomographyPairs``
warps on the CPU with the port's ``pairs.random_homography`` / ``warp_pair``, from
the JAX package's keys.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from vo_tpu_torch import prng
from vo_tpu_torch.train.pairs import random_homography, warp_pair

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".ppm", ".bmp")


# ---------------------------------------------------------------- image folders

class ImageFolder:
    """Recursive list of images under a root — the role of RandomWebImages /
    AachenImages (a plain folder walk; ``select`` filters path components like the
    reference's 'db day night' selector, aachen.py:16-28). Supports the reference's
    cached ``image_list_*.txt`` files when present (web_images.py:24-28)."""

    def __init__(self, root: str, select: str = ""):
        self.root = root
        sel = set(select.split())
        cached = sorted(f for f in os.listdir(root)
                        if f.startswith("image_list_") and f.endswith(".txt"))
        if cached:
            def resolve(name: str) -> str:
                p = os.path.join(root, name)
                if os.path.exists(p):
                    return p
                # revisitop1m layout: lists hold bare filenames living under
                # a hex-prefix subfolder (web_images.py:50-52 get_key).
                return os.path.join(root, name[:3], name)

            self.paths = [resolve(line.strip())
                          for f in cached
                          for line in open(os.path.join(root, f))
                          if line.strip()]
        else:
            self.paths = []
            for dirpath, _, files in os.walk(root):
                rel = os.path.relpath(dirpath, root)
                if sel and not (sel & set(rel.split(os.sep))):
                    continue
                self.paths += [os.path.join(dirpath, f) for f in sorted(files)
                               if f.lower().endswith(_IMG_EXTS)]
        if not self.paths:
            raise FileNotFoundError(f"no images under {root!r}")

    def __len__(self):
        return len(self.paths)

    def load_gray(self, i: int, max_side: int = 0) -> np.ndarray:
        """(H, W) float32 in [0, 255]; optionally downscaled so max(H, W) <= max_side."""
        from PIL import Image

        with Image.open(self.paths[i]) as im:
            im = im.convert("L")
            if max_side and max(im.size) > max_side:
                s = max_side / max(im.size)
                im = im.resize((max(int(im.size[0] * s), 8),
                                max(int(im.size[1] * s), 8)), Image.BILINEAR)
            return np.asarray(im, np.float32)


# ---------------------------------------------------------------- flow png format

def flow_to_png(flow: np.ndarray, path: str) -> np.ndarray:
    """Store (H, W, 2) flow as the reference's x16 int16 PNG (pair_dataset.py:73-80):
    int16 pairs viewed as 4 uint8 channels. Returns the quantized flow."""
    from PIL import Image

    q = np.clip(np.around(16 * flow), -2 ** 15, 2 ** 15 - 1).astype(np.int16)
    Image.fromarray(q.view(np.uint8)).save(path)
    return q / 16.0


def png_to_flow(path: str) -> np.ndarray:
    """Load a ``flow_to_png`` / reference-format flow PNG -> (H, W, 2) float32."""
    from PIL import Image

    raw = np.asarray(Image.open(path))
    return np.float32(raw.view(np.int16)) / 16.0


# ---------------------------------------------------------------- pair sources

class StillPairs:
    """Trivial pairs img1 == img2 with identity aflow (StillPairDataset,
    pair_dataset.py:90-110) — teaches photometric invariance only (combine with the
    loader's tilt/scale transforms for geometry)."""

    def __init__(self, images: ImageFolder, max_side: int = 640):
        self.images = images
        self.max_side = max_side

    def __len__(self):
        return len(self.images)

    def get_pair(self, i: int):
        img = self.images.load_gray(i, self.max_side)
        H, W = img.shape
        gy, gx = np.mgrid[0:H, 0:W]
        aflow = np.stack([gx, gy], -1).astype(np.float32)
        return img, img.copy(), aflow, np.ones((H, W), bool)


class SyntheticHomographyPairs:
    """Random-homography warped pairs with exact aflow (SyntheticPairDataset,
    pair_dataset.py:119-168): pair ``i`` is warped by ``random_homography`` of
    ``prng.fold_in(prng.key(seed), i)`` on the CPU."""

    def __init__(self, images: ImageFolder, max_side: int = 640, seed: int = 8214):
        self.images = images
        self.max_side = max_side
        self.seed = seed

    def __len__(self):
        return len(self.images)

    def get_pair(self, i: int):
        img = self.images.load_gray(i, self.max_side)
        H, W = img.shape
        key = prng.fold_in(prng.key(self.seed), i)
        img2, flow, mask = warp_pair(torch.from_numpy(img), random_homography(key, H, W))
        return img, img2.numpy(), flow.numpy(), mask.numpy()


class FlowPairs:
    """Image pairs with stored optical flow — the AachenPairs_OpticalFlow role
    (aachen.py:79-146). Layout: a ``pairs.txt`` under ``root`` with one
    ``img1 img2 flow [mask]`` line per pair (paths relative to root); flow is a
    reference-format x16 int16 PNG or a ``.npy`` (H, W, 2) absolute-coordinates array;
    mask is any image (nonzero = valid) or omitted."""

    def __init__(self, root: str, list_file: str = "pairs.txt", max_side: int = 0):
        self.root = root
        self.max_side = max_side
        self.entries = []
        with open(os.path.join(root, list_file)) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    self.entries.append(parts[:4])
        if not self.entries:
            raise ValueError(f"no pairs in {root}/{list_file}")

    def __len__(self):
        return len(self.entries)

    def get_pair(self, i: int):
        from PIL import Image

        e = self.entries[i]
        p = lambda name: os.path.join(self.root, name)
        img1 = np.asarray(Image.open(p(e[0])).convert("L"), np.float32)
        img2 = np.asarray(Image.open(p(e[1])).convert("L"), np.float32)
        aflow = (np.load(p(e[2])) if e[2].endswith(".npy")
                 else png_to_flow(p(e[2]))).astype(np.float32)
        if len(e) > 3:
            mask = np.asarray(Image.open(p(e[3]))) > 0
        else:
            mask = np.isfinite(aflow).all(-1)
        return img1, img2, aflow, mask & np.isfinite(aflow).all(-1)


class StyleTransferPairs:
    """Day-night style-transfer pair catalog — the AachenPairs_StyleTransferDayNight
    role (aachen.py:50-73): a folder of restyled images named
    ``<tag>.<ext>.st_<anything>`` is paired against the database image whose
    filename stem is ``<tag>``. Pairs are pixel-aligned (style transfer preserves
    geometry), so the aflow is identity over img1 — StillPairDataset semantics.
    """

    def __init__(self, db: ImageFolder, st_root: str, max_side: int = 640):
        self.db = db
        self.st_root = st_root
        self.max_side = max_side
        tag_of = {}
        for j, p in enumerate(db.paths):
            tag_of.setdefault(os.path.splitext(os.path.basename(p))[0], j)
        self.pairs = []       # (db index, restyled path)
        for f in sorted(os.listdir(st_root)):
            if ".st_" not in f:
                continue
            tag = os.path.splitext(f.split(".st_")[0])[0]
            if tag in tag_of:
                self.pairs.append((tag_of[tag], os.path.join(st_root, f)))
        if not self.pairs:
            raise FileNotFoundError(f"no '<tag>.<ext>.st_*' files under {st_root!r} "
                                    "matching the database images")

    def __len__(self):
        return len(self.pairs)

    def get_pair(self, i: int):
        from PIL import Image

        j, st_path = self.pairs[i]
        img1 = self.db.load_gray(j, self.max_side)
        H, W = img1.shape
        with Image.open(st_path) as im:
            im = im.convert("L")
            if im.size != (W, H):   # keep the pair pixel-aligned
                im = im.resize((W, H), Image.BILINEAR)
            img2 = np.asarray(im, np.float32)
        gy, gx = np.mgrid[0:H, 0:W]
        aflow = np.stack([gx, gy], -1).astype(np.float32)
        return img1, img2, aflow, np.ones((H, W), bool)


class FlowDirPairs:
    """Optical-flow pair catalog in the reference's directory layout — the
    AachenPairs_OpticalFlow role (aachen.py:79-146): ``root/flow/<tagA>_<tagB>.png``
    holds the RELATIVE flow from image tagA to tagB (x16 int16 PNG), with a matching
    validity mask at ``root/mask/<tagA>_<tagB>.png``; tags resolve to images by
    filename stem. Emitted aflow is absolute (flow + pixel grid), matching the
    reference's ``meta['aflow']`` (aachen.py:131-133) and FlowPairs' contract.
    """

    def __init__(self, images: ImageFolder, root: str):
        self.images = images
        self.root = root
        tag_of = {}
        for j, p in enumerate(images.paths):
            tag_of.setdefault(os.path.splitext(os.path.basename(p))[0], j)
        flow_dir = os.path.join(root, "flow")
        mask_dir = os.path.join(root, "mask")
        flows = {f for f in os.listdir(flow_dir) if f.endswith(".png")}
        masks = (set(os.listdir(mask_dir)) if os.path.isdir(mask_dir) else set())
        self.pairs = []       # (idx_a, idx_b, flow path, mask path | None)
        for f in sorted(flows):
            parts = f[:-4].split("_")
            if len(parts) != 2 or parts[0] not in tag_of or parts[1] not in tag_of:
                continue
            self.pairs.append((tag_of[parts[0]], tag_of[parts[1]],
                               os.path.join(flow_dir, f),
                               os.path.join(mask_dir, f) if f in masks else None))
        if not self.pairs:
            raise FileNotFoundError(f"no resolvable '<tagA>_<tagB>.png' flows under "
                                    f"{flow_dir!r}")

    def __len__(self):
        return len(self.pairs)

    def get_pair(self, i: int):
        from PIL import Image

        ja, jb, flow_path, mask_path = self.pairs[i]
        img1 = self.images.load_gray(ja)
        img2 = self.images.load_gray(jb)
        flow = png_to_flow(flow_path)
        H, W = flow.shape[:2]
        assert (H, W) == img1.shape, (
            f"flow {flow_path!r} is {(H, W)}, image 1 is {img1.shape}")
        gy, gx = np.mgrid[0:H, 0:W]
        aflow = (flow + np.stack([gx, gy], -1)).astype(np.float32)
        if mask_path is not None:
            mask = np.asarray(Image.open(mask_path)) > 0
            if mask.ndim == 3:
                mask = mask.any(-1)
        else:
            mask = np.ones((H, W), bool)
        return img1, img2, aflow, mask & np.isfinite(aflow).all(-1)


class CatPairs:
    """Concatenation of pair sources (CatPairDataset, pair_dataset.py:258-287)."""

    def __init__(self, *sources):
        self.sources = [s for s in sources if s is not None]
        self.offsets = np.cumsum([0] + [len(s) for s in self.sources])

    def __len__(self):
        return int(self.offsets[-1])

    def get_pair(self, i: int):
        k = int(np.searchsorted(self.offsets, i, side="right") - 1)
        return self.sources[k].get_pair(i - int(self.offsets[k]))


# ---------------------------------------------------------------- transforms

def _np_bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    H, W = img.shape
    x = np.clip(x, 0, W - 1.001)
    y = np.clip(y, 0, H - 1.001)
    xi, yi = x.astype(np.int32), y.astype(np.int32)
    fx, fy = x - xi, y - yi
    return ((1 - fy) * ((1 - fx) * img[yi, xi] + fx * img[yi, xi + 1])
            + fy * ((1 - fx) * img[yi + 1, xi] + fx * img[yi + 1, xi + 1]))


def tilt_second_image(rng: np.random.Generator, img2: np.ndarray,
                      aflow: np.ndarray, mask: np.ndarray,
                      max_rot: float = 0.25, max_persp: float = 2e-4,
                      max_scale: float = 0.15):
    """RandomTilting-equivalent (tools/transforms.py:213-280 behavior): warp img2 by a
    random homography and push aflow through it, exactly like PairLoader applies its
    distortions to the second image (dataloader.py:79-87)."""
    H2, W2 = img2.shape
    ang = rng.uniform(-max_rot, max_rot)
    sc = np.exp(rng.uniform(-max_scale, max_scale))
    persp = rng.uniform(-max_persp, max_persp, 2)
    c, s = np.cos(ang), np.sin(ang)
    A = np.array([[c * sc, -s * sc, 0.0], [s * sc, c * sc, 0.0],
                  [persp[0], persp[1], 1.0]])
    C = np.array([[1.0, 0, -W2 / 2], [0, 1.0, -H2 / 2], [0, 0, 1.0]])
    T = np.linalg.inv(C) @ A @ C

    # img2'[p] = img2[T^-1 p]
    gy, gx = np.mgrid[0:H2, 0:W2].astype(np.float32)
    pts = np.stack([gx, gy, np.ones_like(gx)], -1) @ np.linalg.inv(T).T
    img2w = _np_bilinear(img2, pts[..., 0] / pts[..., 2], pts[..., 1] / pts[..., 2])

    af = np.concatenate([aflow, np.ones_like(aflow[..., :1])], -1) @ T.T
    aflow2 = af[..., :2] / np.clip(af[..., 2:], 1e-8, None)
    inb = ((aflow2[..., 0] >= 0) & (aflow2[..., 0] <= W2 - 1)
           & (aflow2[..., 1] >= 0) & (aflow2[..., 1] <= H2 - 1))
    return img2w, aflow2.astype(np.float32), mask & inb


# ---------------------------------------------------------------- window loader

@dataclass
class WindowLoaderConfig:
    crop: int = 192              # output size (both crops), reference default 192
    n_samples: int = 5           # best-of-N window trials (dataloader.py n_samples)
    max_trials_factor: int = 50  # give up after 50*n candidate anchors (:146)
    tilt: bool = True            # random tilt/scale of image 2 before the search
    seed: int = 8214


class RandomWindowPairLoader:
    """The PairLoader equivalent (tools/dataloader.py:62-253): serve fixed-size
    flow-consistent crops from full-resolution pairs.

    Search semantics follow the reference: anchors are drawn from the valid-flow mask;
    the local flow scale sigma = sqrt(|det d(aflow)/d(x,y)|) (a median-free variant of
    :113-117) picks which window grows (1/sigma on the left for shrinking flow, sigma
    on the right for growing, skip outside [0.2, 5)); candidates score
    min(valid-coverage of window1, 16x16 occupancy of window2) (:167-177) and the best
    of ``n_samples`` wins. Crops resize to (crop, crop) with aflow scaled accordingly.
    """

    def __init__(self, source, cfg: WindowLoaderConfig = WindowLoaderConfig()):
        self.source = source
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

    def __len__(self):
        return len(self.source)

    @staticmethod
    def _window(c, size, limit):
        # same clamping as the reference's window1 (dataloader.py:121-127)
        l = int(c) - int(0.5 + size / 2)
        r = l + int(0.5 + size)
        if l < 0:
            l, r = 0, r - l
        if r > limit:
            l, r = l + limit - r, limit
        if l < 0:
            l, r = 0, limit
        return slice(l, r)

    def sample(self, i: int | None = None):
        """One (img1, img2, aflow, mask) sample of fixed (crop, crop) size."""
        cfg = self.cfg
        rng = self.rng
        idx = int(rng.integers(len(self.source))) if i is None else i
        img1, img2, aflow, mask = self.source.get_pair(idx)
        if cfg.tilt:
            img2, aflow, mask = tilt_second_image(rng, img2, aflow, mask)

        H1, W1 = img1.shape
        H2, W2 = img2.shape
        C = cfg.crop

        dx0, dx1 = np.gradient(aflow[..., 0])
        dy0, dy1 = np.gradient(aflow[..., 1])
        sigma = np.sqrt(np.clip(np.abs(dx1 * dy0 - dx0 * dy1), 1e-16, 1e16))

        flat_w = mask.ravel().astype(np.float64)
        n_valid = flat_w.sum()
        best = (-np.inf, None, None)
        if n_valid > 0:
            flat_w /= n_valid
            trials = 0
            for _ in range(cfg.max_trials_factor * cfg.n_samples):
                if trials >= cfg.n_samples:
                    break
                n = rng.choice(flat_w.size, p=flat_w)
                c1y, c1x = np.unravel_index(n, mask.shape)
                c2x, c2y = (aflow[c1y, c1x] + 0.5).astype(np.int32)
                if not (0 <= c2x < W2 and 0 <= c2y < H2):
                    continue
                sg = sigma[c1y, c1x]
                if 0.2 < sg < 1:
                    win1 = (self._window(c1y, C / sg, H1), self._window(c1x, C / sg, W1))
                    win2 = (self._window(c2y, C, H2), self._window(c2x, C, W2))
                elif 1 <= sg < 5:
                    win1 = (self._window(c1y, C, H1), self._window(c1x, C, W1))
                    win2 = (self._window(c2y, C * sg, H2), self._window(c2x, C * sg, W2))
                else:
                    continue
                x2 = aflow[win1][..., 0].ravel()
                y2 = aflow[win1][..., 1].ravel()
                valid = ((win2[1].start <= x2) & (x2 < win2[1].stop)
                         & (win2[0].start <= y2) & (y2 < win2[0].stop))
                score1 = (valid * mask[win1].ravel()).mean()
                occ = np.zeros((16, 16), bool)
                if valid.any():
                    qy = (16 * (y2[valid] - win2[0].start)
                          / max(win2[0].stop - win2[0].start, 1)).astype(int)
                    qx = (16 * (x2[valid] - win2[1].start)
                          / max(win2[1].stop - win2[1].start, 1)).astype(int)
                    occ[np.clip(qy, 0, 15), np.clip(qx, 0, 15)] = True
                score = min(score1, occ.mean())
                trials += 1
                if score > best[0]:
                    best = (score, win1, win2)

        if best[1] is None:  # no usable window: zero sample, all-invalid mask (:180-185)
            z = np.zeros((C, C), np.float32)
            return z, z.copy(), np.zeros((C, C, 2), np.float32), np.zeros((C, C), bool)

        _, win1, win2 = best
        c1 = img1[win1]
        c2 = img2[win2]
        af = aflow[win1] - np.float32([win2[1].start, win2[0].start])
        mk = mask[win1]

        c1, af, mk = _resize_triplet(c1, af, mk, C)
        if c2.shape != (C, C):
            sy = (C - 1) / max(c2.shape[0] - 1, 1)
            sx = (C - 1) / max(c2.shape[1] - 1, 1)
            c2 = _resize_img(c2, C)
            af = af * np.float32([sx, sy])
        inb = (af[..., 0] >= 0) & (af[..., 0] <= C - 1) & \
              (af[..., 1] >= 0) & (af[..., 1] <= C - 1)
        return c1, c2, af, mk & inb

    def batch(self, B: int):
        """(img1 (B, C, C), img2, aflow (B, C, C, 2), mask) float32/bool numpy."""
        samples = [self.sample() for _ in range(B)]
        return tuple(np.stack([s[j] for s in samples]) for j in range(4))

    def batches(self, B: int, steps: int):
        for _ in range(steps):
            yield self.batch(B)


def _resize_img(img: np.ndarray, C: int) -> np.ndarray:
    from PIL import Image

    if img.shape == (C, C):
        return img
    return np.asarray(Image.fromarray(img).resize((C, C), Image.BILINEAR), np.float32)


def _resize_triplet(img: np.ndarray, aflow: np.ndarray, mask: np.ndarray, C: int):
    """Resize the left crop + its aflow/mask to (C, C) — NEAREST for flow/mask like
    the reference (dataloader.py:216-221) so correspondences stay exact."""
    from PIL import Image

    if img.shape == (C, C):
        return img, aflow, mask
    img_r = _resize_img(img, C)
    afx = np.asarray(Image.fromarray(aflow[..., 0]).resize((C, C), Image.NEAREST))
    afy = np.asarray(Image.fromarray(aflow[..., 1]).resize((C, C), Image.NEAREST))
    mk = np.asarray(Image.fromarray(mask.astype(np.uint8)).resize(
        (C, C), Image.NEAREST)).astype(bool)
    return img_r, np.stack([afx, afy], -1).astype(np.float32), mk
