"""Standalone multiscale feature-extraction CLI. Port of ``vo_tpu/runners/extract.py``.

The counterpart of the reference's ``python extract.py --model ... --images ...``:
reads images (or ``.txt`` files listing one path per line), runs the full-pyramid
R2D2 extractor (``models/multiscale.py``) on the GPU unless ``--device`` says
otherwise, and writes ``<image>.<tag>`` npz files with the reference's keys (imsize,
keypoints Nx3, descriptors, scores). Images of one size go through the pyramid
together, in batches of ``--batch``.

    python -m vo_tpu_torch.runners.extract --model faster2d2_WASF_N16 \\
        --images img1.png img2.png --top-k 5000 --tag r2d2

``--model`` names a checkpoint under ``vo_tpu_torch/models/weights/``
(``models/port_weights.py::load_pretrained``); a missing one is an error.

A D2-Net model name (``d2_tf``, ``d2_ots``, ...: ``<name>.pth`` there,
``models/d2net.py::load_d2net_checkpoint``) runs ``extract_d2net`` instead, as the
upstream's ``extract_features.py`` does: single-scale, or at the scales 0.5, 1 and 2
with ``--multiscale``; it writes ``<image>.d2-net`` npz files (keypoints N x 3 [x, y,
1/scale], scores, descriptors). The R2D2 options do not apply to it.

    python -m vo_tpu_torch.runners.extract --model d2_tf --multiscale --images a.png
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np
import torch


def expand_image_list(paths: list[str]) -> list[str]:
    """Flatten ``.txt`` list files into image paths."""
    out = []
    queue = list(paths)
    while queue:
        p = queue.pop(0)
        if p.endswith(".txt"):
            with open(p) as f:
                queue = [line for line in f.read().splitlines() if line.strip()] + queue
        else:
            out.append(p)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="faster2d2_WASF_N16",
                    help="published checkpoint name (<name>.pt in the weights directory; "
                         "a d2_ name: D2-Net's <name>.pth)")
    ap.add_argument("--images", nargs="+", required=True,
                    help="image paths and/or .txt list files")
    ap.add_argument("--tag", default=None,
                    help="output suffix (-> <img>.<tag>; default r2d2, or d2-net for D2-Net)")
    ap.add_argument("--multiscale", action="store_true",
                    help="D2-Net: the scales 0.5, 1, 2 (default: 1 alone)")
    ap.add_argument("--top-k", type=int, default=5000)
    ap.add_argument("--scale-f", type=float, default=2 ** 0.25)
    ap.add_argument("--min-size", type=int, default=256)
    ap.add_argument("--max-size", type=int, default=1024)
    ap.add_argument("--min-scale", type=float, default=0.0)
    ap.add_argument("--max-scale", type=float, default=1.0)
    ap.add_argument("--reliability-thr", type=float, default=0.7)
    ap.add_argument("--repeatability-thr", type=float, default=0.7)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--kapture-root", default=None,
                    help="also write kapture-layout binary features under this root "
                         "(reconstruction/{keypoints,descriptors}/<tag>/<image>...)")
    ap.add_argument("--kapture-image-root", default=None,
                    help="base directory the kapture feature paths are relative to "
                         "(kapture keys features by the image's relative path); "
                         "defaults to the image's own directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if there is no GPU)")
    args = ap.parse_args(argv)

    from vo_tpu_torch.device import resolve_device
    from vo_tpu_torch.io.dataset import _read_png_rgb
    from vo_tpu_torch.models import d2net, port_weights
    from vo_tpu_torch.models.multiscale import (MultiscaleConfig, extract_multiscale,
                                                save_r2d2_npz)
    from vo_tpu_torch.models.patchnet import params_to

    dev = resolve_device(args.device)
    if args.model.startswith("d2_"):
        tag = args.tag or "d2-net"
        params = d2net.load_d2net_checkpoint(
            os.path.join(port_weights.MODELS_DIR, f"{args.model}.pth"))
        params = d2net.params_to(params, dev)
        dcfg = d2net.D2NetConfig(scales=(0.5, 1.0, 2.0) if args.multiscale else (1.0,))
        run = lambda imgs: d2net.extract_d2net(params, imgs, dcfg, device=dev)
        save = lambda p, feats, i, im: d2net.save_d2net_npz(f"{p}.{tag}", feats, frame=i)
    else:
        tag = args.tag or "r2d2"
        spec, params = port_weights.load_pretrained(args.model)
        params = params_to(params, dev)
        cfg = MultiscaleConfig(
            scale_f=args.scale_f, min_scale=args.min_scale, max_scale=args.max_scale,
            min_size=args.min_size, max_size=args.max_size, top_k=args.top_k,
            rel_thr=args.reliability_thr, rep_thr=args.repeatability_thr)
        run = lambda imgs: extract_multiscale(params, spec, imgs, cfg, device=dev)
        save = lambda p, feats, i, im: save_r2d2_npz(
            f"{p}.{tag}", feats, imsize=(im.shape[1], im.shape[0]), frame=i)

    by_shape: dict[tuple, list[tuple[str, np.ndarray]]] = defaultdict(list)
    for p in expand_image_list(args.images):
        img = _read_png_rgb(p)
        by_shape[img.shape].append((p, img))

    for group in by_shape.values():
        for s in range(0, len(group), args.batch):
            chunk = group[s:s + args.batch]
            feats = run(np.stack([im for _, im in chunk]))
            for i, (p, im) in enumerate(chunk):
                out = save(p, feats, i, im)
                print(f"Saving {int(feats.valid[i].sum())} keypoints to {out}")
                if args.kapture_root:
                    save_kapture_features(args.kapture_root, tag, p, feats, i,
                                          image_root=args.kapture_image_root)
    return 0


def save_kapture_features(root: str, tag: str, image_path: str, feats,
                          frame: int, image_root: str | None = None) -> tuple[str, str]:
    """Write one image's features in kapture's binary layout, as the reference's
    extract_kapture.py does: reconstruction/keypoints/<tag>/<rel-image>.kpt as raw
    float32 Nx3 [x, y, scale], reconstruction/descriptors/<tag>/<rel-image>.desc as raw
    float32 NxD, and the kapture 1.x CSV type headers.

    kapture keys features by the image's path relative to the records root, so the
    binary files mirror that subpath (``image_root``; by default the image's own
    directory, i.e. flat). The type headers are CSV tables (a 'name, dtype, dsize'
    row), the form ``kapture_from_dir`` parses."""
    v = feats.valid[frame].cpu().numpy()
    kp = feats.kp[frame].cpu().numpy()[v].astype(np.float32)                       # (N, 3)
    desc = feats.desc[frame].to(torch.float32).cpu().numpy()[v].astype(np.float32)  # (N, D)

    rel = (os.path.relpath(image_path, image_root) if image_root
           else os.path.basename(image_path))
    if rel.startswith(".."):
        raise ValueError(f"{image_path!r} is not under --kapture-image-root "
                         f"{image_root!r}")
    kdir = os.path.join(root, "reconstruction", "keypoints", tag)
    ddir = os.path.join(root, "reconstruction", "descriptors", tag)
    kpath = os.path.join(kdir, rel + ".kpt")
    dpath = os.path.join(ddir, rel + ".desc")
    os.makedirs(os.path.dirname(kpath), exist_ok=True)
    os.makedirs(os.path.dirname(dpath), exist_ok=True)
    kp.tofile(kpath)
    desc.tofile(dpath)
    with open(os.path.join(kdir, "keypoints.txt"), "w") as f:
        f.write("# kapture format: 1.1\n"
                "name, dtype, dsize\n"
                f"{tag}, float32, {kp.shape[1]}\n")
    with open(os.path.join(ddir, "descriptors.txt"), "w") as f:
        f.write("# kapture format: 1.1\n"
                "name, dtype, dsize, keypoints_type, metric_type\n"
                f"{tag}, float32, {desc.shape[1]}, {tag}, L2\n")
    return kpath, dpath


def load_kapture_features(root: str, tag: str, rel_image: str):
    """Parse back a ``save_kapture_features`` tree (strict kapture 1.x CSV headers).

    Returns (kp (N, 3) f32, desc (N, D) f32). Raises on malformed headers."""
    def read_table(path, expected_cols):
        with open(path) as f:
            lines = [line.strip() for line in f.read().splitlines() if line.strip()]
        if not lines[0].startswith("# kapture format: 1."):
            raise ValueError(f"{path}: missing kapture format line")
        cols = [c.strip() for c in lines[1].split(",")]
        if cols[:len(expected_cols)] != expected_cols:
            raise ValueError(f"{path}: bad column header {cols}")
        row = [c.strip() for c in lines[2].split(",")]
        return dict(zip(cols, row))

    kdir = os.path.join(root, "reconstruction", "keypoints", tag)
    ddir = os.path.join(root, "reconstruction", "descriptors", tag)
    kmeta = read_table(os.path.join(kdir, "keypoints.txt"), ["name", "dtype", "dsize"])
    dmeta = read_table(os.path.join(ddir, "descriptors.txt"),
                       ["name", "dtype", "dsize", "keypoints_type", "metric_type"])
    kp = np.fromfile(os.path.join(kdir, rel_image + ".kpt"),
                     dtype=np.dtype(kmeta["dtype"])).reshape(-1, int(kmeta["dsize"]))
    desc = np.fromfile(os.path.join(ddir, rel_image + ".desc"),
                       dtype=np.dtype(dmeta["dtype"])).reshape(-1, int(dmeta["dsize"]))
    return kp, desc


if __name__ == "__main__":
    raise SystemExit(main())
