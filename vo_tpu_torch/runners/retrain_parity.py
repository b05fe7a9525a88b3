"""Retrain-parity harness: does the training stack improve a from-scratch net?
Port of ``vo_tpu/runners/retrain_parity.py``.

Trains ``Fast_Quad_L2Net_ConfCFS`` from a random initialisation and scores MMA@3 on
the warp harness (``evalkit/mma.py``: the HPatches protocol on homography-warped
pairs) at initialisation, during and after training, beside the published weights
on the same harness when they are present.

    python -m vo_tpu_torch.runners.retrain_parity --steps 3000 --out report.json \\
        [--data-dir imgs/]

With ``--data-dir`` it trains on the images there through the real-image pipeline
(random-window crop search, photometric jitter) and evaluates on them, topped up with
procedural textures to 16 images; without it, it trains on synthetic pairs and
evaluates on procedural textures. ``--out`` must be given. Every net is scored with
the same threshold-free extractor settings (local maxima and a top-k budget ranked
by the repeatability head, no reliability, repeatability or score floors), so a
half-trained net is scored by its descriptors and detector, not by whether its
confidence heads cleared the deploy-time 0.7 / 0.85 bars. The report's keys are the
JAX runner's; its ``device`` is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np

from vo_tpu_torch import prng


def load_eval_images(data_dir: str | None, H: int = 240, W: int = 320,
                     min_images: int = 16) -> np.ndarray:
    """(B, H, W) gray eval batch: every image in ``data_dir`` (scaled to cover and
    centre-cropped), topped up with procedural textures to at least ``min_images``
    (a 4-image eval moves MMA@3 by 2.5 points per flipped match)."""
    paths = sorted(glob.glob(os.path.join(data_dir, "*.png")) +
                   glob.glob(os.path.join(data_dir, "*.jpg"))) if data_dir else []
    out = []
    if paths:
        from PIL import Image

        for p in paths:
            img = Image.open(p).convert("L")
            s = max(H / img.height, W / img.width)
            img = img.resize((int(round(img.width * s)), int(round(img.height * s))),
                             Image.BILINEAR)
            x0, y0 = (img.width - W) // 2, (img.height - H) // 2
            out.append(np.asarray(img.crop((x0, y0, x0 + W, y0 + H)), np.float32))
    if len(out) < min_images:
        from vo_tpu_torch.train.pairs import procedural_texture

        extra = procedural_texture(prng.key(7), min_images - len(out), H, W).numpy()
        out.extend(extra)
    return np.stack(out)


def mma3_of_params(spec, params, eval_images, max_kp: int = 1024, seed: int = 3,
                   device=None) -> dict:
    """MMA curve of a parameter dict on the warp harness, threshold-free settings,
    detections ranked by the repeatability head alone (``score_mode='rep'``: the
    deploy-time rel * rep collapses mid-training while the reliability head is still
    near zero where descriptor AP is below the loss base)."""
    from vo_tpu_torch.device import resolve_device
    from vo_tpu_torch.evalkit.mma import mma_on_warps
    from vo_tpu_torch.models.r2d2_extractor import R2D2Extractor

    dev = resolve_device(device)
    ex = R2D2Extractor.from_params(spec, params, max_kp=max_kp, rel_thr=0.0,
                                   rep_thr=0.0, score_thr=0.0, score_mode="rep")
    return mma_on_warps(lambda im: ex(im, device=dev), eval_images, prng.key(seed, dev),
                        device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--crop", type=int, default=160)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--data-dir", default=None,
                    help="image folder (default: synthetic pairs, procedural eval images)")
    ap.add_argument("--out", required=True, help="where the JSON report goes")
    ap.add_argument("--skip-ported", action="store_true")
    ap.add_argument("--sampler", choices=("grid", "ngh"), default="ngh",
                    help="AP-loss sampler; ngh = NghSampler2-style ring "
                         "positives/negatives + distractors")
    ap.add_argument("--lr-schedule", choices=("const", "cosine"), default="cosine")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from vo_tpu_torch.device import card_name, resolve_device, to_device
    from vo_tpu_torch.models.patchnet import FAST_QUAD_L2NET_CONFCFS
    from vo_tpu_torch.train import TrainConfig, create_train_state, train_step_batch
    from vo_tpu_torch.train.pairs import photometric_augment_batch

    dev = resolve_device(args.device)
    data_dir = args.data_dir
    spec = FAST_QUAD_L2NET_CONFCFS
    cfg = TrainConfig(batch=args.batch, height=args.crop, width=args.crop, lr=args.lr,
                      sampler=args.sampler, lr_schedule=args.lr_schedule,
                      total_steps=args.steps, warmup_steps=min(200, args.steps // 10))
    eval_images = load_eval_images(data_dir)
    print(f"[parity] eval batch {eval_images.shape}, data_dir={data_dir}")

    report: dict = {"steps": args.steps, "batch": args.batch, "crop": args.crop,
                    "lr": args.lr, "arch": spec.name, "data_dir": data_dir,
                    "sampler": args.sampler, "lr_schedule": args.lr_schedule,
                    "eval_images": int(eval_images.shape[0]), "curve": [],
                    "device": card_name(dev)}

    # The published weights through the same harness, when they are present.
    if not args.skip_ported:
        from vo_tpu_torch.models.port_weights import load_pretrained

        try:
            pspec, pparams = load_pretrained("faster2d2_WASF_N16")
        except FileNotFoundError as e:
            print(f"[parity] published weights unavailable: {e}")
            report["mma3_ported"] = None
        else:
            ported = mma3_of_params(pspec, pparams, eval_images, device=dev)
            report["mma3_ported"] = ported["mma@3"]
            report["mma3_ported_std"] = ported.get("mma@3_std")
            report["ported_mean_matches"] = ported["mean_matches"]
            print(f"[parity] ported faster2d2_WASF_N16: mma@3 {ported['mma@3']:.3f} "
                  f"({ported['mean_matches']:.0f} matches)")

    state = create_train_state(spec, cfg, device=dev)
    init = mma3_of_params(spec, state.params, eval_images, device=dev)
    report["mma3_init"] = init["mma@3"]
    report["init_mean_matches"] = init["mean_matches"]
    print(f"[parity] random init: mma@3 {init['mma@3']:.3f} "
          f"({init['mean_matches']:.0f} matches)")

    if data_dir:
        import queue
        import threading

        from vo_tpu_torch.train.datasets import (CatPairs, ImageFolder,
                                                 RandomWindowPairLoader, StillPairs,
                                                 SyntheticHomographyPairs,
                                                 WindowLoaderConfig)

        folder = ImageFolder(data_dir)
        loader = RandomWindowPairLoader(
            CatPairs(StillPairs(folder, 480), SyntheticHomographyPairs(folder, 480)),
            WindowLoaderConfig(crop=args.crop, seed=cfg.seed))

        bq: "queue.Queue" = queue.Queue(maxsize=4)
        perr: list = []

        def producer():
            """Catch and re-raise: a loader crash surfaces in the train loop instead
            of leaving it waiting at bq.get."""
            try:
                for _ in range(args.steps):
                    bq.put(loader.batch(cfg.batch))
            except BaseException as e:
                perr.append(e)
                bq.put(None)  # wakes a waiting consumer

        threading.Thread(target=producer, daemon=True).start()

        def get_batch():
            item = bq.get()
            if item is None:
                raise RuntimeError("training pair loader died") from (
                    perr[0] if perr else None)
            return tuple(to_device(x, dev) for x in item)
    else:
        from vo_tpu_torch.train.pairs import synthetic_pair_batch

        batch_key = [prng.key(11, dev)]

        def get_batch():
            batch_key[0], sub = prng.split(batch_key[0]).unbind(-2)
            return synthetic_pair_batch(sub, cfg.batch, cfg.height, cfg.width)

    key = prng.key(cfg.seed, dev)
    t0 = time.time()
    for i in range(1, args.steps + 1):
        key, sub = prng.split(key).unbind(-2)
        img1, img2, aflow, mask = get_batch()
        img2 = photometric_augment_batch(sub, img2)
        state, metrics = train_step_batch(state, (img1, img2, aflow, mask), spec, cfg)
        if i % args.eval_every == 0 or i == args.steps:
            m = mma3_of_params(spec, state.params, eval_images, device=dev)
            rate = i * cfg.batch / (time.time() - t0)
            report["curve"].append({"step": i, "mma3": m["mma@3"],
                                    "mma3_std": m.get("mma@3_std"),
                                    "mma3_per_pair": m.get("mma@3_per_pair"),
                                    "mean_matches": m["mean_matches"],
                                    "matches_per_pair": m.get("matches_per_pair"),
                                    "loss": float(metrics["total"])})
            print(f"[parity] step {i}: loss {float(metrics['total']):.4f} "
                  f"mma@3 {m['mma@3']:.3f} ({m['mean_matches']:.0f} matches) "
                  f"| {rate:.1f} img/s")
            _write(report, args.out, t0)   # a run cut short still reports

    _write(report, args.out, t0)           # --steps 0 still writes a report
    trained = report.get("mma3_trained")
    print(f"[parity] wrote {args.out}: init {report['mma3_init']:.3f} -> "
          f"trained {trained if trained is None else f'{trained:.3f}'} "
          f"(ported {report.get('mma3_ported')})")
    return 0


def _write(report: dict, out: str, t0: float) -> None:
    last = report["curve"][-1] if report["curve"] else None
    report["mma3_trained"] = last["mma3"] if last else None
    report["mma3_trained_std"] = last.get("mma3_std") if last else None
    report["trained_mean_matches"] = last["mean_matches"] if last else None
    report["mma3_trained_best"] = (max(c["mma3"] for c in report["curve"])
                                   if report["curve"] else None)
    # Match support: MMA on ~10 matches per pair says little.
    report["match_support_ok"] = (bool(last["mean_matches"] >= 25.0)
                                  if last else None)
    report["score_mode"] = "rep"
    report["notes"] = (
        "detections ranked by the repeatability head (score_mode=rep) for ALL nets: "
        "deploy-time rel*rep collapses mid-training because the reliability head is "
        "driven to ~0 wherever descriptor AP < the loss base; reliability is a "
        "matching confidence, not a detector")
    report["train_seconds"] = round(time.time() - t0, 1)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, out)


if __name__ == "__main__":
    raise SystemExit(main())
