"""R2D2 self-supervised training CLI. Port of ``vo_tpu/runners/train_r2d2.py``.

    python -m vo_tpu_torch.runners.train_r2d2 --steps 2000 --save-path out.ckpt
    python -m vo_tpu_torch.runners.train_r2d2 --resume out.ckpt --steps 1000
    python -m vo_tpu_torch.runners.train_r2d2 --data-dir imgs/ --steps 2000   # real images
    python -m vo_tpu_torch.runners.train_r2d2 --data-dir imgs/ --flow-pairs flows/

Two data paths:
- default: synthetic pairs made on the device (no input data);
- ``--data-dir``: still and synthetic-homography pairs from a folder of images (plus
  stored-flow pairs with --flow-pairs, the style-transfer and flow-directory catalogs
  with --style-pairs / --flow-dir), served through the random-window crop search
  (``vo_tpu_torch.train.datasets``) by a background thread.
Checkpoints carry the optimizer state and the step, so --resume continues the count.
Runs on ``--device`` (default cuda; raises if there is no GPU).
"""

from __future__ import annotations

import argparse
import os
import time

from vo_tpu_torch import prng
from vo_tpu_torch.device import resolve_device, to_device
from vo_tpu_torch.models.patchnet import FAST_QUAD_L2NET_CONFCFS, QUAD_L2NET_CONFCFS
from vo_tpu_torch.train import TrainConfig, create_train_state, train_step, train_step_batch
from vo_tpu_torch.train.trainer import load_checkpoint, save_checkpoint

ARCHS = {
    "fast_quad": FAST_QUAD_L2NET_CONFCFS,
    "quad": QUAD_L2NET_CONFCFS,
}


def real_image_batches(args, cfg, steps: int, prefetch: int = 4):
    """Fixed-size numpy batches from the real-image pipeline, made ahead by a
    background thread."""
    import queue
    import threading

    from vo_tpu_torch.train.datasets import (CatPairs, FlowDirPairs, FlowPairs,
                                             ImageFolder, RandomWindowPairLoader,
                                             StillPairs, StyleTransferPairs,
                                             SyntheticHomographyPairs,
                                             WindowLoaderConfig)

    folder = ImageFolder(args.data_dir, select=getattr(args, "select", "") or "")
    sources = [StillPairs(folder), SyntheticHomographyPairs(folder)]
    if args.flow_pairs:
        sources.append(FlowPairs(args.flow_pairs))
    if getattr(args, "style_pairs", None):
        sources.append(StyleTransferPairs(folder, args.style_pairs))
    if getattr(args, "flow_dir", None):
        sources.append(FlowDirPairs(folder, args.flow_dir))
    loader = RandomWindowPairLoader(
        CatPairs(*sources),
        WindowLoaderConfig(crop=cfg.height, seed=cfg.seed))
    print(f"[train] real-image pipeline: {len(folder)} images, "
          f"{len(loader)} pairs, crop {cfg.height}")

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    perr: list = []

    def producer():
        """Catch and re-raise: a loader crash ends the stream with the error on
        record instead of leaving the train loop waiting at q.get."""
        try:
            for _ in range(steps):
                q.put(loader.batch(cfg.batch))
        except BaseException as e:
            perr.append(e)
        finally:
            q.put(None)

    threading.Thread(target=producer, daemon=True).start()
    while (b := q.get()) is not None:
        yield b
    if perr:
        raise RuntimeError("training pair loader died") from perr[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), default="fast_quad")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, nargs=2, default=(192, 192))
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--save-path", default="r2d2.ckpt")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--data-dir", default=None,
                    help="folder of real images -> still + homography pairs via the "
                         "random-window loader (default: synthetic pairs on the device)")
    ap.add_argument("--flow-pairs", default=None,
                    help="FlowPairs root (pairs.txt + stored aflow) added to the mix")
    ap.add_argument("--style-pairs", default=None,
                    help="folder of '<tag>.<ext>.st_*' restyled images paired "
                         "against --data-dir by filename tag")
    ap.add_argument("--flow-dir", default=None,
                    help="root with flow/<tagA>_<tagB>.png + mask/ resolving tags "
                         "against --data-dir")
    ap.add_argument("--select", default=None,
                    help="path-component filter for --data-dir (e.g. 'db day night')")
    ap.add_argument("--photometric", action="store_true", default=True)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = ARCHS[args.arch]
    cfg = TrainConfig(batch=args.batch, height=args.hw[0], width=args.hw[1], lr=args.lr)
    state = create_train_state(spec, cfg, device=dev)
    if args.resume and os.path.exists(args.resume):
        state = load_checkpoint(args.resume, state)
        print(f"[train] resumed from {args.resume} at step {int(state.step)}")

    key = prng.key(cfg.seed, dev)
    t0 = time.time()
    ema = None

    if args.data_dir:
        from vo_tpu_torch.train.pairs import photometric_augment_batch

        batch_iter = iter(real_image_batches(args, cfg, args.steps))

        def step_fn(state, sub):
            img1, img2, aflow, mask = (to_device(x, dev) for x in next(batch_iter))
            if args.photometric:
                img2 = photometric_augment_batch(sub, img2)
            return train_step_batch(state, (img1, img2, aflow, mask), spec, cfg)
    else:
        def step_fn(state, sub):
            return train_step(state, sub, spec, cfg)

    for i in range(args.steps):
        key, sub = prng.split(key).unbind(-2)
        state, metrics = step_fn(state, sub)
        loss = float(metrics["total"])
        ema = loss if ema is None else 0.95 * ema + 0.05 * loss
        step = int(state.step)
        if step % args.log_every == 0:
            rate = (i + 1) * cfg.batch / (time.time() - t0)
            print(f"[train] step {step} loss {loss:.4f} (ema {ema:.4f}) "
                  f"ap {float(metrics['ap']):.4f} cosim {float(metrics['cosim']):.4f} "
                  f"peaky {float(metrics['peaky']):.4f} | {rate:.1f} img/s")
        if step % args.save_every == 0:
            save_checkpoint(args.save_path, state, spec.name)
    save_checkpoint(args.save_path, state, spec.name)
    print(f"[train] saved {args.save_path} at step {int(state.step)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
