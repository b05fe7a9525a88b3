"""End-to-end offline VO: batched extraction + back-projection + the frame loop, in
memory (``run_offline_vo``) or streamed from a loader (``run_offline_vo_streaming``),
with mid-run checkpoints.

Port of ``vo_tpu/engine/pipeline.py``, with the true-stereo front-end
(``stereo_extract_and_backproject``).
"""

from __future__ import annotations

import itertools
import queue
import threading

import numpy as np
import torch

from vo_tpu_torch.device import resolve_device, to_device
from vo_tpu_torch.engine.vo import ReplayTimer, VOConfig, VOEngine, VOStepDiagnostics
from vo_tpu_torch.features.extractor import Features, OrbLikeExtractor, extraction_counts
from vo_tpu_torch.features.pyramid import MultiScaleClassicExtractor
from vo_tpu_torch.features.stereo import stereo_depth_at
from vo_tpu_torch.geometry.camera import depth_to_3d_at, unproject
from vo_tpu_torch.port_state import state_from_numpy
from vo_tpu_torch.utils.profiling import span, timed

Extractor = OrbLikeExtractor | MultiScaleClassicExtractor


def _mm_to_metres(t: torch.Tensor) -> torch.Tensor:
    """uint16 millimetres (or their int16 bit patterns) -> fp32 metres; torch has few
    uint16 ops, so the values are widened through their int16 bits."""
    return (t.view(torch.int16).to(torch.int32) & 0xFFFF).to(torch.float32) * 1e-3


def extract_and_backproject(extractor: Extractor, images, depths, K):
    """Batched features + per-frame keypoint 3D back-projection on ``images.device``,
    with either extractor (single-scale, or the multi-scale SIFT-config one).

    images (F, H, W) gray or (F, H, W, 3) RGB; depths (F, H, W) fp32 metres or uint16
    millimetres (dequantised to metres here, on the device).
    """
    if depths.dtype == torch.uint16:
        depths = _mm_to_metres(depths)
    feats = extractor(images, device=images.device)
    return feats, depth_to_3d_at(depths, feats.kp, K)


def extract_and_kp_int16(extractor: Extractor, images):
    """Batched features + the integer pixel of each keypoint, for a host-side depth
    gather: truncated, then clipped into the image (the pixels ``depth_to_3d_at``
    reads), as int16 to halve the readback."""
    feats = extractor(images, device=images.device)
    H, W = images.shape[1], images.shape[2]
    xi = feats.kp[..., 0].to(torch.int32).clamp(0, W - 1)
    yi = feats.kp[..., 1].to(torch.int32).clamp(0, H - 1)
    return feats, torch.stack([xi, yi], dim=-1).to(torch.int16)


def backproject_sparse(kp, z_u16mm, K):
    """(B, N, 2) float kp + (B, N) uint16 millimetre depth -> (B, N, 3) camera points,
    unprojected at the float keypoint coordinates. Zero depth gives z == 0, which the
    engine's depth gate rejects."""
    return unproject(kp.to(torch.float32), _mm_to_metres(z_u16mm), K)


def gather_depth_u16mm(deps: np.ndarray, kp_i16: np.ndarray) -> np.ndarray:
    """Host-side sparse depth gather -> (B, N) uint16 millimetres.

    ``deps`` is the decoded chunk of depth maps: fp32 metres, or uint16 millimetres as
    read from a ``<u2`` npy (then gathered as they are). Metres are rounded (not
    truncated) to the millimetre, with NaN and infinities as 0.
    """
    b = np.arange(deps.shape[0])[:, None]
    z = deps[b, kp_i16[..., 1].astype(np.int32), kp_i16[..., 0].astype(np.int32)]
    if z.dtype == np.uint16:
        return z
    z = np.nan_to_num(np.asarray(z, np.float32), nan=0.0, posinf=0.0, neginf=0.0)
    return np.round(np.clip(z, 0.0, 65.535) * 1000.0).astype(np.uint16)


def stereo_extract_and_backproject(extractor: Extractor, left, right, K, baseline: float,
                                   max_disp: int = 128,
                                   device: str | torch.device | None = None):
    """True-stereo front-end: features of the left images, depth at each keypoint by
    ZNCC block matching along its row of the right image (``features/stereo.py``),
    back-projected -> (Features, kp3d (F, K, 3)).

    left, right (F, H, W) rectified gray, arrays or tensors, moved to ``device``
    (default cuda; raises if there is no GPU). A failed stereo match gives z == 0,
    which the engine's depth gate rejects, while the keypoint stays a 2-D observation
    for matching.
    """
    dev = resolve_device(device)
    left = to_device(left, dev)
    K = to_device(K, dev, torch.float32)
    feats = extractor(left, device=dev)
    depth, ok = stereo_depth_at(left.to(torch.float32), right, feats.kp, feats.valid, K,
                                baseline, max_disp=max_disp, device=dev)
    return feats, unproject(feats.kp.to(torch.float32), torch.where(ok, depth, 0.0), K)


def run_offline_vo(
    images,
    depths,
    K,
    vo_config: VOConfig = VOConfig(),
    extractor: Extractor | None = None,
    extraction_batch: int = 0,
    return_features: bool = False,
    device: str | torch.device | None = None,
):
    """Full pipeline on in-memory arrays -> (poses (F, 4, 4) np, diagnostics np).

    ``extractor`` defaults to ``OrbLikeExtractor()``; ``MultiScaleClassicExtractor``
    with ``matcher="ratio_float"`` is the SIFT config.
    Also returns (feats, kp3d) when ``return_features``. ``extraction_batch`` > 0
    extracts in chunks of that many frames to bound peak memory. Runs on ``device``
    (default cuda; raises if there is no GPU).
    """
    dev = resolve_device(device)
    if extractor is None:
        extractor = OrbLikeExtractor()
    K = to_device(np.asarray(K, np.float32), dev)
    images = to_device(images, dev)
    depths = to_device(depths, dev, torch.float32)

    n = images.shape[0]
    step = extraction_batch if extraction_batch and n > extraction_batch else n
    chunks = [extract_and_backproject(extractor, images[s:s + step], depths[s:s + step], K)
              for s in range(0, n, step)]
    feats = Features(*(torch.cat([c[0][i] for c in chunks]) for i in range(4)))
    kp3d = torch.cat([c[1] for c in chunks])

    engine = VOEngine(vo_config, device=dev)
    poses, diag = engine.run_sequence(feats.kp, feats.desc, feats.valid, kp3d, K)
    out = (poses.cpu().numpy(), type(diag)(*(d.cpu().numpy() for d in diag)))
    return out + ((feats, kp3d),) if return_features else out


def save_vo_checkpoint(path: str, next_frame: int, poses, state) -> None:
    """Mid-run checkpoint: the poses so far and the engine's carry (``VOState``) as one
    npz, in the JAX package's layout, so each package resumes the other's runs.

    bf16 fields (the descriptors) are stored as uint16 bit patterns under a
    ``state_{i}__bf16`` key; ``ref_id`` and ``bad_pnp`` are int32, the masks bool.
    """
    arrays = {}
    for i, x in enumerate(state):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[f"state_{i}__bf16"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[f"state_{i}"] = t.numpy()
    with open(path, "wb") as f:
        np.savez(f, next_frame=np.int64(next_frame), poses=np.asarray(poses), **arrays)


def load_vo_checkpoint(path: str, device: str | torch.device | None = None):
    """-> (next_frame, poses (n, 4, 4) np, VOState on ``device``)."""
    with np.load(path) as blob:
        return int(blob["next_frame"]), blob["poses"], state_from_numpy(blob, device)


def _pack_chunk_results(poses, diag) -> torch.Tensor:
    """A chunk's poses and diagnostics as ONE (B, 21) fp32 tensor, read back in one
    copy. Every field is exact in fp32 (counts < 2**24, flags 0/1)."""
    B = poses.shape[0]
    cols = [poses.reshape(B, 16)] + [d.to(torch.float32).reshape(B, 1) for d in diag]
    return torch.cat(cols, dim=1)


def _unpack_chunk_results(packed: np.ndarray):
    """Host-side inverse of ``_pack_chunk_results`` -> (poses (B, 4, 4), diagnostics)."""
    poses = packed[:, :16].reshape(-1, 4, 4)
    diag = VOStepDiagnostics(
        n_matches=packed[:, 16].astype(np.int32),
        n_inliers=packed[:, 17].astype(np.int32),
        accepted=packed[:, 18].astype(bool),
        promoted_keyframe=packed[:, 19].astype(bool),
        step_norm=packed[:, 20].astype(np.float32),
    )
    return poses, diag


class _Uploader:
    """Host -> device staging for the producer thread.

    On a GPU each array is copied into a ring of pinned host buffers and sent with a
    non-blocking copy on the producer's own stream; a buffer is reused only after its
    copy's event has completed. The consumer waits on the batch's event on its stream
    and marks the tensors as used there (``ready``). On the CPU arrays become tensors.
    """

    def __init__(self, dev: torch.device, slots: int):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if self.cuda else None
        self.ring = [dict() for _ in range(slots)]
        self.turn = 0
        self.bytes = 0

    def upload(self, *arrays: np.ndarray):
        """-> (device tensors, event or None)."""
        self.bytes += sum(a.nbytes for a in arrays)
        if not self.cuda:
            return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays], None
        slot = self.ring[self.turn % len(self.ring)]
        self.turn += 1
        if "event" in slot:
            slot["event"].synchronize()
        outs = []
        with torch.cuda.stream(self.stream):
            for k, a in enumerate(arrays):
                buf = slot.get(k)
                if buf is None or buf[1].shape != a.shape or buf[1].dtype != a.dtype:
                    # uint16 is staged as int16 bits (its numpy view is uint16 again)
                    dt = (torch.int16 if a.dtype == np.uint16
                          else torch.from_numpy(a.reshape(-1)[:0]).dtype)
                    t = torch.empty(a.shape, dtype=dt, pin_memory=True)
                    buf = slot[k] = (t, t.numpy().view(a.dtype))
                np.copyto(buf[1], a)
                t = buf[0].to(self.dev, non_blocking=True)
                outs.append(t.view(torch.uint16) if a.dtype == np.uint16 else t)
            slot["event"] = torch.cuda.Event()
            slot["event"].record(self.stream)
        return outs, slot["event"]

    @staticmethod
    def ready(tensors, event) -> None:
        """Consumer side: order the current stream after the batch's copies."""
        if event is None:
            return
        cur = torch.cuda.current_stream(tensors[0].device)
        cur.wait_event(event)
        for t in tensors:
            t.record_stream(cur)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Start a device -> host copy of ``t`` into pinned memory (non-blocking on a GPU)."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _take_rows(t: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
    """``t[rows]`` with a slice where the rows are a contiguous range (no index copy)."""
    if rows[-1] - rows[0] + 1 == len(rows):
        return t[int(rows[0]):int(rows[-1]) + 1]
    idx = torch.from_numpy(rows)
    if t.device.type == "cuda":
        idx = idx.pin_memory().to(t.device, non_blocking=True)
    return t.index_select(0, idx)


def run_offline_vo_streaming(
    batches,
    n_frames: int,
    K,
    vo_config: VOConfig = VOConfig(),
    extractor: Extractor | None = None,
    prefetch: int = 2,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume_from: str | None = None,
    retain: str = "all",
    retain_stride: int = 4,
    transfer_depth: str = "float32",
    device: str | torch.device | None = None,
    stats: dict | None = None,
):
    """Streaming pipeline: decode and upload overlap the device's work, host memory is
    O(batch). Runs on ``device`` (default cuda; raises if there is no GPU).

    ``batches`` yields ``(start_index, imgs (B, H, W[, 3]) uint8/float, depths
    (B, H, W))`` with a FIXED batch size, the tail padded by repeating the last frame
    (``RGBDSequence.iter_batches`` and ``NativeRGBDSequence.iter_batches`` do). A
    producer thread pulls the batches and stages them on the device; the consumer
    extracts and runs the engine one chunk at a time (``VOEngine.run_chunk``).

    Checkpoints: with ``checkpoint_path``, every ``checkpoint_every`` frames (and at
    the end) the poses so far and the engine's carry are written; ``resume_from``
    restores them and skips the frames already done (their batches are still decoded:
    the loaders are sequential).

    Retention: ``retain="all"`` keeps every frame's features; ``"sparse"`` keeps
    promoted keyframes, every ``retain_stride``-th frame and the last frame.

    Depth transfer: ``"float32"`` sends the depth maps as metres; ``"uint16mm"`` as
    rounded millimetres (half the bytes; depths beyond 65.535 m clamp);
    ``"sparse"`` sends none: the keypoints' integer pixels come back (int16), the host
    gathers their depths from the map it holds (``gather_depth_u16mm``) and only those
    go up, as uint16 millimetres (``backproject_sparse``). The same points as
    ``"uint16mm"``.

    Readback: each chunk's poses and diagnostics come back as one packed array,
    deferred by one chunk so that the copy overlaps the next chunk's work; in sparse
    mode they ride the same synchronisation as the next chunk's keypoints.

    Returns (poses, diag, (feats, kp3d, feat_rows)); ``feat_rows`` is the frame of each
    retained feature row. ``stats``, when given, receives the consumer's seconds
    waiting on the producer (``queue_wait_s``), waiting on the device's readbacks
    (``sync_wait_s``) and issuing the engine's steps (``engine_s``; the engine has no
    host sync, so this is its host time), ``h2d_bytes``, ``d2h_bytes``, ``chunks``, and
    the engine's steps replayed from its CUDA graph (``graph_replays``) and run eagerly
    (``eager_steps``: every step off CUDA, the step before a capture on it), the device
    seconds of those replays (``engine_device_s``: CUDA events around each, read after
    the readback that follows it, so no sync of their own; 0 off CUDA), PnP's
    Gauss-Newton solves through its kernel (``gn_kernel_solves``) and its hypothesis
    banks through the bank kernel (``bank_kernel_calls``); the engine counts the steps,
    the solves and the banks (``VOEngine.counts``); and ``OrbLikeExtractor``'s calls
    replayed from its CUDA graph (``extract_graph_replays``) and run eagerly
    (``extract_eager_calls``: every call off CUDA, the call before a capture on it).
    """
    if retain not in ("all", "sparse"):
        raise ValueError(f"retain must be 'all' or 'sparse', got {retain!r}")
    if transfer_depth not in ("float32", "uint16mm", "sparse"):
        raise ValueError(f"transfer_depth must be 'float32', 'uint16mm' or 'sparse', "
                         f"got {transfer_depth!r}")
    dev = resolve_device(device)
    if extractor is None:
        extractor = OrbLikeExtractor()
    Kd = to_device(np.asarray(K, np.float32), dev)
    engine = VOEngine(vo_config, device=dev)
    extract0 = extraction_counts()
    timer = engine.replay_timer = (ReplayTimer() if stats is not None and dev.type == "cuda"
                                   else None)

    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()
    err: list[BaseException] = []
    up = _Uploader(dev, slots=max(prefetch, 1) + 1)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        """Decode side: pulls batches and stages them on the device. In sparse mode
        the depth maps stay on the host for the consumer's gather. Its k-th batch is
        the consumer's chunk k (spans ``loader.next``, ``loader.upload``)."""
        try:
            it = iter(batches)
            for k in itertools.count():
                with span("loader.next", chunk=k):
                    got = next(it, None)
                if got is None:
                    break
                start, imgs, deps = got
                imgs = np.asarray(imgs)
                if transfer_depth == "sparse":
                    with span("loader.upload", chunk=k):
                        (imgs_d,), ev = up.upload(imgs)
                    item = (start, imgs_d, np.asarray(deps), ev)
                else:
                    deps = np.asarray(deps)
                    if transfer_depth == "uint16mm":
                        if deps.dtype != np.uint16:   # native u16mm arrives quantised
                            deps = np.nan_to_num(deps.astype(np.float32), nan=0.0,
                                                 posinf=0.0, neginf=0.0)
                            deps = np.round(np.clip(deps, 0.0, 65.535)
                                            * 1000.0).astype(np.uint16)
                    else:
                        deps = deps.astype(np.float32, copy=False)
                    with span("loader.upload", chunk=k):
                        (imgs_d, deps_d), ev = up.upload(imgs, deps)
                    item = (start, imgs_d, deps_d, ev)
                if not put(item):
                    return
        except BaseException as e:  # surface decode errors on the consumer side
            err.append(e)
        finally:
            put(None)

    worker = threading.Thread(target=producer, daemon=True)
    worker.start()

    state = None
    next_frame = 0
    poses_list = []
    if resume_from:
        next_frame, poses_done, state = load_vo_checkpoint(resume_from, dev)
        poses_list.append(np.asarray(poses_done))

    feat_chunks = []
    feat_rows_list = []
    diag_chunks = []
    since_ckpt = 0
    queue_wait = sync_wait = engine_s = 0.0     # seconds, from the spans' clock reads
    h2d_sparse = d2h_bytes = 0
    n_chunks = 0

    def wait(ev, what: str) -> None:
        """Block until ``ev`` (None on the CPU) has completed, counting the seconds."""
        nonlocal sync_wait
        if ev is not None:
            with timed("stream.sync_wait", what=what) as t:
                ev.synchronize()
            sync_wait += t.seconds

    def retain_chunk(feats, kp3d, start, promoted):
        """Keep this chunk's feature rows per the retention policy (``promoted`` covers
        the processed rows; zeros for rows skipped on resume)."""
        B = len(promoted)
        fid = np.arange(start, start + B)
        keep = fid < n_frames              # tail padding rows are never real frames
        if retain == "sparse":
            keep &= (promoted | (fid % retain_stride == 0) | (fid == n_frames - 1))
        rows = np.nonzero(keep)[0]
        if len(rows):
            feat_chunks.append((Features(*(_take_rows(a, rows) for a in feats)),
                                _take_rows(kp3d, rows)))
            feat_rows_list.append(fid[rows])

    # One-chunk software pipeline: chunk i's results are read after chunk i+1's work
    # has been issued.
    pending = None   # (start, B, lo, n_real, end, feats, kp3d, packed_host, event, state,
    #                   the replay timer's mark after the chunk's steps)

    def flush(synced: bool = False):
        """Consume the pending chunk's results (``synced``: its copy is known done)."""
        nonlocal pending, since_ckpt
        if pending is None:
            return
        start, B, lo, n_real, end, feats, kp3d, packed_host, ev, st, mark = pending
        pending = None
        if not synced:
            wait(ev, "flush")
        if timer is not None:
            timer.read(mark)                  # the chunk's replays ran before ``ev``
        with span("stream.flush"):
            poses_np, diag_np = _unpack_chunk_results(packed_host.numpy())
            poses_list.append(poses_np[:n_real])
            diag_chunks.append(VOStepDiagnostics(*(a[:n_real] for a in diag_np)))
            promoted = np.zeros(B, bool)
            promoted[lo:lo + n_real] = diag_chunks[-1].promoted_keyframe
            retain_chunk(feats, kp3d, start, promoted)
            since_ckpt += n_real
            if checkpoint_path and checkpoint_every and since_ckpt >= checkpoint_every:
                save_vo_checkpoint(checkpoint_path, end, np.concatenate(poses_list), st)
                since_ckpt = 0

    def record_event():
        if dev.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    try:
        for k in itertools.count():
            # Chunk k: spans stream.chunk > queue_wait, extract, sync_wait,
            # depth_gather, engine.chunk, pack, flush (the last for chunk k - 1).
            with span("stream.chunk", chunk=k):
                with timed("stream.queue_wait") as t:
                    item = q.get()
                queue_wait += t.seconds
                if item is None:
                    flush()
                    break
                start, imgs_d, deps_x, ev = item
                _Uploader.ready([imgs_d] + ([] if transfer_depth == "sparse" else [deps_x]),
                                ev)
                n_chunks += 1
                if transfer_depth == "sparse":
                    # One synchronisation per chunk: it waits for this chunk's keypoint
                    # pixels, and the previous chunk's packed results (copied earlier
                    # on the same stream) are then in host memory too.
                    with span("stream.extract", device=True, rows=imgs_d.shape[0]):
                        feats, kp_i16 = extract_and_kp_int16(extractor, imgs_d)
                        kp_host = _to_host(kp_i16)
                        kp_ev = record_event()
                    wait(kp_ev, "readback")
                    d2h_bytes += kp_i16.numel() * 2
                    flush(synced=True)
                    with span("stream.depth_gather"):
                        z16 = torch.from_numpy(gather_depth_u16mm(deps_x, kp_host.numpy()))
                        if dev.type == "cuda":
                            z16 = z16.view(torch.int16).pin_memory().to(dev,
                                                                         non_blocking=True)
                        h2d_sparse += z16.numel() * 2
                        kp3d = backproject_sparse(feats.kp, z16, Kd)
                else:
                    with span("stream.extract", device=True, rows=imgs_d.shape[0]):
                        feats, kp3d = extract_and_backproject(extractor, imgs_d, deps_x, Kd)

                B = feats.kp.shape[0]
                end = min(start + B, n_frames)
                if end <= next_frame:
                    flush()                       # keep feat_chunks in frame order
                    retain_chunk(feats, kp3d, start, np.zeros(B, bool))
                    continue                      # resumed past this chunk entirely
                lo = max(next_frame - start, 0)   # first unprocessed row in this chunk

                if state is None:
                    state = engine.initial_state(feats.kp[0], feats.desc[0],
                                                 feats.valid[0], kp3d[0])
                    poses_list.append(np.eye(4, dtype=np.float32)[None])
                    next_frame = 1
                    lo = 1
                    if end <= 1:
                        retain_chunk(feats, kp3d, start, np.zeros(B, bool))
                        continue
                with timed("engine.chunk", rows=B - lo) as t:
                    state, poses, diag = engine.run_chunk(
                        state, feats.kp[lo:], feats.desc[lo:], feats.valid[lo:], kp3d[lo:],
                        range(start + lo, start + B), Kd)
                engine_s += t.seconds
                n_real = end - (start + lo)       # drop tail padding rows
                with span("stream.pack"):
                    packed = _pack_chunk_results(poses, diag)
                    packed_host = _to_host(packed)
                    d2h_bytes += packed.numel() * 4
                    packed_ev = record_event()
                flush()                           # read chunk i-1 while chunk i computes
                mark = timer.mark() if timer is not None else 0
                pending = (start, B, lo, n_real, end, feats, kp3d, packed_host, packed_ev,
                           state, mark)
                next_frame = end
    finally:
        stop.set()
        worker.join()
    if err:
        raise err[0]
    if not feat_chunks:
        raise ValueError("empty batch stream")
    if checkpoint_path:
        save_vo_checkpoint(checkpoint_path, next_frame, np.concatenate(poses_list), state)
    if stats is not None:
        stats.update(queue_wait_s=queue_wait, sync_wait_s=sync_wait, engine_s=engine_s,
                     h2d_bytes=up.bytes + h2d_sparse, d2h_bytes=d2h_bytes, chunks=n_chunks,
                     **engine.counts(),
                     **{k: v - extract0[k] for k, v in extraction_counts().items()},
                     engine_device_s=timer.seconds if timer is not None else 0.0)

    feats = Features(*(torch.cat([c[0][i] for c in feat_chunks]) for i in range(4)))
    kp3d = torch.cat([c[1] for c in feat_chunks])
    feat_rows = np.concatenate(feat_rows_list)
    poses = np.concatenate(poses_list)[:n_frames]
    diag = VOStepDiagnostics(*(np.concatenate(xs) for xs in zip(*diag_chunks)))
    # On resume the diagnostics before the checkpoint are gone: front-pad with neutral
    # rows so that there is still one row per frame 1..F-1.
    missing = (n_frames - 1) - diag.accepted.shape[0]
    if missing > 0:
        diag = VOStepDiagnostics(*(np.concatenate(
            [np.zeros((missing,) + a.shape[1:], a.dtype), a]) for a in diag))
    return poses, diag, (feats, kp3d, feat_rows)
