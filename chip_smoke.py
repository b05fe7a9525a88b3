"""Smoke run of the PyTorch port (``vo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on any failure:

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles both match kernels from ``vo_tpu_torch/ops/csrc`` (nvcc) and prints
   ptxas's registers and spills for each: the wgmma kernel (bf16 operands,
   ``match_wgmma.cu``) and the SIMT kernel (fp32 operands, ``match_kernel.cu``);
3. kernels vs plain: each kernel against ``top2_mutual_plain`` on the card: workload
   descriptors, tie-heavy cases, ragged and tiny shapes, widths that need padding,
   Nb > 16384, SIFT-like descriptors, a misaligned view, all-invalid columns, and
   calls in a row that grow and shrink the cached scratch;
4. main path: the port's ``run_offline_vo`` on the 160-frame 376 x 1232 synthetic
   RGB-D slalom (2048 keypoints, 512 hypotheses); asserts the trajectory gate, one
   wgmma launch per tracked frame, and identical poses from the plain matcher;
5. float-mode path: the engine with the ``ratio_mutual_nn`` matcher on the first 32
   frames' descriptors as fp32 unit vectors (+-1/16); asserts one SIMT launch per
   tracked frame and identical poses from the plain matcher;
6. SIFT-config path: ``run_offline_vo`` on the same frames with the multi-scale DoG +
   oriented gradhist extractor and the ``ratio_float`` matcher (``bench.py:337-386``);
   asserts the gate and one SIMT launch per tracked frame; the plain-matcher engine on
   the same features passes the gate too; times extraction and the engine;
7. timing: extraction and the engine over the first 48 frames, and the kernels
   (wgmma at 2048 x 2048 x 256 bf16;
   SIMT at 2048 x 2048 x 128 on the SIFT frames' descriptors and at 2048 x 2048 x 256
   on the main path's as fp32) against their plain versions, a library yardstick and
   the bound; one CUDA kernel per SIMT call under the profiler; then a profile of
   extraction and the engine;
8. streaming, CLI and online: the frames written to disk in the JAX bench's
   io-included format (gray PNG + ``<u2`` millimetre npy, ``bench.py:81-102``); the
   ``vo_run`` CLI on them (native loader, sparse depth transfer, ``--eval``): the
   gate, one wgmma launch per tracked frame, and ``run_offline_vo``'s poses on the
   decoded frames; a ``--limit 96`` run's checkpoint resumed to the uninterrupted
   poses; the SIFT config through the CLI (48 frames, SIMT launches only); ``OnlineVO``
   on 16 frames against ``run_offline_vo``; then, over the first 48 frames, each
   streaming pass (3 sparse, 1 float32, 1 uint16mm) followed by a pass of the
   in-memory extract + engine, the loader's decode-only ceiling, and a profile of two
   chunks of the sparse stream.

The last line of standard output is one JSON object with ``ok`` and the device; the
line before it lists each kernel and shape with its launches, error, times and bound.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import time

import numpy as np

F, H, W = 160, 376, 1232
EXTRACT_BATCH = 16
STEP = 0.8
K = np.array([[721.53, 0.0, 609.55], [0.0, 721.53, 172.85], [0.0, 0.0, 1.0]], np.float32)

F_FLOAT = 32           # depth of the float-mode path
N_PASSES = 3           # timed passes per path (median)
F_TIMED = 48           # frames of each timed pass

# H100 SXM published dense peaks (NVIDIA data sheet) for the bounds of the kernels.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12      # fp32 on the CUDA cores
PEAK_HBM_BYTES = 3.35e12


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _device_profile(fn):
    """(device-busy ms, CUDA kernels launched, top kernels) of one ``fn()`` run under
    torch.profiler; (None, None, []) when the trace holds no device time.

    Traces the device activity only and reads the raw trace events: building the
    profiler's event tree (``key_averages``) for the ~10,900 launches of each engine
    step takes minutes.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            count, ns = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (count + 1, ns + e.duration_ns())
    busy_ns = sum(ns for _, ns in by_name.values())
    if busy_ns <= 0:
        return None, None, []
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    return (busy_ns / 1e6, sum(count for count, _ in by_name.values()),
            [(name[:60], count, ns / 1e6) for name, (count, ns) in top])


def _counts() -> dict:
    from vo_tpu_torch.ops import match

    return {"wgmma": match.launch_wgmma.launches, "simt": match.launch_simt.launches}


def _reset_counts() -> None:
    from vo_tpu_torch.ops import match

    match.launch_wgmma.launches = match.launch_simt.launches = 0


KERNELS = ("top2_wgmma_kernel", "top2_simt_kernel")


def _ptxas_lines(out: str) -> list[str]:
    """ptxas's register and spill lines, each with the kernel it belongs to."""
    lines, kernel = [], "?"
    for line in out.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in KERNELS if k in line), line.strip())
        elif "registers" in line or "spill" in line:
            lines.append(f"{kernel}: {line.replace('ptxas info    :', '').strip()}")
    return lines


def _binary_case(rng, na, nb, d=256):
    """+-1 descriptors with planted near-copies, duplicate rows and duplicate columns."""
    a = np.sign(rng.normal(size=(na, d))).astype(np.float32)
    b = np.sign(rng.normal(size=(nb, d))).astype(np.float32)
    n = min(na, nb) // 2
    b[:n] = np.roll(a, 7, axis=0)[:n]
    b[:n][rng.uniform(size=(n, d)) < 0.05] *= -1.0
    k = min(64, na - n, nb - n)
    b[n:n + k] = b[:k]                       # duplicate columns: best == second
    a[n:n + k] = a[:k]                       # duplicate rows: column ties
    b[:n][rng.uniform(size=n) < 0.02] = 0.0  # zero descriptors: columns of equal zeros
    return a, b, rng.uniform(size=na) > 0.1, rng.uniform(size=nb) > 0.1


def _float_case(rng, na, nb, d):
    a = rng.normal(size=(na, d)).astype(np.float32)
    b = rng.normal(size=(nb, d)).astype(np.float32)
    n = min(300, na, nb)
    b[:n] = a[:n] + 0.05 * rng.normal(size=(n, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    return a, b, rng.uniform(size=na) > 0.1, rng.uniform(size=nb) > 0.1


def _check_kernel(name, a, b, va, vb, bf16, exact=None) -> float:
    """Kernel vs plain on the card (one launch of the kernel that ``bf16`` selects);
    returns the largest |top2| difference. ``exact`` (default: ``bf16``) holds +-1
    operands, whose products and sums are exact, to equal outputs."""
    import torch

    from vo_tpu_torch.ops import match

    before = _counts()
    got = [x.cpu().numpy() for x in match.top2_mutual(a, b, va, vb, bf16=bf16)]
    torch.cuda.synchronize()
    kernel = "wgmma" if bf16 else "simt"
    after = _counts()
    if after[kernel] != before[kernel] + 1 or sum(after.values()) != sum(before.values()) + 1:
        raise AssertionError(f"{name}: expected one {kernel} launch, counts {before} -> {after}")
    ref = [x.cpu().numpy() for x in match.top2_mutual_plain(a, b, va, vb, bf16=bf16)]
    torch.cuda.synchronize()
    (nn12, top2, nn21), (r12, rtop2, r21) = got, ref
    err = float(np.abs(top2 - rtop2).max())
    if bf16 if exact is None else exact:    # +-1 products and integer sums: exact
        ok = (nn12 == r12).all() and (nn21 == r21).all() and err == 0.0
    else:         # fp32 sums in another order: 1e-5, indices where the gap is clear
        sure = rtop2[:, 0] - rtop2[:, 1] > 1e-4
        ok = err <= 1e-5 and (nn12[sure] == r12[sure]).all()
    print(f"{kernel} kernel vs plain [{name}] {tuple(a.shape)} x {tuple(b.shape)}: "
          f"max|top2 err| {err:g}, nn12 diffs {int((nn12 != r12).sum())}, "
          f"nn21 diffs {int((nn21 != r21).sum())} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"match kernel disagrees with the plain version on {name}")
    return err


def _synthetic_checks(dev) -> dict:
    """Phase 3: every kernel against its plain version on made-up cases."""
    import torch

    from vo_tpu_torch.ops.match_timing import sift_like

    rng = np.random.default_rng(8214)
    # (name, arrays, bf16, exact)
    cases = [("binary ties", _binary_case(rng, 2048, 2048), True, True),
             ("binary ties, new inputs", _binary_case(rng, 2048, 2048), True, True),
             ("binary Nb > 16384", _binary_case(rng, 2048, 20000), True, True),
             ("binary 1 x 1", _binary_case(rng, 1, 1), True, True),
             ("binary ragged", _binary_case(rng, 63, 65), True, True),
             ("binary ragged", _binary_case(rng, 129, 257), True, True),
             ("binary D = 100", _binary_case(rng, 300, 280, 100), True, True),
             ("binary D = 64", _binary_case(rng, 500, 600, 64), True, True),
             ("binary ties, after smaller calls", _binary_case(rng, 2048, 2048), True, True),
             ("SIFT-like", sift_like(rng, 2048, 2048), False, False),
             ("float", _float_case(rng, 1000, 1200, 128), False, False),
             ("float D = 100", _float_case(rng, 300, 280, 100), False, False),
             ("float D = 130", _float_case(rng, 300, 280, 130), False, False),
             ("binary as fp32", _binary_case(rng, 2048, 2048), False, True),
             ("binary as fp32 1 x 1", _binary_case(rng, 1, 1), False, True),
             ("binary as fp32 ragged", _binary_case(rng, 63, 65), False, True),
             ("binary as fp32 ragged", _binary_case(rng, 129, 257), False, True),
             ("binary as fp32 Nb > 16384", _binary_case(rng, 2048, 20000), False, True),
             ("binary as fp32 D = 64, smaller call", _binary_case(rng, 500, 600, 64), False, True),
             ("SIFT-like, after smaller calls", sift_like(rng, 2048, 2048), False, False)]
    errs = {"wgmma": [], "simt": []}
    for name, arrays, bf16, exact in cases:
        a, b, va, vb = (torch.from_numpy(x).to(dev) for x in arrays)
        if bf16:
            a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        errs["wgmma" if bf16 else "simt"].append(
            _check_kernel(name, a, b, va, vb, bf16, exact))

    # fp32 edge cases: a view 4 bytes into its storage (TMA needs 16-byte aligned
    # operands: the wrapper copies it), and no valid column at all.
    a, b, va, vb = (torch.from_numpy(x).to(dev) for x in _binary_case(rng, 300, 400))
    flat = torch.zeros(a.numel() + 1, dtype=torch.float32, device=dev)
    a_view = flat[1:].view(a.shape)
    a_view.copy_(a)
    if a_view.data_ptr() % 16 == 0:
        raise AssertionError("the misaligned case is aligned")
    errs["simt"].append(_check_kernel("binary as fp32, misaligned view", a_view, b, va, vb,
                                      False, True))
    errs["simt"].append(_check_kernel("binary as fp32, no valid column", a, b, va,
                                      torch.zeros_like(vb), False, True))
    return errs


def _gate(name, poses, accepted, gt, launches=None) -> bool:
    """The trajectory gate of ``bench.py``; prints the line and returns pass/fail."""
    from vo_tpu_torch.evalkit import KittiOdomEvaluator

    res = KittiOdomEvaluator().evaluate(gt, poses)
    accept = float(np.mean(accepted))
    drift = float(np.linalg.norm(poses[-1, :3, 3] - gt[-1, :3, 3]))
    sane = (res.seg_trans_err_pct < 1.5 and res.seg_rot_err_deg_per_100m < 2.0
            and accept > 0.8 and np.isfinite(poses).all())
    print(f"trajectory [{name}]: seg_trans {res.seg_trans_err_pct:.4f} %, seg_rot "
          f"{res.seg_rot_err_deg_per_100m:.4f} deg/100m, accept {accept:.3f}, final drift "
          f"{drift:.3f} m" + ("" if launches is None else f", match launches {launches}")
          + f" -> {'ok' if sane else 'FAIL'}")
    return sane


def _timed_passes(extractor, engine, imgs_d, deps_d, Kd, n_passes=N_PASSES):
    """Extraction and engine ms/frame over ``n_passes`` passes (median) of the first
    ``F_TIMED`` frames, and the features of the last pass."""
    import torch

    from vo_tpu_torch.engine.pipeline import extract_and_backproject

    t_ex, t_en = [], []
    for _ in range(n_passes):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        chunks = [extract_and_backproject(extractor, imgs_d[s:s + EXTRACT_BATCH],
                                          deps_d[s:s + EXTRACT_BATCH], Kd)
                  for s in range(0, F_TIMED, EXTRACT_BATCH)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        feats = [torch.cat([c[0][i] for c in chunks]) for i in (0, 1, 3)]
        k3 = torch.cat([c[1] for c in chunks])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        engine.run_sequence(*feats, k3, Kd)
        torch.cuda.synchronize()
        t_ex.append((t2 - t1) / F_TIMED * 1e3)
        t_en.append((time.perf_counter() - t3) / F_TIMED * 1e3)
    return float(np.median(t_ex)), float(np.median(t_en)), t_ex, t_en, (*feats, k3)


def _profile_lines(card, stage, fn, per, wall_ms) -> None:
    busy_ms, n_kernels, top = _device_profile(fn)
    if busy_ms is None:
        print(f"profile [{card}] {stage}: device time not measured (empty trace)")
        return
    busy = busy_ms / per
    print(f"profile [{card}] {stage}: device busy {busy:.3f} ms/frame of "
          f"{wall_ms:.3f} ms/frame wall (idle share {1.0 - busy / wall_ms:.3f}), "
          f"{n_kernels / per:.0f} CUDA kernels/frame")
    for name, count, ms in top:
        print(f"  {stage} top kernel: {ms / per:.4f} ms/frame, {count / per:.0f}/frame, "
              f"{name}")


def _ms_per_frame(seconds: float, n: int) -> float:
    return seconds / n * 1e3


def _streaming_phase(card, imgs, deps, gt) -> None:
    """Phase 8: the port as users launch it, on the frames written to disk in the JAX
    bench's io-included format (8-bit gray PNG + ``<u2`` millimetre npy) in a temporary
    directory under the git-ignored ``vo_tpu_torch/_build/``, removed at the end."""
    import shutil
    import tempfile

    import torch

    import vo_tpu_torch
    from vo_tpu_torch.engine.online import OnlineVO
    from vo_tpu_torch.engine.pipeline import run_offline_vo, run_offline_vo_streaming
    from vo_tpu_torch.engine.vo import VOEngine
    from vo_tpu_torch.io.dataset import write_gray_u16mm_dir
    from vo_tpu_torch.io.native import NativeRGBDSequence, build_loader
    from vo_tpu_torch.io.poses import write_kitti_txt
    from vo_tpu_torch.runners import vo_run

    build_dir = os.path.join(os.path.dirname(os.path.abspath(vo_tpu_torch.__file__)),
                             "_build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_seq_", dir=build_dir)
    sub_s = {}
    try:
        t0 = time.perf_counter()
        seq_dir = os.path.join(tmp, "seq")
        write_gray_u16mm_dir(seq_dir, imgs, deps)
        write_kitti_txt(os.path.join(tmp, "gt.txt"), gt)
        t1 = time.perf_counter()
        lib = build_loader()
        sub_s["write_and_build"] = time.perf_counter() - t0
        print(f"streaming: wrote {F} frames (gray PNG + <u2 mm npy) in {t1 - t0:.1f} s; "
              f"native loader {lib} ready in {time.perf_counter() - t1:.1f} s")
        t_checks = time.perf_counter()
        # The frames as the loaders decode them: uint8 gray, millimetres as metres.
        gray = np.clip(imgs, 0, 255).astype(np.uint8)
        metres = np.round(np.clip(deps, 0.0, 65.535) * 1000.0).astype(np.uint16)
        metres = metres.astype(np.float32) * 1e-3
        kflat = ", ".join(repr(float(v)) for v in K.reshape(-1))

        def yaml(name: str, extractor_lines: str) -> tuple[str, str]:
            out = os.path.join(tmp, name)
            path = out + ".yaml"
            with open(path, "w") as f:
                f.write(f"{extractor_lines}\nimage_path: {seq_dir}\n"
                        f"camera_intrinsic_matrix: [{kflat}]\noutput_filename: {out}\n"
                        f"gt_txt_file_path: {os.path.join(tmp, 'gt.txt')}\n"
                        f"max_keypoints: 2048\nextraction_batch: {EXTRACT_BATCH}\n"
                        f"pnp_n_hypotheses: 512\n")
            return path, out + ".npy"

        orb_yaml, orb_npy = yaml("cli", "feature_extractor: orb")
        sparse_flags = ["--depth-transfer", "sparse", "--eval"]
        cfg = vo_run.RunConfig.from_yaml(orb_yaml)

        # The CLI, counted.
        _reset_counts()
        res = vo_run.run(["--config", orb_yaml] + sparse_flags)
        counts = _counts()
        if res.rc != 0 or res.loader != "native":
            raise AssertionError(f"CLI run: rc {res.rc}, loader {res.loader!r}")
        if counts != {"wgmma": F - 1, "simt": 0}:
            raise AssertionError(f"CLI run launches {counts}, expected {F - 1} wgmma, 0 simt")
        written = np.load(orb_npy)
        if written.shape != (F, 4, 4) or not np.array_equal(written, res.poses):
            raise AssertionError(f"CLI output {orb_npy}: shape {written.shape}")
        if not _gate("CLI, native loader, sparse depth", res.poses, res.diag.accepted, gt,
                     counts["wgmma"]):
            raise AssertionError("CLI run failed the trajectory gate")

        # The in-memory pipeline on the decoded frames gives the CLI's poses.
        ref_poses, ref_diag = run_offline_vo(
            gray, metres, K, vo_config=cfg.vo, extractor=vo_run.build_extractor(cfg),
            extraction_batch=EXTRACT_BATCH, device="cuda")
        diff = float(np.abs(res.poses - ref_poses).max())
        same_diag = all(np.array_equal(a, b) for a, b in zip(res.diag, ref_diag))
        print(f"CLI vs run_offline_vo on the decoded frames: largest pose difference "
              f"{diff:.3e}, identical = {diff == 0.0}, diagnostics equal = {same_diag}")
        if diff > 1e-5:
            raise AssertionError("the CLI's poses differ from run_offline_vo's")

        # An interrupted run (a finished run rewrites its checkpoint at its last frame),
        # then a resume over the whole sequence.
        ck = os.path.join(tmp, "ck.npz")
        part_yaml, _ = yaml("part", "feature_extractor: orb")
        part = vo_run.run(["--config", part_yaml, "--limit", "96", "--checkpoint", ck,
                           "--checkpoint-every", "64"] + sparse_flags)
        with np.load(ck) as blob:
            next_frame = int(blob["next_frame"])
        if part.rc != 0 or next_frame != 96:
            raise AssertionError(f"interrupted run: rc {part.rc}, checkpoint at {next_frame}")
        _reset_counts()
        resumed = vo_run.run(["--config", part_yaml, "--resume", ck] + sparse_flags)
        counts_r = _counts()
        diff_r = float(np.abs(resumed.poses - res.poses).max())
        print(f"resume from frame {next_frame}: launches {counts_r}, largest pose difference "
              f"to the uninterrupted run {diff_r:.3e}, identical = {diff_r == 0.0}")
        if counts_r != {"wgmma": F - 96, "simt": 0} or diff_r > 1e-5:
            raise AssertionError("the resumed run does not reproduce the uninterrupted one")

        # The SIFT config through the CLI.
        sift_yaml, _ = yaml("sift", "feature_extractor: sift\noctaves: 4\noriented: true")
        _reset_counts()
        sres = vo_run.run(["--config", sift_yaml, "--depth-transfer", "float32",
                           "--limit", "48"])
        counts_s = _counts()
        print(f"CLI, SIFT config, 48 frames: launches {counts_s}, accept "
              f"{float(np.mean(sres.diag.accepted)):.3f}")
        if (counts_s != {"wgmma": 0, "simt": 47} or sres.poses.shape != (48, 4, 4)
                or not np.isfinite(sres.poses).all()):
            raise AssertionError("the SIFT config through the CLI failed")

        # The per-frame API on the first 16 decoded frames.
        n_on = 16
        _reset_counts()
        online = OnlineVO(K, config=cfg.vo, extractor=vo_run.build_extractor(cfg))
        on_poses = np.stack([online.process_frame(gray[i], metres[i], i)
                             for i in range(n_on)])
        counts_o = _counts()
        diff_o = float(np.abs(on_poses - ref_poses[:n_on]).max())
        print(f"OnlineVO, {n_on} frames: launches {counts_o}, largest pose difference to "
              f"run_offline_vo {diff_o:.3e}")
        if counts_o != {"wgmma": n_on - 1, "simt": 0} or diff_o > 1e-4:
            raise AssertionError("OnlineVO disagrees with run_offline_vo")

        sub_s["checks"] = time.perf_counter() - t_checks

        # Timing over the first F_TIMED frames. The engine's wall time drifts with the
        # host, so each streaming pass is followed by a pass of the in-memory extract
        # + engine on the decoded frames, already on the card, and the two are
        # compared. Every mode reads gray images; the loader emits millimetres where
        # the mode sends them.
        t0 = time.perf_counter()
        n_t = F_TIMED

        def stream(mode: str, limit: int):
            nat = NativeRGBDSequence.try_open(seq_dir)
            depth = "f32" if mode == "float32" else "u16mm"
            stats: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                run_offline_vo_streaming(
                    nat.iter_batches(EXTRACT_BATCH, limit=limit, gray=True, depth=depth),
                    limit, K, vo_config=cfg.vo, extractor=vo_run.build_extractor(cfg),
                    transfer_depth=mode, device="cuda", stats=stats)
            finally:
                nat.close()
            return time.perf_counter() - t0, stats

        Kd = torch.from_numpy(K).cuda()
        gray_d = torch.from_numpy(gray[:n_t]).cuda()
        metres_d = torch.from_numpy(metres[:n_t]).cuda()
        pairs: dict = {}   # mode -> [(streaming stats, in-memory extract ms, engine ms)]
        for i, mode in enumerate(["sparse"] * N_PASSES + ["float32", "uint16mm"]):
            dt, st = stream(mode, n_t)
            st["ms"] = _ms_per_frame(dt, n_t)
            _, _, (ex_ms,), (en_ms,), _ = _timed_passes(
                vo_run.build_extractor(cfg), VOEngine(cfg.vo, device="cuda"), gray_d,
                metres_d, Kd, n_passes=1)
            pairs.setdefault(mode, []).append((st, ex_ms, en_ms))
            print(f"timing [{card}] pair {i + 1}, {mode}: streaming {st['ms']:.3f} "
                  f"ms/frame (engine {_ms_per_frame(st['engine_s'], n_t):.3f}, queue wait "
                  f"{st['queue_wait_s']:.3f} s, sync wait {st['sync_wait_s']:.3f} s) | "
                  f"in-memory {ex_ms + en_ms:.3f} ms/frame (extract {ex_ms:.3f}, engine "
                  f"{en_ms:.3f}) -> {(st['ms'] / (ex_ms + en_ms) - 1.0) * 100:+.1f} %")

        # Decode-only ceiling of the native loader, in each format used above.
        ceiling = {}
        for depth in ("u16mm", "f32"):
            nat = NativeRGBDSequence.try_open(seq_dir)
            t1 = time.perf_counter()
            for _ in nat.iter_batches(EXTRACT_BATCH, gray=True, depth=depth):
                pass
            ceiling[depth] = F / (time.perf_counter() - t1)
            nat.close()

        for mode, runs in pairs.items():
            ms = float(np.median([st["ms"] for st, _, _ in runs]))
            mem_ms = float(np.median([ex + en for _, ex, en in runs]))
            eng = float(np.median([_ms_per_frame(st["engine_s"], n_t) for st, _, _ in runs]))
            mem_eng = float(np.median([en for _, _, en in runs]))
            st = runs[-1][0]
            print(f"timing [{card}] streaming {mode}, first {n_t} frames ({len(runs)} "
                  f"pass(es), medians): {ms:.3f} ms/frame = {1e3 / ms:.2f} fps against "
                  f"in-memory {mem_ms:.3f} ms/frame ({(ms / mem_ms - 1.0) * 100:+.1f} %); "
                  f"engine {eng:.3f} against {mem_eng:.3f} ms/frame; up "
                  f"{st['h2d_bytes'] / n_t:.0f} B/frame, down {st['d2h_bytes'] / n_t:.0f} "
                  f"B/frame; queue wait "
                  f"{[round(s['queue_wait_s'], 3) for s, _, _ in runs]} s per pass")
        print(f"timing [{card}] native loader decode only, {F} frames: gray + u16mm "
              f"{ceiling['u16mm']:.1f} fps, gray + f32 {ceiling['f32']:.1f} fps")
        sub_s["timing"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        sparse_ms = float(np.median([st["ms"] for st, _, _ in pairs["sparse"]]))
        _profile_lines(card, "streaming sparse, 2 chunks",
                       lambda: stream("sparse", 2 * EXTRACT_BATCH),
                       2 * EXTRACT_BATCH, sparse_ms)
        sub_s["profile"] = time.perf_counter() - t0
        print("phase 8 seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in sub_s.items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    import torch

    t_all = time.perf_counter()
    phase_s = {}

    # Phase 1: device.
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    card = _card()
    print(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s))")
    dev = torch.device("cuda")
    phase_s["device"] = time.perf_counter() - t0

    from vo_tpu_torch.engine.pipeline import extract_and_backproject, run_offline_vo
    from vo_tpu_torch.engine.vo import VOConfig, VOEngine
    from vo_tpu_torch.estimation.pnp import PnPConfig
    from vo_tpu_torch.features.extractor import OrbLikeExtractor
    from vo_tpu_torch.features.pyramid import MultiScaleClassicExtractor
    from vo_tpu_torch.ops import match
    from vo_tpu_torch.ops.match_timing import eager_ms, graph_ms
    from vo_tpu_torch.utils.synthetic import (depth_valid_fraction, render_rgbd,
                                              slalom_trajectory)

    # The renderer is per-frame independent numpy: render the workload in a pool of
    # processes while the kernels build and are checked.
    traj = slalom_trajectory(F, step=STEP)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes=min(8, os.cpu_count() or 1)) as pool:
        t_render = time.perf_counter()
        rendered = pool.starmap_async(render_rgbd, [(T, K, H, W) for T in traj])

        # Phase 2: build.
        t0 = time.perf_counter()
        lib, build_s, ptxas = match.build_match_kernel()
        print(f"build: {lib} in {build_s:.2f} s")
        ptxas_lines = _ptxas_lines(ptxas)
        for line in ptxas_lines:
            print(f"  ptxas: {line}")
        for kernel in KERNELS:
            if build_s > 0 and not any(x.startswith(kernel) for x in ptxas_lines):
                raise AssertionError(f"ptxas printed nothing for {kernel}")
        phase_s["build"] = time.perf_counter() - t0

        # Phase 3: kernels vs plain on the card (workload descriptors come after the
        # render finishes).
        t0 = time.perf_counter()
        errs = _synthetic_checks(dev)
        phase_s["kernel_checks_synthetic"] = time.perf_counter() - t0

        frames = rendered.get(timeout=900)
        phase_s["render_wall"] = time.perf_counter() - t_render
    imgs = np.stack([f[0] for f in frames])
    deps = np.stack([f[1] for f in frames])
    dvf = depth_valid_fraction(deps)
    if float(dvf.min()) <= 0.5:
        raise AssertionError(f"degenerate workload: depth-valid fraction {dvf.min():.3f}")
    print(f"render: {F} frames {H}x{W} in {phase_s['render_wall']:.1f} s wall")
    gt = np.asarray(traj, np.float64)

    extractor = OrbLikeExtractor(max_kp=2048)
    cfg = VOConfig(matcher="ratio_binary", pnp=PnPConfig(n_hypotheses=512))
    Kd = torch.from_numpy(K).to(dev)
    imgs_d = torch.from_numpy(imgs).to(dev)
    deps_d = torch.from_numpy(deps).to(dev)

    t0 = time.perf_counter()
    feats01, _ = extract_and_backproject(extractor, imgs_d[:2], deps_d[:2], Kd)
    desc_a, desc_b = feats01.desc[0].contiguous(), feats01.desc[1].contiguous()
    valid_a, valid_b = feats01.valid[0].contiguous(), feats01.valid[1].contiguous()
    desc_a32, desc_b32 = desc_a.float(), desc_b.float()
    errs["wgmma"].append(_check_kernel("workload frames 0, 1", desc_a, desc_b, valid_a,
                                       valid_b, True))
    errs["simt"].append(_check_kernel("workload frames 0, 1 as fp32", desc_a32, desc_b32,
                                      valid_a, valid_b, False, True))
    phase_s["kernel_checks_workload"] = time.perf_counter() - t0

    # Phase 4: main path, counted.
    t0 = time.perf_counter()
    _reset_counts()
    poses, diag, (feats, kp3d) = run_offline_vo(
        imgs, deps, K, vo_config=cfg, extractor=extractor,
        extraction_batch=EXTRACT_BATCH, return_features=True, device="cuda")
    counts = _counts()
    launches = counts["wgmma"]
    phase_s["main_path"] = time.perf_counter() - t0
    if counts != {"wgmma": F - 1, "simt": 0}:
        raise AssertionError(f"main path launches {counts}, expected {F - 1} wgmma, 0 simt")
    if not np.isfinite(poses).all() or poses.shape != (F, 4, 4):
        raise AssertionError(f"bad poses: shape {poses.shape}, finite {np.isfinite(poses).all()}")
    print(f"main path keyframes {int(diag.promoted_keyframe.sum())}")
    if not _gate("main path", poses, diag.accepted, gt, launches):
        raise AssertionError("trajectory gate failed")

    t0 = time.perf_counter()
    plain_engine = VOEngine(VOConfig(matcher="ratio_binary", pnp=PnPConfig(n_hypotheses=512),
                                     use_match_kernel=False), device=dev)
    before = _counts()
    poses_plain, _ = plain_engine.run_sequence(feats.kp, feats.desc, feats.valid, kp3d, Kd)
    if _counts() != before:
        raise AssertionError("the plain-matcher engine launched a match kernel")
    same = bool(torch.equal(poses_plain.cpu(), torch.from_numpy(poses)))
    print(f"kernel vs plain matcher engine runs: poses identical = {same}")
    if not same:
        raise AssertionError("kernel and plain-matcher engine runs give different poses")
    phase_s["plain_engine_run"] = time.perf_counter() - t0

    # Phase 5: the float-mode path (the matchers of float descriptors), counted: the
    # binary descriptors as fp32 unit vectors, whose products and sums are exact.
    t0 = time.perf_counter()
    fcfg = dict(matcher="ratio_mutual_nn", pnp=PnPConfig(n_hypotheses=512))
    fargs = (feats.kp[:F_FLOAT], feats.desc[:F_FLOAT].float() / 16.0,
             feats.valid[:F_FLOAT], kp3d[:F_FLOAT], Kd)
    _reset_counts()
    poses_f, diag_f = VOEngine(VOConfig(**fcfg), device=dev).run_sequence(*fargs)
    torch.cuda.synchronize()
    counts_f = _counts()
    if counts_f != {"wgmma": 0, "simt": F_FLOAT - 1}:
        raise AssertionError(f"float path launches {counts_f}, expected {F_FLOAT - 1} simt")
    poses_fp, _ = VOEngine(VOConfig(**fcfg, use_match_kernel=False),
                           device=dev).run_sequence(*fargs)
    same_f = bool(torch.equal(poses_f.cpu(), poses_fp.cpu()))
    accept_f = float(diag_f.accepted.float().mean())
    print(f"float-mode path ({F_FLOAT} frames, ratio_mutual_nn): simt launches "
          f"{counts_f['simt']}, accept {accept_f:.3f}, poses identical to the plain "
          f"matcher = {same_f}")
    if not same_f or not torch.isfinite(poses_f).all():
        raise AssertionError("float-mode path failed")
    phase_s["float_path"] = time.perf_counter() - t0

    # Phase 6: the SIFT-config path of bench.py, counted, then the plain matcher on
    # its features. fp32 sums in another order may flip near-tied matches, so the two
    # runs are each held to the gate, not to identical poses.
    t0 = time.perf_counter()
    sift = MultiScaleClassicExtractor(max_kp=2048, n_scales=4, response="dog",
                                      descriptor="gradhist", oriented=True)
    sift_cfg = dict(matcher="ratio_float", ratio=0.85, pnp=PnPConfig(n_hypotheses=512))
    _reset_counts()
    poses_s, diag_s, (feats_s, kp3d_s) = run_offline_vo(
        imgs, deps, K, vo_config=VOConfig(**sift_cfg), extractor=sift,
        extraction_batch=EXTRACT_BATCH, return_features=True, device="cuda")
    counts_s = _counts()
    if counts_s != {"wgmma": 0, "simt": F - 1}:
        raise AssertionError(f"SIFT path launches {counts_s}, expected {F - 1} simt, 0 wgmma")
    if feats_s.desc.shape[1:] != (2048, 128) or feats_s.desc.dtype != torch.bfloat16:
        raise AssertionError(f"SIFT descriptors {tuple(feats_s.desc.shape)} {feats_s.desc.dtype}")
    print(f"SIFT path: {int(feats_s.valid.sum(1).float().mean())} valid keypoints/frame, "
          f"keyframes {int(diag_s.promoted_keyframe.sum())}, mean matches "
          f"{float(np.mean(diag_s.n_matches)):.1f}")
    sift_ok = _gate("SIFT path", poses_s, diag_s.accepted, gt, counts_s["simt"])
    poses_sp, diag_sp = VOEngine(VOConfig(**sift_cfg, use_match_kernel=False),
                                 device=dev).run_sequence(feats_s.kp, feats_s.desc,
                                                          feats_s.valid, kp3d_s, Kd)
    poses_sp = poses_sp.cpu().numpy()
    plain_ok = _gate("SIFT path, plain matcher", poses_sp, diag_sp.accepted.cpu().numpy(), gt)
    dpos = np.abs(poses_sp - poses_s)
    print(f"SIFT path kernel vs plain matcher: largest per-frame difference "
          f"{float(dpos[:, :3, 3].max()):.3e} m in translation, "
          f"{float(dpos[:, :3, :3].max()):.3e} in a rotation entry; poses identical = "
          f"{bool((dpos == 0).all())}")
    if not (sift_ok and plain_ok):
        raise AssertionError("SIFT-config path failed the trajectory gate")
    sd_a, sd_b = (feats_s.desc[i].float().contiguous() for i in (0, 1))
    sv_a, sv_b = feats_s.valid[0].contiguous(), feats_s.valid[1].contiguous()
    errs["simt"].append(_check_kernel("SIFT path frames 0, 1", sd_a, sd_b, sv_a, sv_b,
                                      False))
    phase_s["sift_path"] = time.perf_counter() - t0

    # Timing: median of N_PASSES timed passes after the warm-up above, per path.
    t0 = time.perf_counter()
    engine = VOEngine(cfg, device=dev)
    extract_ms, engine_ms, t_ex, t_en, (kp, desc, valid, k3) = _timed_passes(
        extractor, engine, imgs_d, deps_d, Kd)
    sift_engine = VOEngine(VOConfig(**sift_cfg), device=dev)
    s_extract_ms, s_engine_ms, s_ex, s_en, _ = _timed_passes(
        sift, sift_engine, imgs_d, deps_d, Kd)
    phase_s["timing_paths"] = time.perf_counter() - t0

    # Each kernel at the shapes its paths give it: the wgmma kernel on the main
    # path's bf16 descriptors of frames 0 and 1, the SIMT kernel on the SIFT path's
    # (D = 128) and on the main path's as fp32 (D = 256). The library yardstick (a
    # masked matmul + topk(2) + argmax, never called by the port) runs in the same
    # operand type; fp32 matmuls keep TF32 off (vo_tpu_torch.device).
    t0 = time.perf_counter()
    n_rep = 50
    timed = [("wgmma", "match_wgmma.cu", desc_a, desc_b, valid_a, valid_b, True,
              PEAK_BF16_FLOPS, "989 TFLOP/s bf16", launches),
             ("simt", "match_kernel.cu", sd_a, sd_b, sv_a, sv_b, False,
              PEAK_FP32_FLOPS, "67 TFLOP/s fp32", counts_s["simt"]),
             ("simt", "match_kernel.cu", desc_a32, desc_b32, valid_a, valid_b, False,
              PEAK_FP32_FLOPS, "67 TFLOP/s fp32", counts_f["simt"])]
    entries = []
    for kernel, source, a, b, va, vb, bf16, peak, peak_name, launched in timed:
        mask = va[:, None] & vb[None, :]

        def library(a=a, b=b, mask=mask):
            sim = torch.where(mask, torch.matmul(a, b.T).float(), -1e30)
            return torch.topk(sim, 2, dim=1), torch.argmax(sim, dim=0)

        # Two clocks: CUDA-graph replays give each function's device time;
        # back-to-back eager calls add whatever host time per call the device does
        # not hide.
        fns = {"ms": lambda: match.top2_mutual(a, b, va, vb, bf16=bf16),
               "plain_ms": lambda: match.top2_mutual_plain(a, b, va, vb, bf16=bf16),
               "library_ms": library}
        tm = {k: graph_ms(fn, n_rep) for k, fn in fns.items()}
        eager = {k: eager_ms(fn, n_rep) for k, fn in fns.items()}
        # Bound: each operand read once (2 or 4 bytes an element), masks read, outputs
        # (nn12, top2, nn21) written once; products at the peak of the operand type.
        (na, d), nb = a.shape, b.shape[0]
        elem = 2 if bf16 else 4
        flops = 2.0 * na * nb * d
        nbytes = (na + nb) * d * elem + (na + nb) + na * (4 + 8) + nb * 4
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        shape = f"{na}x{nb}x{d} {'bf16' if bf16 else 'fp32'}"
        print(f"{kernel} kernel [{card}] {shape}: kernel {tm['ms']:.4f} ms, plain "
              f"{tm['plain_ms']:.4f} ms, library (matmul + topk + argmax) "
              f"{tm['library_ms']:.4f} ms, bound {bound_ms * 1e3:.2f} us "
              f"({flops / 1e9:.3f} GFLOP at {peak_name}; {nbytes / 2**20:.2f} MiB at "
              f"3.35 TB/s), achieved {flops / tm['ms'] / 1e9:.1f} TFLOP/s, "
              f"{bound_ms / tm['ms'] * 100:.2f} % of the bound (CUDA-graph replays); "
              f"eager back-to-back: kernel {eager['ms']:.4f} ms, plain "
              f"{eager['plain_ms']:.4f} ms, library {eager['library_ms']:.4f} ms")
        entries.append({
            "name": f"top2_mutual_{kernel} {shape}",
            "route": "cuda",
            "source": f"vo_tpu_torch/ops/csrc/{source}",
            "replaces": "vo_tpu/ops/pallas_match.py:36",
            "launches": launched,
            "max_abs_err": max(errs[kernel]),
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": tm["library_ms"],
        })

    # One CUDA kernel per SIMT call: no fill and no finalize kernel.
    _, n_kernels, top = _device_profile(lambda: match.top2_mutual(sd_a, sd_b, sv_a, sv_b))
    if n_kernels is None:
        print("simt call under the profiler: device time not measured (empty trace)")
    else:
        print(f"simt call under the profiler: {n_kernels} CUDA kernel(s): "
              f"{[name for name, _, _ in top]}")
        if n_kernels != 1:
            raise AssertionError(f"a SIMT call launched {n_kernels} CUDA kernels")
    phase_s["timing_kernels"] = time.perf_counter() - t0

    # Where the time goes: device-busy time and kernel launches per frame under
    # torch.profiler, against the unprofiled wall time per frame measured above.
    t0 = time.perf_counter()
    n_steps = 8
    batch = (imgs_d[:EXTRACT_BATCH], deps_d[:EXTRACT_BATCH], Kd)
    _profile_lines(card, "extract", lambda: extract_and_backproject(extractor, *batch),
                   EXTRACT_BATCH, extract_ms)
    _profile_lines(card, "engine", lambda: engine.run_sequence(
        kp[:n_steps + 1], desc[:n_steps + 1], valid[:n_steps + 1], k3[:n_steps + 1], Kd),
        n_steps, engine_ms)
    _profile_lines(card, "SIFT extract", lambda: extract_and_backproject(sift, *batch),
                   EXTRACT_BATCH, s_extract_ms)
    phase_s["profile"] = time.perf_counter() - t0

    # Phase 8: streaming, the CLI and the per-frame API.
    t0 = time.perf_counter()
    _streaming_phase(card, imgs, deps, gt)
    phase_s["streaming_cli_online"] = time.perf_counter() - t0

    for path, (ex_ms, en_ms, ex, en) in (("main path", (extract_ms, engine_ms, t_ex, t_en)),
                                         ("SIFT path", (s_extract_ms, s_engine_ms, s_ex, s_en))):
        print(f"timing [{card}] {path}: extract {ex_ms:.3f} ms/frame (passes "
              f"{[round(x, 3) for x in ex]}), engine {en_ms:.3f} ms/frame (passes "
              f"{[round(x, 3) for x in en]})")
    phase_s["total"] = time.perf_counter() - t_all
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    print(f"card: {_card()}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
