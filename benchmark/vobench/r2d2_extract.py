"""Driver of the ``r2d2_extract`` traffic: multiscale R2D2 features for mapping, as
the ``extract`` CLI produces them, from frames already in host memory.

Set-up renders the seed's frames on the card (gray, given as three equal RGB
channels), draws the network's weights on the card from the seed, and warms the
program on one batch. The window is a closed loop over batches of ``batch`` frames,
cycling through the frames: each call of ``extract_multiscale`` takes a host batch,
and its keypoints, descriptors, scores and masks are copied back to the host before
the next call. The batch that crosses ``--seconds`` finishes and counts.

Correctness (``judge``), once the window has closed: the batches drawn from the seed
(and the window's first and last) through the plain reference at the same size, with
the same weights: the share of kept keypoints that differ, and over the keypoints
both keep, the largest descriptor and score gaps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vobench import ref_r2d2, render
from vobench.harness import Run, checks_from
from vobench.ref_engine import matmul_precision
from vobench.trace import SubWindow

_FIELDS = ("kp", "desc", "score", "valid")


def program(config: dict):
    """(the port's network spec, its MultiscaleConfig) as the configuration states
    them; raises when the port's layers are not the configuration's."""
    from vo_tpu_torch.models.multiscale import MultiscaleConfig
    from vo_tpu_torch.models.patchnet import FAST_QUAD_L2NET_CONFCFS

    net, ms = config["network"], config["multiscale"]
    spec = {"Fast_Quad_L2Net_ConfCFS": FAST_QUAD_L2NET_CONFCFS}[net["name"]]
    got = [dict(**{"in": c.in_ch, "out": c.out_ch, "k": c.k, "dilation": c.dilation,
                   "bn": c.bn, "relu": c.relu, "pool_after": c.pool_after})
           for c in spec.convs]
    if got != net["layers"] or spec.out_dim != net["out_dim"] or spec.upsample != net["upsample"]:
        raise RuntimeError(f"the port's {spec.name} is not the configuration's network")
    mcfg = MultiscaleConfig(
        scale_f=ms["scale_f"], min_scale=ms["min_scale"], max_scale=ms["max_scale"],
        min_size=ms["min_size"], max_size=ms["max_size"], top_k=ms["top_k"],
        per_scale_k=ms["per_scale_k"], rel_thr=ms["reliability_thr"],
        rep_thr=ms["repeatability_thr"], nms_size=ms["nms_size"], border=ms["border"])
    return spec, mcfg


def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """{"rgb" (F, H, W, 3) uint8 on the host, "params" on ``device``}."""
    gray = render.render_drive(traffic, config, seed, device)["gray"]
    return {"rgb": np.ascontiguousarray(np.repeat(gray[..., None], 3, axis=-1)),
            "params": ref_r2d2.draw_weights(config["network"], seed, device)}


def batches(inputs: dict, traffic: dict) -> int:
    return inputs["rgb"].shape[0] // traffic["batch"]


def frames_of(inputs: dict, traffic: dict, ordinal: int) -> np.ndarray:
    b = traffic["batch"]
    s = (ordinal % batches(inputs, traffic)) * b
    return inputs["rgb"][s:s + b]


def call(inputs: dict, traffic: dict, spec, mcfg, device, ordinal: int) -> dict:
    """One batch through the program, its features copied to the host."""
    from vo_tpu_torch.models.multiscale import extract_multiscale

    feats = extract_multiscale(inputs["params"], spec, frames_of(inputs, traffic, ordinal),
                               mcfg, device=device)
    return {k: getattr(feats, k).cpu() for k in _FIELDS}


def control_outputs(inputs: dict, config: dict, traffic: dict, ordinal: int, device) -> dict:
    """The reference in the program's place one precision down: fp32 convolutions and
    products with TF32 on (the configuration keeps TF32 off)."""
    rgb = torch.from_numpy(frames_of(inputs, traffic, ordinal)).to(device)
    with matmul_precision(True):
        out = ref_r2d2.extract(inputs["params"], config, rgb)
    return {k: v.cpu() for k, v in out.items()}


def sample_batches(seed: int, traffic: dict) -> set[int]:
    rng = np.random.default_rng([seed % 2 ** 63, 2])
    return {0} | {int(b) for b in rng.integers(0, traffic["sample_range"],
                                               traffic["check_batches"])}


def judge(inputs: dict, outputs: dict, config: dict, traffic: dict, device) -> dict:
    """``outputs``: {ordinal: host features of that batch}."""
    sym = total = 0
    desc_gap = score_gap = 0.0
    with matmul_precision(False):
        for ordinal, got in sorted(outputs.items()):
            rgb = torch.from_numpy(frames_of(inputs, traffic, ordinal)).to(device)
            want = {k: v.cpu() for k, v in ref_r2d2.extract(inputs["params"], config,
                                                             rgb).items()}
            for i in range(rgb.shape[0]):
                mine, theirs = (_rows(o, i) for o in (got, want))
                common = sorted(mine.keys() & theirs.keys())
                sym += len(mine) + len(theirs) - 2 * len(common)
                total += len(mine) + len(theirs)
                if not common:
                    continue
                a = torch.tensor([mine[k] for k in common])
                b = torch.tensor([theirs[k] for k in common])
                desc_gap = max(desc_gap, float((got["desc"][i][a].to(torch.float32)
                                                - want["desc"][i][b]).abs().max()))
                score_gap = max(score_gap, float((got["score"][i][a]
                                                  - want["score"][i][b]).abs().max()))
    return {"keypoints_off": sym / max(total, 1), "desc_gap": desc_gap,
            "score_gap": score_gap}


def _rows(feats: dict, i: int) -> dict:
    """{(x, y, 32/s) bytes: row} of frame ``i``'s kept keypoints."""
    kp = feats["kp"][i].to(torch.float32).numpy()
    rows = np.nonzero(feats["valid"][i].numpy())[0]
    return {kp[r].tobytes(): int(r) for r in rows}


def run(ctx) -> Run:
    """Set-up, the window, then the judge; see the module's docstring."""
    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    inputs = make_inputs(config, traffic, ctx.seed, dev)
    spec, mcfg = program(config)
    t1 = time.perf_counter()
    call(inputs, traffic, spec, mcfg, dev, 0)
    warm_s = time.perf_counter() - t1
    sub = None
    if ctx.trace and cuda:
        first, count = traffic["trace_batches"]
        sub = SubWindow(first, count, traffic["batch"], dev)
    keep = sample_batches(ctx.seed, traffic)
    events, outputs = [], {}
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_window = time.perf_counter()
    setup_s = t_window - ctx.t0
    ordinal = 0
    while True:
        if sub is not None:
            sub.at(ordinal)
        if ctx.trace and cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        got = call(inputs, traffic, spec, mcfg, dev, ordinal)
        if ctx.trace and cuda:
            end.record()
            events.append((start, end))
        if ordinal in keep:
            outputs[ordinal] = got
        ordinal += 1
        if time.perf_counter() - t_window >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_window
    outputs[ordinal - 1] = got
    memory = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = sub.summary() if sub is not None else None
    if events:
        torch.cuda.synchronize(dev)
    extract_ms = float(sum(s.elapsed_time(e) for s, e in events)) if events else None
    t_judge = time.perf_counter()
    numbers = judge(inputs, outputs, config, traffic, dev)
    judge_s = time.perf_counter() - t_judge
    frames = ordinal * traffic["batch"]
    return Run(frames=frames, window_s=window_s, setup_s=setup_s, memory_peak_bytes=memory,
               checks=checks_from(numbers, config["correctness"]["limits"]),
               attempted=frames, extract_ms=extract_ms,
               extract_frames=len(events) * traffic["batch"], trace=summary, config=config,
               traffic=traffic, info={"batches": ordinal, "inputs_s": t1 - t0,
                                      "warm_s": warm_s, "checked_batches": sorted(outputs),
                                      "judge_s": judge_s})


def readings(config: dict, traffic: dict, seed: int, device, control: bool = False) -> dict:
    """The judge's numbers for every distinct batch of the seed's frames through the
    program, or through the control in its place (to set the limits from)."""
    inputs = make_inputs(config, traffic, seed, device)
    if control:
        outputs = {o: control_outputs(inputs, config, traffic, o, device)
                   for o in range(batches(inputs, traffic))}
    else:
        spec, mcfg = program(config)
        outputs = {o: call(inputs, traffic, spec, mcfg, device, o)
                   for o in range(batches(inputs, traffic))}
    return judge(inputs, outputs, config, traffic, device)
