"""Driver of the ``d2net_extract`` traffic: D2-Net features for mapping, as
``extract_features.py --multiscale`` produces them, from frames already in host memory.

The frames, their batches and the batches checked are ``r2d2_extract``'s (imported);
the weights are D2-Net's, drawn on the card from the seed (``ref_d2net.draw_weights``).
Set-up finds the program's D2-Net first, and raises at once when the program has none
(``vo_tpu_torch.models.d2net``). The window is a closed loop over batches of ``batch``
frames, cycling through the frames: each call of ``extract_d2net`` takes a host batch,
and its keypoints, descriptors, scores, masks and cells are copied back to the host
before the next call, into pinned buffers made in set-up and reused (a batch the judge
keeps is cloned out of them). Pageable copies of the 84 MB a batch would cost ~10 % of
the window and vary with the host's page faults by more than the cell's bound allows.
Every call adds its counters to one dict on the card, read once the window has closed. In a ``--trace 1`` run the program's span recorder runs between
the ends of the profiled sub-window, and the sums over its ``d2net.conv`` spans and its
``d2net.fuse``, ``d2net.detect`` and ``d2net.describe`` spans go into ``Run.stats``.

Correctness (``judge``), once the window has closed: the batches drawn from the seed
(and the window's first and last) through the plain reference (``ref_d2net``, frame by
frame) with the same weights. Keypoints are matched by (level, channel, row, column) of
their cell: the share of kept keypoints that only one of the two keeps, and over those
both keep, the largest gap of their image positions (pixels), of their descriptors, and
of their scores relative to the reference's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vobench import conv_roofline, ref_d2net, render
from vobench.harness import Run, checks_from
from vobench.r2d2_extract import batches, frames_of, sample_batches
from vobench.r2d2_extract_spans import SpanWindow
from vobench.ref_engine import matmul_precision

CONV_SPAN = "d2net.conv"
DETECT_SPANS = ("d2net.fuse", "d2net.detect", "d2net.describe")
_FIELDS = ("kp", "desc", "score", "valid", "cell")


def layer_dicts(steps) -> list[dict]:
    """The program's layer list in the configuration's form."""
    out = []
    for s in steps:
        if hasattr(s, "cin"):
            out.append({"op": "conv", "in": s.cin, "out": s.cout, "k": s.k,
                        "dilation": s.dilation, "padding": s.pad, "relu": s.relu})
        else:
            out.append({"op": f"{s.kind}_pool", "k": s.k, "stride": s.stride})
    return out


def program(config: dict):
    """The port's ``D2NetConfig`` as the configuration states it; raises when the
    program has no D2-Net or its layers are not the configuration's."""
    from vo_tpu_torch.models.d2net import D2NET_VGG16_CONV4_3, D2NetConfig

    net, ms = config["d2net"], config["multiscale"]
    if layer_dicts(D2NET_VGG16_CONV4_3) != net["layers"]:
        raise RuntimeError("the port's D2-Net is not the configuration's network")
    level_k = ms["level_k"]
    return D2NetConfig(scales=tuple(ms["scales"]), edge_threshold=ms["edge_threshold"],
                       max_edge=ms["max_edge"], max_sum_edges=ms["max_sum_edges"],
                       use_relu=net["use_relu"],
                       level_k=None if level_k is None else tuple(level_k))


def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """{"rgb" (F, H, W, 3) uint8 on the host, "params" on ``device``}."""
    gray = render.render_drive(traffic, config, seed, device)["gray"]
    return {"rgb": np.ascontiguousarray(np.repeat(gray[..., None], 3, axis=-1)),
            "params": ref_d2net.draw_weights(config["d2net"], seed, device)}


def call(inputs: dict, traffic: dict, cfg, device, ordinal: int,
         stats: dict | None = None, host: dict | None = None) -> dict:
    """One batch through the program, its features copied to the host: into the buffers
    of ``host`` (made pinned at its first call, then reused) when given, else to new
    tensors."""
    from vo_tpu_torch.models.d2net import extract_d2net

    feats = extract_d2net(inputs["params"], frames_of(inputs, traffic, ordinal), cfg,
                          device=device, stats=stats)
    if host is None:
        return {k: getattr(feats, k).cpu() for k in _FIELDS}
    for k in _FIELDS:
        t = getattr(feats, k)
        if k not in host:
            host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        host[k].copy_(t)
    return host


def control_outputs(inputs: dict, config: dict, traffic: dict, ordinal: int, device) -> list:
    """The reference in the program's place one precision down: fp32 convolutions with
    TF32 on (the configuration keeps TF32 off)."""
    rgb = torch.from_numpy(frames_of(inputs, traffic, ordinal)).to(device)
    with matmul_precision(True):
        return ref_d2net.extract(inputs["params"], config, rgb)


def _as_frames(got) -> list:
    """Per frame {"kp", "desc", "score", "cell"} of the kept keypoints: the program's
    host features, or the reference's (already so)."""
    if isinstance(got, list):
        return got
    out = []
    for i in range(got["valid"].shape[0]):
        v = got["valid"][i]
        out.append({k: got[k][i][v] for k in ("kp", "desc", "score", "cell")})
    return out


def judge(inputs: dict, outputs: dict, config: dict, traffic: dict, device) -> dict:
    """``outputs``: {ordinal: the host features of that batch}."""
    sym = total = 0
    kp_gap = desc_gap = score_gap = 0.0
    with matmul_precision(False):
        for ordinal, got in sorted(outputs.items()):
            rgb = torch.from_numpy(frames_of(inputs, traffic, ordinal)).to(device)
            want = ref_d2net.extract(inputs["params"], config, rgb)
            for mine, theirs in zip(_as_frames(got), want):
                a = {tuple(int(v) for v in c): r for r, c in enumerate(mine["cell"].tolist())}
                b = {tuple(int(v) for v in c): r for r, c in enumerate(theirs["cell"].tolist())}
                common = sorted(a.keys() & b.keys())
                sym += len(a) + len(b) - 2 * len(common)
                total += len(a) + len(b)
                if not common:
                    continue
                ia = torch.tensor([a[k] for k in common])
                ib = torch.tensor([b[k] for k in common])
                kp_gap = max(kp_gap, float((mine["kp"][ia] - theirs["kp"][ib]).abs().max()))
                desc_gap = max(desc_gap, float((mine["desc"][ia]
                                                - theirs["desc"][ib]).abs().max()))
                ref = theirs["score"][ib]
                score_gap = max(score_gap, float(((mine["score"][ia] - ref).abs()
                                                  / ref.abs()).max()))
    return {"keypoints_off": sym / max(total, 1), "kp_gap_px": kp_gap,
            "desc_gap": desc_gap, "score_gap": score_gap}


class D2SpanWindow(SpanWindow):
    """The profiled sub-window with the program's span recorder on between its ends;
    its sums are D2-Net's spans'."""

    def span_stats(self) -> dict:
        if self.spans is None:
            super().span_stats()            # stops a recorder left on
            return {}
        return span_sums(self.spans, self.frames)


def span_sums(spans, frames: int) -> dict:
    """Over the finished spans with a device time: the ``d2net.conv`` spans' device ms
    and least ms (``conv_roofline.bound_s``), the device ms of D2-Net's own stages
    (fuse, detect, describe), with the ``frames`` they covered; {} without them."""
    conv = [s for s in spans if s.name == CONV_SPAN and s.device_ms is not None]
    own = [s for s in spans if s.name in DETECT_SPANS and s.device_ms is not None]
    if not conv and not own:
        return {}
    return {"d2net_conv_spans": len(conv),
            "d2net_conv_device_ms": sum(s.device_ms for s in conv),
            "d2net_conv_bound_ms": 1e3 * sum(conv_roofline.bound_s(s.attrs) for s in conv),
            "d2net_detect_device_ms": sum(s.device_ms for s in own),
            "d2net_span_frames": frames}


def run(ctx) -> Run:
    """Set-up, the window, then the judge; see the module's docstring."""
    from vo_tpu_torch.models.d2net import read_counts

    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    cfg = program(config)
    inputs = make_inputs(config, traffic, ctx.seed, dev)
    t1 = time.perf_counter()
    host = {}
    call(inputs, traffic, cfg, dev, 0, host=host)
    warm_s = time.perf_counter() - t1
    sub = None
    if ctx.trace and cuda:
        first, count = traffic["trace_batches"]
        sub = D2SpanWindow(first, count, traffic["batch"], dev)
    keep = sample_batches(ctx.seed, traffic)
    events, outputs, counters = [], {}, {}
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
        got = call(inputs, traffic, cfg, dev, ordinal, counters, host)
        if ctx.trace and cuda:
            end.record()
            events.append((start, end))
        if ordinal in keep:
            outputs[ordinal] = {k: v.clone() for k, v in got.items()}
        ordinal += 1
        if time.perf_counter() - t_window >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_window
    outputs[ordinal - 1] = got
    memory = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = sub.summary() if sub is not None else None
    stats = sub.span_stats() if sub is not None else {}
    if events:
        torch.cuda.synchronize(dev)
    extract_ms = float(sum(s.elapsed_time(e) for s, e in events)) if events else None
    counts = read_counts(counters)
    t_judge = time.perf_counter()
    numbers = judge(inputs, outputs, config, traffic, dev)
    judge_s = time.perf_counter() - t_judge
    frames = ordinal * traffic["batch"]
    return Run(frames=frames, window_s=window_s, setup_s=setup_s, memory_peak_bytes=memory,
               checks=checks_from(numbers, config["correctness"]["limits"]),
               attempted=frames, stats=stats, extract_ms=extract_ms,
               extract_frames=len(events) * traffic["batch"], trace=summary, config=config,
               traffic=traffic, info={"batches": ordinal, "inputs_s": t1 - t0,
                                      "warm_s": warm_s, "checked_batches": sorted(outputs),
                                      "judge_s": judge_s, "counters": counts, **stats})


def readings(config: dict, traffic: dict, seed: int, device, control: bool = False) -> dict:
    """The judge's numbers for every distinct batch of the seed's frames through the
    program, or through the control in its place (to set the limits from); the
    program's also carry its counters per level (``peak_k<level>``: the most candidates
    one frame offered a level's budget; ``budget_dropped``)."""
    inputs = make_inputs(config, traffic, seed, device)
    extra = {}
    if control:
        outputs = {o: control_outputs(inputs, config, traffic, o, device)
                   for o in range(batches(inputs, traffic))}
    else:
        from vo_tpu_torch.models.d2net import read_counts

        cfg, counters = program(config), {}
        outputs = {o: call(inputs, traffic, cfg, device, o, counters)
                   for o in range(batches(inputs, traffic))}
        counts = read_counts(counters)
        extra = {f"peak_k{n}": p for n, p in enumerate(counts["peak"])}
        extra["budget_dropped"] = sum(counts["budget"])
    return {**judge(inputs, outputs, config, traffic, device), **extra}
