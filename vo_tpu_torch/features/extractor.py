"""Batched feature extraction: images in, fixed-budget (kp, desc, score, valid) out.

Port of ``vo_tpu/features/extractor.py``: Harris, Shi-Tomasi, DoG or box-filter
Hessian response, fixed-budget detection, then upright dense-packed BRIEF, oriented
BRIEF, upright gradhist or upright SURF-64 descriptors.

On a CUDA device an extraction is ~100 small kernels a frame, each issued by the host.
So ``OrbLikeExtractor`` replays its whole body as one CUDA graph per signature (the
extractor's fields, the device, and the images' shape and dtype), captured once per
process at the first call of that signature and kept at module level. Elsewhere it runs
the body eagerly. Both run the same kernels in the same order, so their features are
equal bit for bit. The graphs share one memory pool and their static buffers: a replay
copies the images into its buffer and its features out, and a replay on another stream
than the last one waits for that stream first. Calls from several threads at once are
not supported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from vo_tpu_torch.device import resolve_device
from vo_tpu_torch.features.brief import oriented_brief_descriptors
from vo_tpu_torch.features.dense_brief import BRIEF_BITS, upright_brief_descriptors
from vo_tpu_torch.features.detect import (detect_keypoints, dog_response, harris_response,
                                          shi_tomasi_response)
from vo_tpu_torch.features.gradhist import gradhist_descriptors
from vo_tpu_torch.features.surf import hessian_response, surf_descriptors
from vo_tpu_torch.ops import kernels
from vo_tpu_torch.ops.image import rgb_to_gray

_RESPONSES = {"harris": harris_response, "dog": dog_response, "hessian": hessian_response}


def response_fn(name: str):
    """The detector response for ``name``: as in the JAX package, any name other than
    'harris', 'dog' and 'hessian' takes the Shi-Tomasi response."""
    return _RESPONSES.get(name, shi_tomasi_response)


class Features(NamedTuple):
    """Fixed-budget per-frame features. Leading axis = batch of frames."""

    kp: torch.Tensor     # (..., K, 2) fp32 [x, y]
    desc: torch.Tensor   # (..., K, D)
    score: torch.Tensor  # (..., K)
    valid: torch.Tensor  # (..., K) bool


@dataclass(frozen=True)
class OrbLikeExtractor:
    """Single-scale corner or blob extractor; the same fields and defaults as the JAX
    one. As there, ``oriented`` steers BRIEF only: gradhist and SURF are upright here
    (the oriented gradhist runs in ``MultiScaleClassicExtractor``)."""

    max_kp: int = 2048
    nms_size: int = 5
    rel_threshold: float = 1e-4
    border: int = 21  # >= brief patch radius + 1
    subpixel: bool = False
    bits: int = BRIEF_BITS
    response: str = "harris"   # 'harris' | 'dog' | 'hessian'; any other: Shi-Tomasi
    oriented: bool = False     # BRIEF only: rotation-steered patch BRIEF
    descriptor: str = "brief"  # 'brief' (+-1) | 'gradhist' | 'surf' (float, bf16)

    def __call__(self, images, device: str | torch.device | None = None) -> Features:
        """images: (B, H, W, 3) RGB or (B, H, W) gray, numpy or tensor.

        Runs on ``device`` (default ``cuda``; raises if there is no GPU): there it
        replays the signature's CUDA graph, and returns features of its own.
        """
        dev = resolve_device(device)
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        images = images.to(dev)
        if images.device.type != "cuda":
            extract_counts["eager_calls"] += 1
            return self._extract(images)
        key = (self, images.device, tuple(images.shape), images.dtype)
        g = _graphs.get(key)
        if g is None:
            g, first = _ExtractGraph.capture(self, images)
            _graphs[key] = g
            return first
        return g.replay(images)

    def _extract(self, images: torch.Tensor) -> Features:
        """The extraction of ``images`` on their device."""
        gray = rgb_to_gray(images) if images.ndim == 4 else images.to(torch.float32)
        kp, score, valid = detect_keypoints(
            response_fn(self.response)(gray), max_kp=self.max_kp, nms_size=self.nms_size,
            rel_threshold=self.rel_threshold, border=self.border,
            subpixel=self.subpixel,
        )
        if self.descriptor == "gradhist":
            desc = gradhist_descriptors(gray, kp, valid)
        elif self.descriptor == "surf":
            desc = surf_descriptors(gray, kp, valid)
        elif self.oriented:
            desc = oriented_brief_descriptors(gray, kp, valid, bits=self.bits)
        else:
            desc = upright_brief_descriptors(gray, kp, valid, bits=self.bits)
        return Features(kp=kp, desc=desc, score=score, valid=valid)


# Counters of the process: CUDA graphs of the extraction captured, calls replayed from
# one, and calls run eagerly (every call off CUDA; on CUDA the call before each capture).
extract_counts = {"graph_captures": 0, "graph_replays": 0, "eager_calls": 0}


def extraction_counts() -> dict:
    """``OrbLikeExtractor``'s calls so far in the process: replayed from a CUDA graph
    (``extract_graph_replays``) and run eagerly (``extract_eager_calls``)."""
    return {"extract_graph_replays": extract_counts["graph_replays"],
            "extract_eager_calls": extract_counts["eager_calls"]}


# The captured extractions by signature, for the life of the process; per device the
# stream the captures run on and the memory pool the graphs share (one graph's
# temporaries reuse another's, as no two replays overlap), and the stream of the last
# replay, which the next replay on another stream waits for.
_graphs: dict = {}
_capture_home: dict = {}
_last_replay: dict = {}


class _ExtractGraph:
    """One captured ``OrbLikeExtractor._extract``: a static buffer for the images, the
    graph, which reads it, and the features it writes, in the graphs' memory pool."""

    @classmethod
    def capture(cls, extractor: OrbLikeExtractor, images: torch.Tensor):
        """-> (the graph, the features of ``images``).

        The call first runs eagerly on the device's capture stream, so that the
        allocator's and the kernels' state for that stream exist before the capture; its
        features are the call's. The graph then keeps the launches its kernels recorded
        (``kernels.end_capture``), counted at each replay. The capture is thread-local: a
        loader thread may upload meanwhile."""
        dev = images.device
        cur = torch.cuda.current_stream(dev)
        if dev not in _capture_home:
            _capture_home[dev] = (torch.cuda.Stream(dev), torch.cuda.graph_pool_handle())
        stream, pool = _capture_home[dev]
        g = cls()
        g.images = torch.empty(images.shape, dtype=images.dtype, device=dev)
        stream.wait_stream(cur)
        kernels.begin_capture(dev, stream.cuda_stream)
        with torch.cuda.stream(stream):
            first = extractor._extract(images)
        extract_counts["eager_calls"] += 1
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            g.features = extractor._extract(g.images)
        extract_counts["graph_captures"] += 1
        g.kernels = kernels.end_capture(dev, stream.cuda_stream)
        cur.wait_stream(stream)
        for t in first:
            t.record_stream(cur)
        return g, first

    def replay(self, images: torch.Tensor) -> Features:
        """The features of ``images`` from one replay on the current stream, copied out
        of the graph's memory."""
        dev = self.images.device
        cur = torch.cuda.current_stream(dev)
        last = _last_replay.get(dev)
        if last is not None and last != cur:
            cur.wait_stream(last)
        _last_replay[dev] = cur
        self.images.copy_(images)
        self.graph.replay()
        extract_counts["graph_replays"] += 1
        self.kernels.replayed()
        return Features(*(t.clone() for t in self.features))
