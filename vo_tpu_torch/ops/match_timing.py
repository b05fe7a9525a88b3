"""Clocks for the match kernels on the card, and where each kernel's time goes.

    python -m vo_tpu_torch.ops.match_timing          # the wgmma kernel (bf16)
    python -m vo_tpu_torch.ops.match_timing fp32     # the SIMT kernel (fp32)
    PYTHONPATH=<checkout> python <this file> fp32 --times-only

(each needs an NVIDIA GPU and nvcc). ``graph_ms`` and ``eager_ms`` are the two clocks
``chip_smoke.py`` times the kernels with. Run as a script, this module builds copies
of one kernel's source with one part cut out each (the products, the epilogue's scans,
the merge across blocks, the operand loads, or everything: an empty kernel with the
same launch) and times them in turns against the whole kernel: the wgmma kernel at
2048 x 2048 x 256 bf16, the SIMT kernel at 2048 x 2048 x 128 on SIFT-like fp32
descriptors. A cut copy computes wrong results; only its time is read. The whole
kernel's time less a cut copy's is what that part costs on the kernel's critical
path. The card has no kernel profiler in reach (``ncu`` and ``nsys`` do not run
there), so this is the breakdown.

``fp32`` first times ``top2_mutual(bf16=False)`` at 2048 x 2048 x 128 (SIFT-like) and
2048 x 2048 x 256 (+-1 as fp32) over CUDA-graph replays. With ``--times-only`` it
stops there, so it can time the fp32 kernel of another checkout of the port: run this
file with that checkout first on ``PYTHONPATH``.
"""

from __future__ import annotations

import glob
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vo_tpu_torch.device import card_name
from vo_tpu_torch.ops import kernels, match

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


def eager_ms(fn, n: int, per: int = 10) -> float:
    """Time of one ``fn()`` called eagerly: the median over ``n`` CUDA-event brackets
    of ``per`` back-to-back calls. The host's time per call shows through wherever it
    exceeds the device's."""
    fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return float(np.median(times))


def graph_ms(fn, n: int, per: int = 10) -> float:
    """Device time of one ``fn()``: ``per`` calls captured in a CUDA graph, timed with
    CUDA events over ``n`` replays (median), so no host time shows through. Warm-up
    runs on the capture stream first, so the wrapper's cached scratch exists before
    the capture."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(per):
            fn()
    graph.replay()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return float(np.median(times))


def sift_like(rng, na: int, nb: int, d: int = 128):
    """Descriptors shaped like the gradhist ones of the SIFT path, as fp32 arrays:
    nonnegative, unit, clamped at 0.2, renormalised and rounded to bf16 values; half
    the rows of A planted in B with multiplicative noise. Masks drop ~5 %."""

    def finish(x):
        x = x / np.linalg.norm(x, axis=1, keepdims=True).clip(1e-8)
        x = np.clip(x, 0.0, 0.2)
        x = x / np.linalg.norm(x, axis=1, keepdims=True).clip(1e-8)
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float().numpy()

    a = rng.gamma(0.7, size=(na, d))
    b = rng.gamma(0.7, size=(nb, d))
    n = min(na, nb) // 2
    b[:n] = a[:n] * rng.uniform(0.7, 1.3, size=(n, d))
    return finish(a), finish(b), rng.uniform(size=na) > 0.05, rng.uniform(size=nb) > 0.05


def _cut(src: str, begin: str, end: str, repl: str) -> str:
    """``src`` with the text from ``begin`` up to ``end`` (kept) replaced by ``repl``."""
    i = src.index(begin)
    return src[:i] + repl + src[src.index(end, i):]


_MERGE = "  vo_match::merge_across_blocks<"
_ENTRY = "  extern __shared__ uint8_t smem_raw[];"


def _common_cuts(src: str, indent: str, x: str) -> dict[str, str]:
    """The cuts both kernels share; their TMA loads differ in indent and K offset."""
    loads = (f"{indent}mbar_expect_tx(&full_bar[s], STAGE_BYTES);\n"
             f"{indent}tma_load(dst, &map_a, {x}, row0, &full_bar[s]);\n"
             f"{indent}tma_load(dst + A_BYTES, &map_b, {x}, col0, &full_bar[s]);\n")
    for text in (loads, _MERGE, _ENTRY):
        if text not in src:
            raise ValueError(f"the kernel source no longer holds {text.strip()!r}")
    return {
        "merge across blocks": _cut(src, _MERGE, "}\n\n}  // namespace", ""),
        "operand loads": src.replace(loads, f"{indent}vo_match::mbar_arrive(&full_bar[s]);\n"),
        "everything": src.replace(_ENTRY, "  if (na >= 0) return;\n" + _ENTRY),
    }


def ablations(src: str) -> dict[str, str]:
    """Copies of the wgmma kernel's source, each with one part cut out."""
    mma_s = "          wgmma_m64n128k16(acc_s, a_own + 2 * k, b_all + 2 * k);\n"
    mma_t = "          wgmma_m64n128k16(acc_t, b_own + 2 * k, a_all + 2 * k);\n"
    for text in (mma_s, mma_t):
        if text not in src:
            raise ValueError(f"match_wgmma.cu no longer holds {text.strip()!r}")
    return {
        "products": src.replace(mma_s, "").replace(mma_t, ""),
        "epilogue scans": _cut(
            src, "      // Row top-2 over acc_s", "    }\n\n    // Merge the four lanes",
            "      if (acc_s[0] == 1234.5f) part_best[0] = acc_s[63] + acc_t[63];\n"),
        **_common_cuts(src, " " * 10, "c * BK"),
    }


def ablations_simt(src: str) -> dict[str, str]:
    """Copies of the SIMT kernel's source, each with one part cut out. Cutting the
    epilogue keeps every accumulator live through one sum per tile. Two more copies
    tell the products' two costs apart: one reads each operand fragment once per chunk
    instead of once per 4 k (7 of 8 shared loads gone), one does 1 of the 4 FMAs of
    each fragment."""
    return {
        "products (shared loads + FMAs)": _cut(
            src, "#pragma unroll\n        for (int q = 0; q < BK / 4; ++q)",
            "        // Release the stage", ""),
        "epilogue scans and column keys": _cut(
            src, "      // Epilogue of the tile.", "    }\n\n    // The 16 column threads",
            "      float z = 0.0f;\n"
            "      for (int i = 0; i < MT; ++i)\n"
            "        for (int j = 0; j < MT; ++j) z += acc[i][j];\n"
            "      if (z == 1234.5f) part_best[0] = z;\n"),
        **_common_cuts(src, " " * 4, "x"),
        "7 of 8 shared loads": src.replace("((q ^ sa) << 2)", "(sa << 2)")
                                       .replace("((q ^ sb) << 2)", "(sb << 2)"),
        "3 of 4 FMAs": src.replace("for (int e = 0; e < 4; ++e)",
                                         "for (int e = 0; e < 1; ++e)"),
    }


def _build_all(sources: dict[str, str], other: str) -> dict[str, str]:
    """Build each source (with ``other``, the other kernel's file, for the library's
    second entry point) into its own library, all at once; name -> library path."""
    out_dir = os.path.join(kernels.BUILD_DIR, "ablation")
    os.makedirs(out_dir, exist_ok=True)
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))

    def build(i: int, text: str) -> str:
        cu = os.path.join(out_dir, f"ablation_{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        files = [cu, os.path.join(_CSRC, other)]
        return kernels.compile_library(f"ablation_{i}", files + headers, lambda out: [
            kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", _CSRC, "-o", out, *files])[0]

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(zip(sources, pool.map(build, range(len(sources)), sources.values())))


def _ablate(label: str, kernel_file: str, other: str, cuts, call) -> None:
    """Times the whole kernel and each cut copy of ``kernel_file`` in turns."""
    with open(os.path.join(_CSRC, kernel_file)) as f:
        src = f.read()
    libs = _build_all({"whole kernel": src, **cuts(src)}, other)
    times: dict[str, list[float]] = {}
    try:
        for name in [*libs, *reversed(libs)]:        # in turns: whole, cuts, cuts, whole
            with kernels.library_at(libs[name]):
                match._scratch.clear()               # a cut copy leaves it dirty
                times.setdefault(name, []).append(graph_ms(call, 30))
    finally:
        match._scratch.clear()
    whole = float(np.mean(times["whole kernel"]))
    card = card_name(torch.device("cuda"))
    print(f"{label} ablation [{card}], CUDA-graph replays: whole kernel {whole * 1e3:.2f} us")
    for name, ts in times.items():
        if name != "whole kernel":
            t = float(np.mean(ts))
            print(f"  without {name}: {t * 1e3:.2f} us (that part: {(whole - t) * 1e3:.2f} us)")


def _on_card(arrays, dtype=torch.float32):
    a, b, va, vb = (torch.from_numpy(x).cuda() for x in arrays)
    return a.to(dtype), b.to(dtype), va, vb


def fp32_times(rng) -> dict[str, float]:
    """The fp32 kernel's device time (ms) at the SIFT path's and the main path's
    shapes, over CUDA-graph replays."""
    n = 2048
    cases = {"2048x2048x128 SIFT-like": sift_like(rng, n, n),
             "2048x2048x256 +-1 as fp32": tuple(
                 [np.sign(rng.normal(size=(n, 256))).astype(np.float32) for _ in range(2)]
                 + [rng.uniform(size=n) > 0.1 for _ in range(2)])}
    out = {}
    for name, arrays in cases.items():
        a, b, va, vb = _on_card(arrays)
        out[name] = graph_ms(lambda: match.top2_mutual(a, b, va, vb, bf16=False), 30)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("match_timing needs an NVIDIA GPU")
    rng = np.random.default_rng(0)
    if sys.argv[1:2] == ["fp32"]:
        times = fp32_times(rng)
        card = card_name(torch.device("cuda"))
        print(f"fp32 kernel times [{card}] ({match.__file__}), CUDA-graph replays: "
              + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in times.items()))
        if "--times-only" in sys.argv:
            return
        a, b, va, vb = _on_card(sift_like(rng, 2048, 2048))
        _ablate("SIMT kernel 2048x2048x128 fp32", "match_kernel.cu", "match_wgmma.cu",
                ablations_simt, lambda: match.top2_mutual(a, b, va, vb, bf16=False))
        return
    n = 2048
    a, b = (torch.from_numpy(np.sign(rng.normal(size=(n, 256))).astype(np.float32))
            .to("cuda", torch.bfloat16) for _ in range(2))
    va, vb = (torch.from_numpy(rng.uniform(size=n) > 0.1).cuda() for _ in range(2))
    _ablate(f"wgmma kernel {n}x{n}x256 bf16", "match_wgmma.cu", "match_kernel.cu",
            ablations, lambda: match.top2_mutual(a, b, va, vb, bf16=True))


if __name__ == "__main__":
    main()
