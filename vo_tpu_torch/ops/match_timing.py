"""Clocks for the match kernels on the card, and where the wgmma kernel's time goes.

    python -m vo_tpu_torch.ops.match_timing      # needs an NVIDIA GPU and nvcc

``graph_ms`` and ``eager_ms`` are the two clocks ``chip_smoke.py`` times the kernels
with. Run as a script, this module builds copies of ``csrc/match_wgmma.cu`` with one
part cut out each (the products, the epilogue's scans, the merge across blocks, the
operand loads, or everything: an empty kernel with the same launch) and times them
in turns against the whole kernel at 2048 x 2048 x 256 bf16. A cut copy computes
wrong results; only its time is read. The whole kernel's time less a cut copy's is
what that part costs on the kernel's critical path. The card has no kernel profiler
in reach (``ncu`` and ``nsys`` do not run there), so this is the breakdown.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

from vo_tpu_torch.ops import match


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


def _cut(src: str, begin: str, end: str, repl: str) -> str:
    """``src`` with the text from ``begin`` up to ``end`` (kept) replaced by ``repl``."""
    i = src.index(begin)
    return src[:i] + repl + src[src.index(end, i):]


def ablations(src: str) -> dict[str, str]:
    """Copies of the wgmma kernel's source, each with one part cut out."""
    mma_s = "          wgmma_m64n128k16(acc_s, a_own + 2 * k, b_all + 2 * k);\n"
    mma_t = "          wgmma_m64n128k16(acc_t, b_own + 2 * k, a_all + 2 * k);\n"
    loads = ("          mbar_expect_tx(&full_bar[s], STAGE_BYTES);\n"
             "          tma_load(dst, &map_a, c * BK, row0, &full_bar[s]);\n"
             "          tma_load(dst + A_BYTES, &map_b, c * BK, col0, &full_bar[s]);\n")
    for text in (mma_s, mma_t, loads):
        if text not in src:
            raise ValueError(f"match_wgmma.cu no longer holds {text.strip()!r}")
    return {
        "products": src.replace(mma_s, "").replace(mma_t, ""),
        "epilogue scans": _cut(
            src, "      // Row top-2 over acc_s", "    }\n\n    // Merge the four lanes",
            "      if (acc_s[0] == 1234.5f) part_best[0] = acc_s[63] + acc_t[63];\n"),
        "merge across blocks": _cut(src, "  __syncthreads();\n  if (tid == 0 || tid == 32)",
                                    "typedef CUresult", "}\n\n"),
        "operand loads": src.replace(loads, "          mbar_arrive(&full_bar[s]);\n"),
        "everything": src.replace("  extern __shared__ uint8_t smem_raw[];",
                                  "  if (na >= 0) return;\n  extern __shared__ uint8_t smem_raw[];"),
    }


def _build_all(sources: dict[str, str], out_dir: str) -> dict[str, str]:
    """nvcc each source (with the SIMT kernel, for the library's second entry point)
    into its own library, all at once; name -> library path."""
    csrc = os.path.join(os.path.dirname(__file__), "csrc")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = os.path.join(out_dir, f"ablation_{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = cu[:-3] + ".so"
        cmd = [match._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", csrc, "-o", lib, cu,
               os.path.join(csrc, "match_kernel.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{err}")
        libs[name] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("match_timing needs an NVIDIA GPU")
    with open(os.path.join(os.path.dirname(__file__), "csrc", "match_wgmma.cu")) as f:
        src = f.read()
    libs = _build_all({"whole kernel": src, **ablations(src)},
                      os.path.join(match._BUILD_DIR, "ablation"))
    rng = np.random.default_rng(0)
    n = 2048
    a, b = (torch.from_numpy(np.sign(rng.normal(size=(n, 256))).astype(np.float32))
            .to("cuda", torch.bfloat16) for _ in range(2))
    va, vb = (torch.from_numpy(rng.uniform(size=n) > 0.1).cuda() for _ in range(2))
    bound = match._lib
    times: dict[str, list[float]] = {}
    try:
        for name in [*libs, *reversed(libs)]:        # in turns: whole, cuts, cuts, whole
            match._lib = match.load_library(libs[name])
            match._scratch.clear()                   # a cut copy leaves it dirty
            times.setdefault(name, []).append(
                graph_ms(lambda: match.top2_mutual(a, b, va, vb, bf16=True), 30))
    finally:
        match._lib = bound
        match._scratch.clear()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    whole = float(np.mean(times["whole kernel"]))
    print(f"wgmma kernel ablation [{card.stdout.strip()}] {n}x{n}x256 bf16, CUDA-graph "
          f"replays: whole kernel {whole * 1e3:.2f} us")
    for name, ts in times.items():
        if name != "whole kernel":
            t = float(np.mean(ts))
            print(f"  without {name}: {t * 1e3:.2f} us (that part: {(whole - t) * 1e3:.2f} us)")


if __name__ == "__main__":
    main()
