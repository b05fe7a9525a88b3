"""Run one cell of the benchmark once against ``vo_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/``) and a traffic mix (``benchmark/traffic/``); the traffic names
its driver in ``benchmark/vobench/``. With ``--trace 0`` the last line of standard
output carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones
(``benchmark/metrics/``), read from a profiled sub-window. Each number compared for
``correct`` is printed beside its limit as the last lines of standard error and
under ``checks``, the last key of the result line.

Without a CUDA card, with fewer cards than the cell asks for, or when the process has
loaded JAX or the JAX package, it prints no result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]      # the harness, then the program

from vobench import harness  # noqa: E402


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(harness.ROOT, "_bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    w = harness.workload(args.workload)

    import torch

    chips = w["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s), found {n}: no result", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = harness.card_string()
    ctx = SimpleNamespace(config=w["config"], traffic=w["traffic"], device=dev,
                          seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          t0=T_START)
    run = harness.driver(w["traffic"]).run(ctx)

    found = harness.forbidden_loaded()
    if found:
        print(f"the process loaded {found}: the benchmark may not run JAX or the JAX "
              "package; no result", file=sys.stderr)
        return 2
    line = harness.result_line(w, run, bool(args.trace), torch.cuda.get_device_name(dev), card)
    info = dict(run.info, workload=args.workload, seed=args.seed, window_s=run.window_s,
                frames=run.frames, setup_s=run.setup_s,
                memory_peak_bytes=run.memory_peak_bytes, card=card)
    if run.trace is not None:
        info.update(trace_frames=run.trace.frames, trace_launches=run.trace.launches,
                    trace_runtime_calls=run.trace.runtime_calls)
    print("run " + json.dumps(info))
    for c in run.checks:
        print(f"check {c.name} {c.value!r} <= {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
