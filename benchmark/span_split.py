"""Run one cell traced with the program's spans recorded over its profiled sub-window,
and print where the sub-window's launches and idle time fall among the program's
stages.

    python3 benchmark/span_split.py --workload <name> --seed <n> --seconds <s>

The cell runs as ``run.py --trace 1`` runs it, the recorder of
``vo_tpu_torch/utils/profiling.py`` switched on and off with the profiler at the ends
of the sub-window. Prints one JSON line: ``line``, the cell's traced result line, and
``spans``: ``vobench/spans.py``'s readings over the sub-window (PnP's host time and
launches per frame, the idle time under ``engine.chunk``, the readback waits, R2D2's
selection on the device), ``idle_by_span``, and per span name its count, and per
frame its host ms, device ms, and the launch calls and idle ms it holds innermost.
Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from types import SimpleNamespace  # noqa: E402

from vobench import harness, spans, trace  # noqa: E402


class SpanWindow(trace.SubWindow):
    """The sub-window, with the program's recorder on between its ends; keeps the
    spans and the trace's launch calls and idle gaps."""

    made: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.spans = None
        SpanWindow.made.append(self)

    def at(self, k: int) -> None:
        from vo_tpu_torch.utils import profiling

        closing = k == self.last and self.prof is not None
        super().at(k)
        if k == self.first:
            profiling.start()
        elif closing:
            self.spans = profiling.stop()

    def split(self) -> dict | None:
        if self.spans is None:
            return None
        launches, threads, gaps = spans.trace_intervals(
            self.prof.profiler.kineto_results.events())
        out = spans.readings(self.spans, launches, threads, gaps, self.frames)
        out["table"] = spans.table(self.spans, self.frames, launches, threads, gaps)
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    w = harness.workload(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card: no result", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = harness.card_string()
    drv = harness.driver(w["traffic"])
    ctx = SimpleNamespace(config=w["config"], traffic=w["traffic"], device=dev,
                          seed=args.seed, seconds=args.seconds, trace=True, t0=T_START)
    drv.SubWindow = SpanWindow                  # this process only: the driver's window
    run = drv.run(ctx)
    line = harness.result_line(w, run, True, torch.cuda.get_device_name(dev), card)
    split = SpanWindow.made[-1].split() if SpanWindow.made else None
    print(json.dumps({"workload": args.workload, "seed": args.seed, "line": line,
                      "spans": split}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
