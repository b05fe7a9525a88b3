"""Read the numbers that ``correct`` compares, for setting their limits: the program's
on every ``--seeds`` seed and the control's (the plain reference one precision down,
in the program's place) on every ``--control-seeds`` seed, at the cell's own size.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ... \
        --control-seeds 7 8 9

Prints one JSON line per reading, then per number the largest program reading, the
smallest control reading and the limit in force. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from vobench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    w = harness.workload(args.workload)
    drv = harness.driver(w["traffic"])
    limits = w["config"]["correctness"]["limits"]
    sound, control = {}, {}
    for kind, seeds, acc in (("program", args.seeds, sound),
                             ("control", args.control_seeds, control)):
        for seed in seeds:
            nums = drv.readings(w["config"], w["traffic"], seed, dev,
                                control=kind == "control")
            print(json.dumps({"kind": kind, "seed": seed, **nums}), flush=True)
            for k, v in nums.items():
                acc.setdefault(k, []).append(v)
    for k, limit in limits.items():
        print(json.dumps({"number": k, "program_max": max(sound.get(k, [float("nan")])),
                          "control_min": min(control.get(k, [float("nan")])),
                          "limit": limit}))
    print("card " + harness.card_string())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
