"""What every cell shares: finding a workload's files by name, the card and its
name, per-layer readers, the checks of ``correct``, and the result line.

Files, found by the names in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json``: the system as it is run;
- ``benchmark/traffic/<traffic>.json``: the traffic mix, with the ``driver`` (a module
  of ``vobench``) that generates it and runs it against the program;
- ``benchmark/metrics/<metric>.py``: the reader of a metric, end-to-end or per-layer,
  ``read(run: Run) -> float | None`` (None: nothing to read in this cell).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "vo_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def workload(name: str, man: dict | None = None) -> dict:
    """{"cell", "config", "traffic", "end_to_end", "per_layer"} of the named cell: its
    entry, its configuration and traffic files, and the metrics it reports."""
    man = man or manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    config = load_json(ROOT, configs[cell["config"]]["file"])
    traffic = load_json(BENCH_DIR, "traffic", f"{cell['traffic']}.json")
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return {"cell": cell, "config": config, "traffic": traffic, "end_to_end": e2e,
            "per_layer": per_layer}


def driver(traffic: dict):
    """The module that generates and runs this kind of traffic."""
    return importlib.import_module(f"vobench.{traffic['driver']}")


def reader(metric: str):
    """``read`` of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_string(index: int = 0) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[index]


def forbidden_loaded() -> list[str]:
    """Modules loaded in this process whose top-level name is one the benchmark may not
    run, compared whole (``vo_tpu_torch`` is not ``vo_tpu``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


@dataclass
class Check:
    """One number compared for ``correct``: it passes when ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def checks_from(numbers: dict, limits: dict) -> list[Check]:
    """The numbers a judge read, each against the limit of the same name."""
    missing = set(limits) - set(numbers)
    if missing:
        raise RuntimeError(f"the judge read no {sorted(missing)}")
    return [Check(k, float(numbers[k]), float(limits[k])) for k in limits]


@dataclass
class Run:
    """What a driver hands back: the end-to-end readings, what per-layer readers read
    from, and the checks."""

    frames: int
    window_s: float
    setup_s: float
    memory_peak_bytes: int
    checks: list
    attempted: int
    failed: int = 0
    stats: dict = field(default_factory=dict)      # program counters over the window
    extract_ms: float | None = None                # CUDA events around extraction
    extract_frames: int = 0
    trace: object = None                           # trace.Summary of the sub-window
    config: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)
    info: dict = field(default_factory=dict)       # printed on an earlier line


def result_line(w: dict, run: Run, trace: bool, device_kind: str, card: str) -> dict:
    """The last line: correct, attempted, failed, metrics, device[, breakdown], checks."""
    metrics = {}
    for m in w["per_layer" if trace else "end_to_end"]:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": w["cell"]["chips"],
              "memory_peak_bytes": run.memory_peak_bytes, "card": card}
    line = {"correct": all(c.ok for c in run.checks), "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return line
