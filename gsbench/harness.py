"""What every cell shares: the benchmark's files found by name, the run's
context, the per-layer metric readers and the result line.

Everything of one configuration, one traffic mix or one per-layer metric
sits in a file of its own under gsbench/, found by the name that
BENCHMARK.json gives it:

  * configs/<config>.json   the sizes as they are run;
  * traffic/<traffic>.json  the mix's parameters, with "driver" naming the
                            module of gsbench/drivers/ that runs it;
  * metrics/<metric>.py     a reader, `read(ctx) -> float | None`; None
                            leaves the metric out of the line.

A new cell, configuration, mix or metric is new files and a new entry.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "hidegs_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def traffic_path(name: str, pkg: Path = PKG) -> Path:
    return pkg / "traffic" / f"{name}.json"


def metric_path(name: str, pkg: Path = PKG) -> Path:
    return pkg / "metrics" / f"{name}.py"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str, pkg: Path = PKG) -> Callable[["Context"], Optional[float]]:
    """The `read` function of metrics/<name>.py (names hold dots, so the
    file is loaded by its path)."""
    path = metric_path(name, pkg)
    spec = importlib.util.spec_from_file_location(f"gsbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_module(traffic: dict):
    return importlib.import_module(f"gsbench.drivers.{traffic['driver']}")


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic and
    metric entries resolved."""

    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]


def cell_metrics(bench: dict, workload: str):
    """(end_to_end, per_layer) entries of BENCHMARK.json that `workload`
    reports: those without a "workloads" key, and those that list it."""
    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if mine(m) and m["moves"] in names]
    return e2e, per


def resolve_cell(bench: dict, workload: str, pkg: Path = PKG) -> Cell:
    """The cell `workload` of `bench`, its files read from the benchmark
    directory `pkg` (whose parent holds BENCHMARK.json)."""
    w = by_name(bench["workloads"], workload, "workload")
    cfg_entry = by_name(bench["configs"], w["config"], "config")
    config = load_json(pkg.parent / cfg_entry["file"])
    traffic = load_json(traffic_path(w["traffic"], pkg))
    e2e, per = cell_metrics(bench, workload)
    return Cell(workload=w, config=config, traffic=traffic, end_to_end=e2e, per_layer=per)


@dataclass
class Check:
    """One number compared against its limit: `ok` when value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Context:
    """What a driver hands back: the window, the counts and what the
    metric readers read."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_process: float
    setup_s: float = float("nan")
    window_s: float = float("nan")
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = field(default_factory=dict)  # end-to-end values, by metric name
    spans: Dict[str, List[float]] = field(default_factory=dict)  # device ms of each call, by span name
    counters: Dict[str, float] = field(default_factory=dict)
    yardstick: Dict[str, Any] = field(default_factory=dict)  # bounds, kernel times and trace durations
    profile: Optional[dict] = None  # busy_s, window_s, breakdown of the profiled part of the window
    checks: List[Check] = field(default_factory=list)
    memory_peak_bytes: int = 0
    notes: List[str] = field(default_factory=list)

    def span(self, name: str, ms: float) -> None:
        self.spans.setdefault(name, []).append(ms)

    def note(self, text: str) -> None:
        self.notes.append(text)
        print(f"[gsbench] {text}", file=sys.stderr, flush=True)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them, or ''."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names in sys.modules that the run may not hold, compared
    whole: `hidegs_tpu_torch` is not `hidegs_tpu`."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


def result_line(ctx: Context, pkg: Path = PKG) -> dict:
    """The last line of standard output."""
    cell = ctx.cell
    metrics = {}
    if not ctx.trace:
        for m in cell.end_to_end:
            v = ctx.setup_s if m["name"] == "setup_s" else ctx.e2e.get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = load_reader(m["name"], pkg)(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    import torch

    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    out = {"correct": bool(ctx.checks) and all(c.ok for c in ctx.checks), "attempted": int(ctx.attempted),
           "failed": int(ctx.failed), "metrics": metrics, "device": device}
    if ctx.trace and ctx.profile is not None:
        device["busy_s"] = ctx.profile["busy_s"]
        device["window_s"] = ctx.profile["window_s"]
        out["breakdown"] = ctx.profile["breakdown"]
    if ctx.device.type == "cuda":
        device["card"] = power_limit()
    out["limits"] = {c.name: {"value": c.value, "limit": c.limit} for c in ctx.checks}
    return out


def now() -> float:
    return time.perf_counter()
