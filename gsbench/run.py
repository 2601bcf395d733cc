"""Run one cell of the benchmark once.

    python3 -m gsbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic and metrics
are found by the names in BENCHMARK.json (gsbench/harness.py). The last
line of standard output is the result: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`limits`, each compared number beside its limit; the same numbers are the
last lines of standard error. Exits 2 without a CUDA card (or with fewer
than the cell asks for), 3 when the program is not in the checkout, 4
when the process holds JAX or the JAX package once the window has closed.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from gsbench import harness  # noqa: E402


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout; no
    library the port uses may load JAX by itself."""
    cache = root / "gsbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, pkg: Path = harness.PKG,
             control: bool = False, fault: str = "", config: dict = None, traffic: dict = None,
             t_process: float = None) -> harness.Context:
    """One run of `workload` on `device`, checked: the whole run but the
    look for a card. `config` and `traffic` update the cell's files (the
    CPU tests' small sizes)."""
    import torch

    bench = harness.load_benchmark(pkg.parent)
    cell = harness.resolve_cell(bench, workload, pkg)
    cell.config.update(config or {})
    cell.traffic.update(traffic or {})
    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=torch.device(device),
                          t_process=T_PROCESS if t_process is None else t_process)
    drv = harness.driver_module(cell.traffic)
    state = drv.run(ctx, control=control, fault=fault)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    drv.check(ctx, state)
    return ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gsbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pkg = harness.PKG
    cache_dirs(pkg.parent)
    try:
        import hidegs_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"gsbench: the program (hidegs_tpu_torch) is not in this checkout: {e}", file=sys.stderr)
        return 3
    import torch

    bench = harness.load_benchmark(pkg.parent)
    chips = harness.by_name(bench["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gsbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    ctx = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", pkg)
    found = harness.forbidden_loaded()
    if found:
        print(f"gsbench: the process holds {', '.join(found)} after the window; no result", file=sys.stderr)
        return 4
    line = harness.result_line(ctx, pkg)
    for c in ctx.checks:
        print(f"limit {c.name}: {c.value!r} <= {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
