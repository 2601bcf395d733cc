#!/usr/bin/env python3
"""Repro of a segfault inside CUPTI's cuGraphLaunch callback under
torch.profiler (ROADMAP C44), on one GPU.

    python3 tools/profile_replay_crash.py [--runs 3] [--running-sum] [--cudart-shared] [--root DIR]

Each run is a child process that drives chip_smoke.py on a 100,000-point
scene (16 structures; the full 1920x1088 views): the full-width render
(phase 6a), the compiled render (6r) and the view-parallel phase (15), which
profiles its compiled V = 4 step after the bf16 and NCCL graphs were
destroyed; the child stops at phase 15's trace. Prints, per run, its exit
code and whether it reached the trace or died of SIGSEGV, then the counts.

  --running-sum    adds the step's views' gradients in a running sum,
                   ((v0 + v1) + v2) + v3, in place of the halves
                   (parallel/sharded.py:_halves_sum);
  --cudart-shared  links the kernels' libraries to the shared CUDA runtime
                   (`-cudart shared`) in place of the static one;
  --root DIR       runs DIR's chip_smoke.py and package, e.g. a `git archive`
                   of another commit.

Exits non-zero if any run crashed.
"""
from __future__ import annotations

import argparse
import signal
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class _Reached(Exception):
    pass


def child(running_sum: bool, cudart_shared: bool) -> None:
    import torch

    import chip_smoke as cs
    from hidegs_tpu_torch.utils import profiling

    cs.N_GROUND, cs.N_STRUCTS = 100_000, 16
    if cudart_shared:
        from hidegs_tpu_torch.raster import cuda_blend
        cuda_blend.NVCC_FLAGS = cuda_blend.NVCC_FLAGS + ("-cudart", "shared")
    if running_sum:
        from hidegs_tpu_torch.parallel import sharded

        def running(items, n):
            acc = next(items)
            for _ in range(n - 1):
                acc = [a + b for a, b in zip(acc, next(items))]
            return acc

        sharded._halves_sum = running

    def stop(*args, **kwargs):
        raise _Reached()

    profiling.trace = stop
    cs.phase_environment()
    scene, cams, cfg = cs.full_width_setup(torch.device("cuda"))
    _, outs = cs.phase_full_width(scene, cams, cfg)
    cs.phase_render_compiled(scene, cams, cfg)
    del outs
    try:
        cs.phase_view_parallel(scene, cams, cfg)
    except _Reached:
        print("reached the trace", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--running-sum", action="store_true")
    ap.add_argument("--cudart-shared", action="store_true")
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, str(Path.cwd()))
        child(args.running_sum, args.cudart_shared)
        return 0
    flags = [f for f, on in (("--running-sum", args.running_sum), ("--cudart-shared", args.cudart_shared)) if on]
    crashed = reached = 0
    for i in range(args.runs):
        proc = subprocess.run([sys.executable, "-X", "faulthandler", str(Path(__file__).resolve()), "--child", *flags],
                              cwd=args.root, capture_output=True, text=True, timeout=600)
        segv = proc.returncode == -signal.SIGSEGV
        ok = "reached the trace" in proc.stdout
        crashed += segv
        reached += ok
        print(f"[crash-repro] run {i + 1} {' '.join(flags) or '(halves, static runtime)'} root {args.root}: "
              f"rc {proc.returncode}, {'SIGSEGV' if segv else 'reached the trace' if ok else 'failed'}", flush=True)
        if not (segv or ok):
            print(proc.stdout[-3000:], proc.stderr[-3000:], sep="\n")
    print(f"[crash-repro] {crashed} of {args.runs} runs crashed, {reached} reached the trace")
    return 1 if crashed or reached < args.runs else 0


if __name__ == "__main__":
    sys.exit(main())
