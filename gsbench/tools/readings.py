"""Readings for a cell's correctness limits, on the card at the cell's own
size, many seeds in one process:

    python3 -m gsbench.tools.readings correct --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--faults altered] [--fault-seeds 4 5 6] [--seconds 3]
        [--variants control half_batch altered altered_round]
    python3 -m gsbench.tools.readings instances --workload <cell> --seeds 1 2 3

`correct` runs the program (sound runs), the control (the program's
bf16 attribute stream, `RasterConfig.bf16_stream`) and each planted fault
through the whole run and its check, and prints each run's numbers as one
JSON line; other cells measure a short window. A trainer cell's window
closes right after the compared stretch, and the control and the faults
(`--variants`) run that stretch again from the sound run's start state
through the program's eager step, each held against the sound run's
reference: one warm-up and one reference per seed. `instances` renders every pose of a
viewer cell's path with the program's eager render and prints the largest
instance count, from which the cell's `max_instances` is set.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from gsbench import harness, run


def train(args, seed: int) -> None:
    """A trainer cell's sound run on `seed`, then its variants from the same
    start, each a JSON line."""
    from gsbench.checks import train as train_check
    from gsbench.drivers import train as drv

    t0 = time.perf_counter()
    bench = harness.load_benchmark()
    cell = harness.resolve_cell(bench, args.workload)
    ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False, device=torch.device("cuda:0"),
                          t_process=t0)
    state = drv.run(ctx, keep_batches=True)
    gc.collect()
    torch.cuda.empty_cache()
    drv.check(ctx, state)
    limits = cell.traffic["limits"]
    print(json.dumps({"seed": seed, "variant": "sound", "s": time.perf_counter() - t0,
                      "numbers": {c.name: float(c.value) for c in ctx.checks}, "notes": ctx.notes}), flush=True)
    for v in args.variants:
        t1 = time.perf_counter()
        notes = []
        readings = drv.variant_readings(state["readings"], v)
        ref = state["reference"]
        # the round held on its own, from the variant's state before it
        alone, info = train_check.reference_round(ref["tcfg"], ref["extent"], readings)
        checks = train_check.compare(readings, dict(ref, round_alone=alone, round_alone_info=info), limits,
                                     notes.append)
        del readings
        print(json.dumps({"seed": seed, "variant": v, "s": time.perf_counter() - t1,
                          "numbers": {c.name: float(c.value) for c in checks}, "notes": notes}), flush=True)
    del ctx, state
    gc.collect()
    torch.cuda.empty_cache()


def one(args, seed: int, control: bool = False, fault: str = "") -> dict:
    t0 = time.perf_counter()
    ctx = run.run_cell(args.workload, seed, args.seconds, False, "cuda:0", control=control, fault=fault)
    out = {"seed": seed, "control": control, "fault": fault, "s": time.perf_counter() - t0,
           "numbers": {c.name: float(c.value) for c in ctx.checks}, "notes": ctx.notes}
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    return out


def instances(args) -> None:
    from hidegs_tpu_torch.core.camera_math import make_camera
    from hidegs_tpu_torch.raster.api import RasterConfig, render

    from gsbench.drivers import view

    bench = harness.load_benchmark()
    cell = harness.resolve_cell(bench, args.workload)
    for seed in args.seeds:
        arrays = view.served_model(cell.config, seed, "cuda:0")
        poses = view.poses_of(cell.config, cell.traffic)
        most = 0
        for p in poses:
            cam = make_camera(p.R, p.t, fx=p.fx, fy=p.fy, cx=p.cx, cy=p.cy, height=p.height, width=p.width,
                              device="cuda:0")
            with torch.no_grad():
                out = render(*arrays, cam, config=RasterConfig(max_instances=1 << 24))
            most = max(most, int(out["num_instances"]))
        print(json.dumps({"seed": seed, "max_instances_needed": most,
                          "power_of_two": 1 << (most - 1).bit_length()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gsbench readings")
    ap.add_argument("what", choices=("correct", "instances"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--variants", nargs="*", default=["control", "half_batch", "altered", "altered_round"],
                    help="a trainer cell's variants of each seed's stretch")
    args = ap.parse_args(argv)
    run.cache_dirs(harness.ROOT)
    if args.what == "instances":
        instances(args)
        return 0
    bench = harness.load_benchmark()
    if harness.resolve_cell(bench, args.workload).traffic["driver"] == "train":
        for s in args.seeds:
            train(args, s)
        return 0
    for s in args.seeds:
        print(json.dumps(one(args, s)), flush=True)
    for s in args.control_seeds:
        print(json.dumps(one(args, s, control=True)), flush=True)
    for f in args.faults:
        for s in args.fault_seeds:
            print(json.dumps(one(args, s, fault=f)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
