#!/usr/bin/env python3
"""The terrain quality run of the port, on one GPU.

    python3 tools/terrain_quality_run.py [--out summary.json] [--work DIR] [--device cuda]

Writes the realistic terrain scene with the port's terrain writer (a
ray-marched height field with view-dependent shading, 16-bit synthetic
monodepth maps and noisy sparse points: 30 views at 512x512 on a 6x5
`nadir_grid_camera` grid, the JAX package's benchmarks/quality_run.py
--terrain scene; the views are ray-marched in one spawned worker process
per CPU core), then runs `python -m hidegs_tpu_torch.train` for 15,000
iterations with the flags that script passes (--eval, so every 8th view is
a test view; densify thresholds 0.04 / 0.002; monodepth supervision; 2,000
skybox points) and the three levers of the JAX package's r5 terrain run
(docs/quality_terrain_r5.json, commit 3507aaf): capacity 2^19, no opacity
reset after iteration 9,000, densify growth capped at 0.25 of the alive
rows a round; then `python -m hidegs_tpu_torch.evaluate`. Prints and
writes the train and test PSNR / SSIM / LPIPS (random-vgg unless
calibrated weights are installed), the wall time of each stage, and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the protocol of the JAX package's terrain runs
SIZE, GRID, ITERATIONS, N_POINTS = 512, (6, 5), 15_000, 16_000
FLAGS = ["--eval", "--densify_grad_threshold", "0.04", "--densify_abs_grad_threshold", "0.002",
         "--depths", "depths", "--skybox_num", "2000",
         "--capacity", str(1 << 19), "--opacity_reset_until_iter", "9000", "--densify_max_growth", "0.25"]


def write_scene(root: str, cams, processes: int, n_points: int = N_POINTS) -> None:
    """The port's `write_terrain_colmap_scene`, with the views ray-marched
    in `processes` spawned workers: the same files."""
    from hidegs_tpu_torch.data import synthetic

    jobs = synthetic._terrain_view_jobs(root, cams)
    with multiprocessing.get_context("spawn").Pool(processes) as pool:
        depth_params = dict(pool.map(synthetic._write_terrain_view, jobs))
    synthetic._write_terrain_sparse(root, cams, depth_params, n_points=n_points)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=str(ROOT / "build" / "terrain_quality"))
    ap.add_argument("--out", default=str(ROOT / "build" / "terrain_quality" / "summary.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # the card's name and power limit, first: without a card this run has no numbers to give
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sys.path.insert(0, str(ROOT))
    from hidegs_tpu_torch.data.synthetic import nadir_grid_camera

    scene, model = os.path.join(args.work, "scene"), os.path.join(args.work, "model")
    shutil.rmtree(scene, ignore_errors=True)
    shutil.rmtree(model, ignore_errors=True)
    times = {}
    t0 = time.perf_counter()
    nx, ny = GRID
    cams = [nadir_grid_camera(ix, iy, nx, ny, height=SIZE, width=SIZE, device="cpu")
            for iy in range(ny) for ix in range(nx)]
    write_scene(scene, cams, os.cpu_count() or 1)
    times["write_scene_s"] = time.perf_counter() - t0

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    train = [sys.executable, "-m", "hidegs_tpu_torch.train", "--source_path", scene, "--model_path", model,
             "--iterations", str(ITERATIONS), *FLAGS,
             "--save_iterations", "7000", str(ITERATIONS), "--device", args.device]
    t0 = time.perf_counter()
    subprocess.run(train, check=True, env=env)
    times["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "hidegs_tpu_torch.evaluate", "--source_path", scene, "--model_path", model,
                    "--eval", "--no_images", "--device", args.device], check=True, env=env)
    times["evaluate_s"] = time.perf_counter() - t0

    report = json.load(open(os.path.join(model, f"eval_{ITERATIONS}", "results.json")))
    summary = {
        "workload": {"scene": "terrain (write_terrain_colmap_scene)", "views": nx * ny,
                     "resolution": [SIZE, SIZE], "iterations": ITERATIONS,
                     "eval_split": "llffhold=8", "flags": train[3:]},
        "card": card,
        "lpips_kind": report["lpips_kind"],
        "train": report["train"]["mean"],
        "test": report["test"]["mean"],
        "times": times,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
