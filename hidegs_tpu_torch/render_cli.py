"""Render-only entry point — `python -m hidegs_tpu_torch.render_cli`.

Port of hidegs_tpu/render_cli.py (the reference README's render.py usage,
README.md:192-197): renders every camera of a scene with a trained model
into --output_path as PNGs, no metrics. A model directory written by the
JAX package works as is.

    python -m hidegs_tpu_torch.render_cli --model_path <model> --source_path <scene> --output_path <dir> [--device cuda]
    python -m hidegs_tpu_torch.render_cli --hierarchy <file.hier> --tau <px> --source_path <scene> --output_path <dir>

Everything runs on `--device` (default cuda, which raises without a card).
`--backend` takes the JAX package's names: "jnp" and "pallas" render with
the port's "blend" backend (its CUDA kernel on the card, the plain blend on
the CPU), all three computing the same function; "oracle" stays "oracle".
With `--hierarchy` every train camera is rendered from the LOD hierarchy in
that `.hier` file, cut at pixel granularity `--tau` (0 = the exact leaf
cut) by hier.interp.AdaptiveHierRenderer, instead of from a model's PLY.
"""
from __future__ import annotations

import argparse
import os

import torch

from hidegs_tpu_torch.config import ModelConfig, add_group, extract_group, port_backend
from hidegs_tpu_torch.convert import load_gaussian_state_from_ply
from hidegs_tpu_torch.device import resolve_device
from hidegs_tpu_torch.evaluate import save_png
from hidegs_tpu_torch.raster.api import RasterConfig, render
from hidegs_tpu_torch.train.checkpoint import find_latest_iteration


def main(argv=None):
    ap = argparse.ArgumentParser("hidegs_tpu_torch render")
    add_group(ap, ModelConfig())
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--backend", default="jnp")
    ap.add_argument("--max_instances", type=int, default=1 << 20)
    ap.add_argument("--tau", type=float, default=0.0, help="LOD target size in pixels (hierarchy mode)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    model_cfg = extract_group(args, ModelConfig)
    dev = resolve_device(args.device)

    from hidegs_tpu_torch.data.scene import load_scene

    scene = load_scene(
        model_cfg.source_path, images=model_cfg.images, resolution=model_cfg.resolution
    )
    cfg = RasterConfig(backend=port_backend(args.backend), max_instances=args.max_instances)
    os.makedirs(args.output_path, exist_ok=True)

    if model_cfg.hierarchy:
        from hidegs_tpu_torch.hier.interp import AdaptiveHierRenderer
        from hidegs_tpu_torch.hier.io import read_hier

        # τ-aware budgets: the buffers fit the cut, so coarse taus render
        # with proportionally small streams
        renderer = AdaptiveHierRenderer.from_hierarchy(read_hier(model_cfg.hierarchy), dev,
                                                       backend=port_backend(args.backend))
        for i in range(len(scene.train_cameras)):
            cam = scene.train_cameras[i]
            # --tau is in pixels (the reference's convention); 0 = exact leaf cut
            with torch.no_grad():
                out = renderer.render(cam.cam_params(dev), args.tau)
            save_png(os.path.join(args.output_path, f"{i:05d}.png"), torch.clamp(out["render"], 0, 1))
        print(f"rendered {len(scene.train_cameras)} hierarchy views → {args.output_path}")
        return

    it = args.iteration
    root = os.path.join(model_cfg.model_path, "point_cloud")
    if it == -1:
        it = find_latest_iteration(root)
    arrays = load_gaussian_state_from_ply(
        os.path.join(root, f"iteration_{it}", "point_cloud.ply"), device=dev
    )
    for i in range(len(scene.train_cameras)):
        cam = scene.train_cameras[i]
        with torch.no_grad():
            out = render(*arrays, cam.cam_params(dev), config=cfg)
        save_png(os.path.join(args.output_path, f"{i:05d}.png"), torch.clamp(out["render"], 0, 1))
    print(f"rendered {len(scene.train_cameras)} views → {args.output_path}")


if __name__ == "__main__":
    main()
