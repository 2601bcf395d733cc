#!/usr/bin/env python3
"""Where the bf16 attribute stream's gradients depart from float32's.

    python3 tools/bf16_departure.py [--tiles 16 32]

Renders toy scenes through `render()` with the "blend" backend on the CPU,
where it runs the plain versions (`raster/blend_plain.py`; the CUDA kernels
compute the same function and are held against them in chip_smoke.py
phase 10a), with the loss of the JAX package's bf16 test, mean(render²),
and prints the means' and opacities' gradients against float32's, each as
max |bf16 − f32| over the float32 max |grad| (the JAX tolerance is 5e-2),
for four streams:

  * bf16: the stream as RasterConfig(bf16_stream=True) blends it;
  * mean only: only the tile-relative mean2d rounded to bfloat16;
  * all but the mean: every other channel rounded, mean2d re-based to its
    tile in float32;
  * none: nothing rounded (must equal float32: 0).

It switches the plain versions' rounding, which the kernels cannot do, so it
runs on the CPU only.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hidegs_tpu_torch.data.synthetic import make_toy_gaussians, ring_camera  # noqa: E402
from hidegs_tpu_torch.raster import blend_plain  # noqa: E402
from hidegs_tpu_torch.raster.api import RasterConfig, render  # noqa: E402

# (seed, gaussians, height, width) of make_toy_gaussians and ring_camera 0;
# the first has the sizes of the JAX package's bf16 test
SCENES = ((3, 100, 32, 32), (6, 300, 64, 96), (4, 400, 64, 64))
VARIANTS = ("bf16", "mean only", "all but the mean", "none")


def unrounded_instance_mean(pre, gid, tid, tiles_x, tile, rel):
    """blend_plain._instance_mean with the tile-relative mean2d left in float32."""
    ox = ((tid % tiles_x) * tile).to(torch.float32)
    oy = (torch.div(tid, tiles_x, rounding_mode="floor") * tile).to(torch.float32)
    mean2d = pre.mean2d[gid]
    if rel:
        mean2d = mean2d - torch.stack([ox, oy], dim=1)
        ox = oy = torch.zeros_like(ox)
    return mean2d, ox, oy


def unrounded_attrs(pre):
    return blend_plain.PackedGaussians(pre.mean2d, pre.conic, pre.opacity, pre.rgb, pre.inv_depth, pre.normal,
                                       pre.distance)


def grads(scene, cam, cfg):
    leaves = [x.detach().clone().requires_grad_(i in (0, 3)) for i, x in enumerate(scene)]
    render(*leaves, cam, config=cfg)["render"].square().mean().backward()
    return leaves[0].grad, leaves[3].grad


def departures(scene, cam, tile, variant):
    cfg = RasterConfig(backend="blend", tile=tile, max_instances=1 << 14)
    want = grads(scene, cam, cfg)
    mean_fn, attrs_fn = blend_plain._instance_mean, blend_plain.bf16_attrs
    try:
        if variant in ("all but the mean", "none"):
            blend_plain._instance_mean = unrounded_instance_mean
        if variant in ("mean only", "none"):
            blend_plain.bf16_attrs = unrounded_attrs
        got = grads(scene, cam, dataclasses.replace(cfg, bf16_stream=True))
    finally:
        blend_plain._instance_mean, blend_plain.bf16_attrs = mean_fn, attrs_fn
    return [float((g - w).abs().max()) / (float(w.abs().max()) + 1e-8) for g, w in zip(got, want)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=[16, 32])
    args = ap.parse_args(argv)
    print("scene (seed, gaussians, HxW), tile: means / opacities departure per stream")
    for seed, n, h, w in SCENES:
        scene = make_toy_gaussians(n, seed=seed, device="cpu")
        cam = ring_camera(0, height=h, width=w, device="cpu")
        for tile in args.tiles:
            cells = [departures(scene, cam, tile, v) for v in VARIANTS]
            print(f"({seed}, {n}, {h}x{w}), tile {tile}: " + "; ".join(
                f"{v} {m:.4f} / {o:.4f}" for v, (m, o) in zip(VARIANTS, cells)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
