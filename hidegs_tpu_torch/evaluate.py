"""Evaluation entry point — `python -m hidegs_tpu_torch.evaluate`.

Port of hidegs_tpu/evaluate.py (the reference's eval.py:275-427): loads a
trained model at an iteration, renders the train/test cameras, saves
gt/render PNGs, and reports masked PSNR / SSIM / LPIPS per view and per set
in `<model>/eval_<iteration>/results.json`. LPIPS uses a converted VGG
weight file when one exists ("calibrated-vgg"), else the seeded
random-weight fallback ("random-vgg", train/lpips.py); the kind is recorded
as `lpips_kind`. A model directory written by the JAX package
(`cfg_args.json`, `point_cloud/iteration_N/point_cloud.ply`) works as is.

    python -m hidegs_tpu_torch.evaluate --model_path <model> --source_path <scene> --resolution 1 [--device cuda]

Everything runs on `--device` (default cuda, which raises without a card);
on a card every view of the "blend" backend is a replay of the render's
CUDA graph (raster/compiled.py:CompiledRender), one capture per image
size; the "oracle" renders eagerly.
The snapshot's `raster_backend` "jnp" and "pallas" render with the port's
"blend" backend (its CUDA kernel on the card, the plain blend on the CPU):
all three compute the same function; "oracle" stays "oracle".
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from hidegs_tpu_torch.config import ModelConfig, add_group, extract_group, get_combined_args, port_backend
from hidegs_tpu_torch.convert import load_gaussian_state_from_ply
from hidegs_tpu_torch.device import resolve_device
from hidegs_tpu_torch.raster.api import RasterConfig
from hidegs_tpu_torch.raster.compiled import serving_render
from hidegs_tpu_torch.train.checkpoint import find_latest_iteration
from hidegs_tpu_torch.train.losses import psnr, ssim
from hidegs_tpu_torch.utils.png import write_png


def default_lpips_weights() -> str:
    """Converted-LPIPS weight discovery: $HIDEGS_LPIPS_WEIGHTS, then the
    conventional cache path (the JAX package's `python -m
    hidegs_tpu.train.lpips --out ~/.cache/hidegs/lpips_vgg.npz` writes it, in
    an environment with the `lpips` pip package)."""
    env = os.environ.get("HIDEGS_LPIPS_WEIGHTS", "")
    if env and os.path.exists(env):
        return env
    cache = os.path.expanduser("~/.cache/hidegs/lpips_vgg.npz")
    return cache if os.path.exists(cache) else ""


def save_png(path: str, img_chw: torch.Tensor):
    """Write a (3, H, W) image in [0, 1] as an 8-bit RGB PNG."""
    arr = np.clip(img_chw.detach().cpu().numpy().transpose(1, 2, 0), 0, 1)
    write_png(path, (arr * 255).astype(np.uint8))


def evaluate_set(name, dataset, arrays, cfg: RasterConfig, out_dir, lpips_fn=None, save_images=True, *,
                 render_fn):
    """Render, score and (optionally) save every view of `dataset` with the
    render inputs `arrays`, on the device those lie on. `render_fn` renders
    as `render` does (`serving_render`'s: a CUDA graph replayed per view
    for the "blend" backend on a card)."""
    dev = arrays[0].device
    results = []
    if save_images:
        os.makedirs(os.path.join(out_dir, name, "renders"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, name, "gt"), exist_ok=True)
    for i in range(len(dataset)):
        cam = dataset[i]
        with torch.no_grad():
            out = render_fn(*arrays, cam.cam_params(dev), config=cfg)
        img = torch.clamp(out["render"], 0.0, 1.0)  # a new tensor: the next replay overwrites `out`
        gt = torch.as_tensor(cam.image, device=dev)
        mask = torch.as_tensor(cam.alpha_mask, device=dev) if cam.alpha_mask is not None else None
        if mask is not None:
            # reference multiplies the alpha mask into both images before all
            # metrics (eval.py:291-336)
            img = img * mask[None]
            gt = gt * mask[None]
        p = float(psnr(img, gt, mask))
        s = float(ssim(img, gt))
        l = float(lpips_fn(img, gt)) if lpips_fn else float("nan")
        results.append({"name": cam.info.image_name, "psnr": p, "ssim": s, "lpips": l})
        if save_images:
            save_png(os.path.join(out_dir, name, "renders", f"{i:05d}.png"), img)
            save_png(os.path.join(out_dir, name, "gt", f"{i:05d}.png"), gt)
    if results:
        mean = {
            k: float(np.mean([r[k] for r in results])) for k in ("psnr", "ssim", "lpips")
        }
    else:
        mean = {}
    return {"per_view": results, "mean": mean}


def main(argv=None):
    parser = argparse.ArgumentParser("hidegs_tpu_torch eval")
    add_group(parser, ModelConfig())
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--no_images", action="store_true")
    parser.add_argument("--lpips_weights", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cli_model = extract_group(args, ModelConfig)
    model_cfg, pipe_cfg, _ = get_combined_args(cli_model.model_path, cli_model)

    from hidegs_tpu_torch.data.scene import load_scene

    scene = load_scene(
        model_cfg.source_path,
        images=model_cfg.images,
        eval_split=model_cfg.eval,
        resolution=model_cfg.resolution,
    )
    it = args.iteration
    ckpt_root = os.path.join(model_cfg.model_path, "point_cloud")
    if it == -1:
        it = find_latest_iteration(ckpt_root)
    ply = os.path.join(ckpt_root, f"iteration_{it}", "point_cloud.ply")
    arrays = load_gaussian_state_from_ply(ply, device=dev)
    cfg = RasterConfig(backend=port_backend(pipe_cfg.raster_backend), tile=pipe_cfg.tile,
                       max_instances=pipe_cfg.max_instances)

    from hidegs_tpu_torch.train.lpips import default_lpips_fn

    weights = args.lpips_weights or default_lpips_weights()
    lpips_fn, lpips_kind = default_lpips_fn(weights, device=dev)

    out_dir = os.path.join(model_cfg.model_path, f"eval_{it}")
    report = {"lpips_kind": lpips_kind}
    render_fn = serving_render(dev, cfg)  # both sets replay its graphs
    if not args.skip_train:
        report["train"] = evaluate_set(
            "train", scene.train_cameras, arrays, cfg, out_dir, lpips_fn, not args.no_images,
            render_fn=render_fn,
        )
    if not args.skip_test and len(scene.test_cameras):
        report["test"] = evaluate_set(
            "test", scene.test_cameras, arrays, cfg, out_dir, lpips_fn, not args.no_images,
            render_fn=render_fn,
        )
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(report, f, indent=1)
    print("lpips_kind", lpips_kind)
    for k, v in report.items():
        if isinstance(v, dict):
            print(k, v["mean"])
    return report


if __name__ == "__main__":
    main()
