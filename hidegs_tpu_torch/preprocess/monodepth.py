"""Monocular-depth generation (reference: preprocess/generate_depth.py:24-64).

Port of hidegs_tpu/preprocess/monodepth.py: images are read and the
16-bit PNGs written with utils/png.

The reference shells out to the DPT or Depth-Anything-V2 submodule CLIs and
stores the results as 16-bit inverse-depth PNGs which `data.cameras` then
loads and rescales via depth_params.json. This module keeps the same output
contract with three backends:

  * ``predictor=callable`` — any ``f(rgb[H,W,3] float) -> depth-like [H,W]``
    (used by tests; also the hook for custom models);
  * ``backend="transformers"`` — HuggingFace depth-estimation pipeline
    (e.g. Depth-Anything-V2), gated on locally cached weights (this
    package downloads nothing, so ``local_files_only=True``);
  * ``backend="command"`` — an external CLI invoked per image directory,
    mirroring the reference's subprocess pattern.

Outputs: ``<out_dir>/<stem>.png`` uint16, min-max normalized *inverse* depth
(large value = near), exactly what `data.cameras._load_invdepth` +
`preprocess.depth_scale.fit_image_depth_scale` consume.
"""
from __future__ import annotations

import os
import subprocess
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")


def list_images(images_dir: str) -> list:
    return sorted(
        f
        for f in os.listdir(images_dir)
        if f.lower().endswith(IMAGE_EXTS)
    )


def save_invdepth_png16(inv: np.ndarray, path: str):
    """Min-max normalize to [0, 65535] and store as 16-bit grayscale PNG."""
    from hidegs_tpu_torch.utils.png import write_png

    inv = np.asarray(inv, np.float32)
    lo, hi = float(inv.min()), float(inv.max())
    norm = (inv - lo) / max(hi - lo, 1e-12)
    write_png(path, (norm * 65535.0 + 0.5).astype(np.uint16))


def _hf_predictor(model_name: str, device) -> Callable[[np.ndarray], np.ndarray]:
    """Depth predictor from a locally cached HuggingFace checkpoint, run on
    `device` (a torch.device)."""
    from PIL import Image
    from transformers import pipeline

    pipe = pipeline(
        "depth-estimation",
        model=model_name,
        device=device,
        model_kwargs={"local_files_only": True},
    )

    def predict(rgb: np.ndarray) -> np.ndarray:
        img = Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8))
        out = pipe(img)
        return np.asarray(out["predicted_depth"], np.float32)

    return predict


def generate_depth_maps(
    images_dir: str,
    out_dir: str,
    predictor: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    backend: str = "auto",
    model_name: str = "depth-anything/Depth-Anything-V2-Small-hf",
    command: Optional[Sequence[str]] = None,
    predicts_inverse: bool = True,
    images: Optional[Iterable[str]] = None,
    device="cuda",
) -> list:
    """Run monodepth over a directory; write 16-bit inv-depth PNGs.

    ``predicts_inverse``: DPT/Depth-Anything heads emit relative *inverse*
    depth already; set False for metric-depth models (output is inverted
    before normalization). ``device`` is where the transformers backend
    runs its network (a CUDA device without a card raises); the predictor
    and command backends ignore it. Returns the list of written files.
    """
    os.makedirs(out_dir, exist_ok=True)
    if command is not None or backend == "command":
        if not command:
            raise ValueError("backend='command' requires the command argv list")
        # reference pattern: the external tool consumes the directory pair
        subprocess.run(
            [str(c) for c in command] + [images_dir, out_dir], check=True
        )
        return list_images(out_dir)

    if predictor is None:
        if backend not in ("auto", "transformers"):
            raise ValueError(f"unknown backend {backend!r}")
        from hidegs_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        try:
            predictor = _hf_predictor(model_name, dev)
        except Exception as e:  # no cached weights / no transformers
            raise RuntimeError(
                f"no monodepth predictor available: {model_name} is not "
                f"cached locally and nothing is downloaded "
                f"({e}). Pass predictor= or command=."
            ) from e

    from hidegs_tpu_torch.data.cameras import to_rgb
    from hidegs_tpu_torch.utils.png import read_image

    written = []
    names = list(images) if images is not None else list_images(images_dir)
    for name in names:
        path = os.path.join(images_dir, name)
        rgb = to_rgb(read_image(path), path).astype(np.float32) / 255.0
        pred = np.asarray(predictor(rgb), np.float32)
        if pred.ndim == 3:
            pred = pred[0]
        if not predicts_inverse:
            pred = 1.0 / np.maximum(pred, 1e-6)
        out_path = os.path.join(out_dir, os.path.splitext(name)[0] + ".png")
        save_invdepth_png16(pred, out_path)
        written.append(out_path)
    return written


def generate_depth_for_chunks(
    chunks_dir: str,
    images_dir: str,
    out_subdir: str = "depths",
    **kwargs,
) -> dict:
    """Per-chunk fanout (generate_depth.py's chunk loop): every chunk dir
    gets its own depth folder for the images it references. ``kwargs`` go to
    `generate_depth_maps`, ``device`` among them."""
    from hidegs_tpu_torch.data.colmap import read_model

    results = {}
    for chunk in sorted(os.listdir(chunks_dir)):
        sparse = os.path.join(chunks_dir, chunk, "sparse", "0")
        if not os.path.isdir(sparse):
            continue
        _, imgs, _ = read_model(sparse)
        names = sorted(im.name for im in imgs.values())
        out_dir = os.path.join(chunks_dir, chunk, out_subdir)
        results[chunk] = generate_depth_maps(
            images_dir, out_dir, images=names, **kwargs
        )
    return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Generate monodepth inverse-depth PNGs")
    p.add_argument("--images_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--model", default="depth-anything/Depth-Anything-V2-Small-hf")
    p.add_argument("--command", nargs="*", default=None,
                   help="external CLI argv; gets images_dir/out_dir appended")
    p.add_argument("--device", default="cuda",
                   help="device of the transformers backend (cuda or cpu)")
    a = p.parse_args(argv)
    from hidegs_tpu_torch.device import resolve_device

    device = resolve_device(a.device)
    files = generate_depth_maps(
        a.images_dir, a.out_dir, model_name=a.model, command=a.command,
        device=device,
    )
    print(f"wrote {len(files)} depth maps to {a.out_dir}")


if __name__ == "__main__":
    main()
