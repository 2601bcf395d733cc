"""Mask preparation utilities.

Port of hidegs_tpu/preprocess/masks.py: masks are read and written with
utils/png (Pillow only for formats it does not decode, such as JPEG).

Equivalents of preprocess/black_mask.py (mask out near-black border regions
that rectification introduces) and preprocess/make_mask_uint8.py (normalize
arbitrary mask images to single-channel uint8 {0,255}).
"""
from __future__ import annotations

import os

import numpy as np


def black_border_mask(image: np.ndarray, threshold: float = 8.0 / 255.0) -> np.ndarray:
    """(H, W, 3) float or uint8 image → (H, W) uint8 mask that zeroes pixels
    whose every channel is ≤ threshold (the black fill left by undistortion)."""
    img = image.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    black = (img <= threshold).all(axis=-1)
    return np.where(black, 0, 255).astype(np.uint8)


def normalize_mask(mask: np.ndarray) -> np.ndarray:
    """Any mask image (bool / float / rgb / 16-bit) → (H, W) uint8 {0, 255}."""
    m = np.asarray(mask)
    if m.ndim == 3:
        m = m[..., 0]
    if m.dtype == bool:
        return np.where(m, 255, 0).astype(np.uint8)
    mf = m.astype(np.float32)
    hi = mf.max() if mf.size else 1.0
    scale = 1.0 if hi <= 1.0 else (255.0 if hi <= 255 else 65535.0)
    return np.where(mf / scale > 0.5, 255, 0).astype(np.uint8)


def prepare_masks(
    images_dir: str,
    masks_dir: str,
    from_black_border: bool = False,
    threshold: float = 8.0 / 255.0,
) -> int:
    """Batch conversion: write a uint8 mask per image into `masks_dir`.

    With from_black_border, masks are derived from the images themselves
    (black_mask.py flow); otherwise existing files in masks_dir are
    normalized in place (make_mask_uint8.py flow). Returns #masks written."""
    from hidegs_tpu_torch.data.cameras import to_rgb
    from hidegs_tpu_torch.utils.png import read_image, write_png

    os.makedirs(masks_dir, exist_ok=True)
    n = 0
    if from_black_border:
        for name in sorted(os.listdir(images_dir)):
            if not name.lower().endswith((".png", ".jpg", ".jpeg")):
                continue
            path = os.path.join(images_dir, name)
            img = to_rgb(read_image(path), path)
            mask = black_border_mask(img, threshold)
            out = os.path.splitext(name)[0] + ".png"
            write_png(os.path.join(masks_dir, out), mask)
            n += 1
    else:
        for name in sorted(os.listdir(masks_dir)):
            if not name.lower().endswith((".png", ".jpg", ".jpeg")):
                continue
            p = os.path.join(masks_dir, name)
            mask = normalize_mask(read_image(p))
            write_png(os.path.splitext(p)[0] + ".png", mask)
            n += 1
    return n
