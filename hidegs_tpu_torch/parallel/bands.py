"""Space-parallel rendering: split one camera into horizontal bands.

Port of hidegs_tpu/parallel/bands.py. A pinhole camera crop is exactly a
principal-point shift, so each rank can render a full-width horizontal
band of the image with an adjusted camera, and the bands concatenate into
the original frame. Bands ride the view-parallel step (each band is one
more "view" on the data dimension), which is how a single very large frame
spreads across cards.
"""
from __future__ import annotations

from dataclasses import replace
from typing import List

import torch

from hidegs_tpu_torch.core.camera_math import CameraParams


def split_camera_bands(cam: CameraParams, n_bands: int) -> List[CameraParams]:
    """Split into `n_bands` equal-height crops (height must divide evenly).

    Cropping rows [r0, r1) of a pinhole image is the same camera with
    cy' = cy - r0 and height' = r1 - r0; the EWA tangent clamp keeps the
    full frame's frustum.
    """
    H = cam.height
    if H % n_bands:
        raise ValueError(f"height {H} not divisible into {n_bands} bands")
    bh = H // n_bands
    return [
        replace(cam, cy=cam.cy - i * bh, height=bh,
                full_height=cam.frustum_height, full_width=cam.frustum_width)
        for i in range(n_bands)
    ]


def assemble_bands(band_images: List[torch.Tensor]) -> torch.Tensor:
    """Concatenate per-band (..., bh, W) outputs back into the full frame."""
    return torch.cat(band_images, dim=-2)
