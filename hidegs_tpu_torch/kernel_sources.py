"""Every CUDA source of the package, by name: the one list of what it
builds. The first launch of any of its kernels builds them all at once
(raster/cuda_blend.py:build, one nvcc process each), so a fresh checkout
waits for one build, not for one a source."""
from __future__ import annotations

from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
SOURCES = {
    "blend_fwd": PACKAGE / "raster" / "csrc" / "blend_fwd.cu",  # raster/cuda_blend.py
    "blend_bwd": PACKAGE / "raster" / "csrc" / "blend_bwd.cu",  # raster/cuda_blend.py
    "preprocess": PACKAGE / "raster" / "csrc" / "preprocess.cu",  # raster/preprocess_autograd.py
    "masked_adam": PACKAGE / "model" / "csrc" / "masked_adam.cu",  # model/adam.py
    "interp": PACKAGE / "hier" / "csrc" / "interp.cu",  # hier/interp_autograd.py
}
