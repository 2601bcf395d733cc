# Frozen copy of hidegs_tpu_torch/device.py:1-24 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Device selection: explicit, with no automatic fallback.

Functions that create tensors take a `device` argument that defaults to
"cuda". Without a card that default raises instead of quietly moving the
work to the CPU; callers that want the CPU (the tests) ask for it.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return `device` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
