# Frozen copy of hidegs_tpu_torch/model/schedules.py:1-74 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Learning-rate schedules and per-leaf learning rates.

Port of hidegs_tpu/model/schedules.py: the reference's log-linear schedule
with an optional sine-ramped delay (get_expon_lr_func), and the six
optimizer groups' rates as a GaussianParams of scalars. Works on a step that
is a Python int or a tensor on the device (no host sync).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from gsbench.reference.model.gaussians import GaussianParams


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    # a fill, not a host-to-device copy, which would wait for the device
    return torch.full((), x, dtype=torch.float32, device=device)


def expon_lr(step, lr_init: float, lr_final: float, max_steps: int,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0) -> torch.Tensor:
    """Log-lerp from lr_init to lr_final over max_steps; with
    lr_delay_steps > 0, a sine ramp from lr_delay_mult to 1 over the first
    lr_delay_steps. A 0-d float32 tensor on the step's device."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    step = _f32(step, dev)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    # logs taken in float32, as jnp.log of a Python float is
    log_lerp = torch.exp(torch.log(_f32(lr_init, dev)) * (1 - t) + torch.log(_f32(lr_final, dev)) * t)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    out = delay_rate * log_lerp
    return out if lr_init > 0.0 else torch.zeros_like(out)


@dataclass(frozen=True)
class LRConfig:
    """Defaults of OptimizationParams (the reference's arguments/__init__.py)."""

    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    feature_rest_div: float = 20.0
    opacity_lr: float = 5e-2
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    exposure_lr_init: float = 1e-3
    exposure_lr_final: float = 1e-4


def lr_tree(step, cfg: LRConfig, spatial_lr_scale) -> GaussianParams:
    """Per-leaf scalar learning rates at `step`."""
    pos_lr = expon_lr(
        step, cfg.position_lr_init, cfg.position_lr_final, cfg.position_lr_max_steps,
        lr_delay_mult=cfg.position_lr_delay_mult, lr_delay_steps=0,
    ) * spatial_lr_scale
    return GaussianParams(
        xyz=pos_lr,
        sh_dc=cfg.feature_lr,
        sh_rest=cfg.feature_lr / cfg.feature_rest_div,
        scaling=cfg.scaling_lr,
        rotation=cfg.rotation_lr,
        opacity=cfg.opacity_lr,
    )
