"""Per-image appearance models.

Port of hidegs_tpu/model/appearance.py. Two mechanisms, mirroring the
reference:
  * full 3x4 exposure matrices per image (gaussian_model.py:284-287,
    render:181-184) — implemented in train/loop.py (TrainState.exposure);
  * `AppModel`: per-image (a, b) gain/offset pair with its own Adam
    (scene/app_model.py:9-32) — PGSR-style alternative, kept for parity.

The update is functional, as in the JAX package: it returns new tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from hidegs_tpu_torch.device import DeviceLike, resolve_device


class AppModel(NamedTuple):
    a: torch.Tensor  # (num_images,) multiplicative (stored as exp(a))
    b: torch.Tensor  # (num_images,) additive
    m_a: torch.Tensor
    v_a: torch.Tensor
    m_b: torch.Tensor
    v_b: torch.Tensor
    step: torch.Tensor  # () int32


def init_app_model(num_images: int, device: DeviceLike = "cuda") -> AppModel:
    dev = resolve_device(device)

    def zeros():
        return torch.zeros((num_images,), dtype=torch.float32, device=dev)

    return AppModel(a=zeros(), b=zeros(), m_a=zeros(), v_a=zeros(), m_b=zeros(), v_b=zeros(),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def apply_appearance(app: AppModel, image: torch.Tensor, idx) -> torch.Tensor:
    """image (3,H,W) → exp(a)·image + b for image `idx`."""
    return torch.exp(app.a[idx]) * image + app.b[idx]


def appearance_update(
    app: AppModel, grad_a, grad_b, idx, lr: float = 1e-3,
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
) -> AppModel:
    """Sparse Adam step on one image's (a, b) (app_model.py:20-27)."""
    step = app.step + 1
    t = step.to(torch.float32)

    def upd(p, g, m, v):
        m2, v2, p2 = m.clone(), v.clone(), p.clone()
        m2[idx] = b1 * m[idx] + (1 - b1) * g
        v2[idx] = b2 * v[idx] + (1 - b2) * g * g
        mh = m2[idx] / (1 - b1**t)
        vh = v2[idx] / (1 - b2**t)
        p2[idx] = p[idx] + (-lr * mh / (torch.sqrt(vh) + eps))
        return p2, m2, v2

    a2, ma2, va2 = upd(app.a, grad_a, app.m_a, app.v_a)
    b2_, mb2, vb2 = upd(app.b, grad_b, app.m_b, app.v_b)
    return AppModel(a=a2, b=b2_, m_a=ma2, v_a=va2, m_b=mb2, v_b=vb2, step=step)
