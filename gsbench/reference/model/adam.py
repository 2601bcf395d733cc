# Frozen copy of hidegs_tpu_torch/model/adam.py:1-92 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Visibility-masked sparse Adam.

Port of hidegs_tpu/model/adam.py: a dense masked update (the reference's
OurAdam gathers the visible rows, updates and scatters back). Moments and
parameters of rows outside the mask stay exactly as they were, including
the bias-correction step count, which is therefore kept per row. The update
is functional: it returns new tensors and leaves its inputs untouched.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gsbench.reference.model.gaussians import GaussianParams


class AdamState(NamedTuple):
    m: GaussianParams  # first moments, same leaves as the params
    v: GaussianParams  # second moments
    step: torch.Tensor  # (C,) int32 per-row step count


def init_adam(params: GaussianParams) -> AdamState:
    C = params.xyz.shape[0]
    return AdamState(
        m=GaussianParams(*(torch.zeros_like(p) for p in params)),
        v=GaussianParams(*(torch.zeros_like(p) for p in params)),
        step=torch.zeros((C,), dtype=torch.int32, device=params.xyz.device),
    )


def _bcast(vec: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a (C,) vector over the trailing dims of `like`."""
    return vec.reshape(vec.shape + (1,) * (like.ndim - 1))


def masked_adam_update(
    params: GaussianParams,
    grads: GaussianParams,
    opt: AdamState,
    lr: GaussianParams,
    visible: torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
):
    """One sparse-Adam step over the `visible` mask. `lr` holds one scalar
    learning rate per leaf (a float or a 0-d tensor). Returns (new_params,
    new_opt); eps is OurAdam's 1e-15."""
    step = opt.step + visible.to(torch.int32)
    t = torch.clamp(step, min=1).to(torch.float32)
    c1 = 1.0 - b1 ** t  # (C,) per-row bias correction
    c2 = 1.0 - b2 ** t

    new_p, new_m, new_v = {}, {}, {}
    for name in GaussianParams._fields:
        p, g = getattr(params, name), getattr(grads, name)
        m, v = getattr(opt.m, name), getattr(opt.v, name)
        msk = _bcast(visible, p)
        m_new = torch.where(msk, b1 * m + (1.0 - b1) * g, m)
        v_new = torch.where(msk, b2 * v + (1.0 - b2) * (g * g), v)
        m_hat = m_new / _bcast(c1, p)
        v_hat = v_new / _bcast(c2, p)
        upd = getattr(lr, name) * m_hat / (torch.sqrt(v_hat) + eps)
        new_p[name] = torch.where(msk, p - upd, p)
        new_m[name] = m_new
        new_v[name] = v_new
    return GaussianParams(**new_p), AdamState(m=GaussianParams(**new_m), v=GaussianParams(**new_v), step=step)


def reset_opacity_moments(opt: AdamState) -> AdamState:
    """Zero the opacity leaf's moments, as the reference's reset_opacity
    replaces that optimizer tensor with zeroed state."""
    return opt._replace(
        m=opt.m._replace(opacity=torch.zeros_like(opt.m.opacity)),
        v=opt.v._replace(opacity=torch.zeros_like(opt.v.opacity)),
    )


def reset_moments_at(opt: AdamState, mask: torch.Tensor) -> AdamState:
    """Zero the Adam state of the rows in `mask` (the padded-buffer form of
    the reference's optimizer surgery on densify and prune)."""

    def zero(leaf):
        return torch.where(_bcast(mask, leaf), torch.zeros_like(leaf), leaf)

    return AdamState(
        m=GaussianParams(*(zero(x) for x in opt.m)),
        v=GaussianParams(*(zero(x) for x in opt.v)),
        step=torch.where(mask, torch.zeros_like(opt.step), opt.step),
    )
