"""Carry weights, training states and cameras between the JAX package's
formats and the port.

Inputs are numpy arrays (never JAX objects): the raw `GaussianParams`
fields of hidegs_tpu/model/gaussians.py (xyz, sh_dc, sh_rest, scaling,
rotation, opacity), the other leaves of a `GaussianState` or `TrainState`,
a camera's leaves, or a 3DGS checkpoint ply. Outputs are tensors on `device`
(default "cuda", which raises without a card). The exporters give numpy
arrays back, keyed as the JAX package's fields, for comparing results.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hidegs_tpu_torch.core.camera_math import CameraParams, make_camera
from hidegs_tpu_torch.core.transforms import normalize
from hidegs_tpu_torch.device import DeviceLike, resolve_device
from hidegs_tpu_torch.model.adam import AdamState
from hidegs_tpu_torch.model.gaussians import GaussianParams, GaussianState
from hidegs_tpu_torch.train.loop import TrainState
from hidegs_tpu_torch.utils.ply import load_gaussian_arrays

RenderInputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _tensor(x, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=dev)


def gaussians_from_jax(
    params: Dict[str, np.ndarray],
    alive: Optional[np.ndarray] = None,
    device: DeviceLike = "cuda",
) -> RenderInputs:
    """Raw parameters → (means3d, scales, quats, opacities, shs), the
    activations of GaussianState (model/gaussians.py:61-77): exp scale,
    normalized quaternion, sigmoid opacity zeroed where not `alive`, and the
    (C, 16, 3) SH tensor."""
    dev = resolve_device(device)
    xyz = _tensor(params["xyz"], dev)
    scales = torch.exp(_tensor(params["scaling"], dev))
    quats = normalize(_tensor(params["rotation"], dev))
    opacities = torch.sigmoid(_tensor(params["opacity"], dev).reshape(-1))
    if alive is not None:
        keep = torch.tensor(np.asarray(alive, bool), device=dev)
        opacities = torch.where(keep, opacities, torch.zeros_like(opacities))
    shs = torch.cat([_tensor(params["sh_dc"], dev)[:, None, :], _tensor(params["sh_rest"], dev)], dim=1)
    return xyz, scales, quats, opacities, shs


def _params(d: Dict[str, np.ndarray], dev) -> GaussianParams:
    return GaussianParams(*(_tensor(d[f], dev) for f in GaussianParams._fields))


def gaussian_state_from_jax(
    params: Dict[str, np.ndarray],
    alive,
    grad_max,
    grad_abs_max,
    max_radii2d,
    protected,
    active_sh_degree,
    spatial_lr_scale,
    device: DeviceLike = "cuda",
) -> GaussianState:
    """A `GaussianState` from the numpy leaves of the JAX package's."""
    dev = resolve_device(device)
    return GaussianState(
        params=_params(params, dev),
        alive=torch.tensor(np.asarray(alive, bool), device=dev),
        grad_max=_tensor(grad_max, dev),
        grad_abs_max=_tensor(grad_abs_max, dev),
        max_radii2d=_tensor(max_radii2d, dev),
        protected=torch.tensor(np.asarray(protected, bool), device=dev),
        active_sh_degree=torch.tensor(int(active_sh_degree), dtype=torch.int32, device=dev),
        spatial_lr_scale=_tensor(spatial_lr_scale, dev),
    )


def train_state_from_jax(
    gaussians: Dict,
    m: Dict[str, np.ndarray],
    v: Dict[str, np.ndarray],
    opt_step,
    exposure,
    exposure_m,
    exposure_v,
    step,
    seed: int = 0,
    device: DeviceLike = "cuda",
):
    """A `TrainState` from numpy leaves: `gaussians` holds the keyword
    arguments of `gaussian_state_from_jax`, `m`/`v`/`opt_step` the Adam
    state. The densify generator is seeded with `seed` (JAX's PRNG key has
    no counterpart)."""
    dev = resolve_device(device)
    return TrainState(
        gaussians=gaussian_state_from_jax(**gaussians, device=dev),
        opt=AdamState(m=_params(m, dev), v=_params(v, dev),
                      step=torch.tensor(np.asarray(opt_step, np.int32), device=dev)),
        exposure=_tensor(exposure, dev),
        exposure_m=_tensor(exposure_m, dev),
        exposure_v=_tensor(exposure_v, dev),
        step=torch.tensor(int(step), dtype=torch.int32, device=dev),
        generator=torch.Generator().manual_seed(seed),
    )


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def gaussian_state_to_numpy(state: GaussianState) -> Dict:
    """The numpy leaves of a `GaussianState`, keyed as the JAX fields
    (`params` as a dict)."""
    out = {f: _numpy(getattr(state, f)) for f in GaussianState._fields if f != "params"}
    out["params"] = {f: _numpy(getattr(state.params, f)) for f in GaussianParams._fields}
    return out


def train_state_to_numpy(ts: TrainState) -> Dict:
    """The numpy leaves of a `TrainState` (the generator left out)."""
    return {
        "gaussians": gaussian_state_to_numpy(ts.gaussians),
        "m": {f: _numpy(getattr(ts.opt.m, f)) for f in GaussianParams._fields},
        "v": {f: _numpy(getattr(ts.opt.v, f)) for f in GaussianParams._fields},
        "opt_step": _numpy(ts.opt.step),
        "exposure": _numpy(ts.exposure),
        "exposure_m": _numpy(ts.exposure_m),
        "exposure_v": _numpy(ts.exposure_v),
        "step": int(ts.step),
    }


def camera_from_jax(
    R, t, fx, fy, cx, cy,
    height: int,
    width: int,
    full_height: int = 0,
    full_width: int = 0,
    device: DeviceLike = "cuda",
) -> CameraParams:
    """A camera from the numpy leaves of a JAX `CameraParams` plus its sizes."""
    cam = make_camera(R, t, fx, fy, cx, cy, height=height, width=width, device=device)
    return CameraParams(
        R=cam.R, t=cam.t, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        height=int(height), width=int(width),
        full_height=int(full_height), full_width=int(full_width),
    )


def load_gaussian_state_from_ply(path: str, device: DeviceLike = "cuda") -> RenderInputs:
    """Checkpoint ply → activated render inputs (the counterpart of
    hidegs_tpu/evaluate.py:load_gaussian_state_from_ply; the quaternion is
    left as stored, since preprocessing normalizes it)."""
    dev = resolve_device(device)
    d = load_gaussian_arrays(path)
    shs = np.concatenate([d["sh_dc"][:, None, :], d["sh_rest"]], axis=1)
    return (
        _tensor(d["xyz"], dev),
        torch.exp(_tensor(d["scaling"], dev)),
        _tensor(d["rotation"], dev),
        _tensor(1.0 / (1.0 + np.exp(-d["opacity"])), dev),
        _tensor(shs, dev),
    )
