"""The preprocess kernels' launchers and the autograd Function around them.

  * csrc/preprocess.cu, `hidegs_preprocess_fwd`: everything
    raster/preprocess.py:preprocess_plain computes, one thread per row;
  * csrc/preprocess.cu, `hidegs_preprocess_bwd`: its backward, the chain
    rule by hand (raster/preprocess.py:preprocess_plain_bwd is the same
    derivation in PyTorch), each row's gradients written by its own thread.

They replace XLA's fusion of hidegs_tpu/raster/preprocess.py:preprocess_gaussians
with core/ewa.py:project_gaussians_scq and core/sh.py, and its jax.vjp.
The source is compiled by `nvcc` for sm_90a into build/kernels/ at first
use, with the blend kernels' flags (raster/cuda_blend.py:build), loaded
with ctypes and launched on PyTorch's current stream. Each launcher checks
its inputs, raises on a failed launch and counts its launches.

`raster.preprocess.preprocess_gaussians` calls `preprocess_cuda` for CUDA
tensors: one forward launch per call, one backward launch when autograd
reaches the node. A CPU tensor here raises; nothing falls back.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from hidegs_tpu_torch import kernel_sources
from hidegs_tpu_torch.core import sh as shm
from hidegs_tpu_torch.core.camera_math import CameraParams
from hidegs_tpu_torch.core.ewa import H_VAR, NEAR_Z
from hidegs_tpu_torch.raster import cuda_blend
from hidegs_tpu_torch.raster.preprocess import PACK_LEN, PreprocessedGaussians, camera_pack

# Launches in this process, one per call of the launcher named beside it.
FWD_LAUNCHES = 0  # launch_preprocess_fwd
BWD_LAUNCHES = 0  # launch_preprocess_bwd

# the kernels' `flags` bits
USE_SH, ANTIALIAS, RENDER_GEO, SCREEN, BOX = 1, 2, 4, 8, 16
FIELDS = ("mean2d", "conic", "depth", "inv_depth", "opacity", "rgb", "normal", "distance", "radius", "visible")
WIDTHS = dict(mean2d=2, conic=3, rgb=3, normal=3)  # the rest are (N,)


@functools.cache
def _fn(symbol: str, n_ptr_head: int, n_int: int, n_float: int, n_ptr_tail: int):
    return cuda_blend.bind(cuda_blend.build(kernel_sources.SOURCES)["preprocess"], symbol, n_ptr_head, n_int,
                           n_float, n_ptr_tail)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def launch_preprocess_fwd(means3d, scales, quats, opacities, color, mean2d_offset, params, mask, boxmin, boxmax,
                          box_exempt, K: int, flags: int, h_var: float, near_z: float, w_pad: float, h_pad: float,
                          out: Dict[str, torch.Tensor]) -> None:
    """Launch the forward kernel once on the current stream, writing the ten
    tensors of `out` (FIELDS). `color` is the (N, 3K) coefficients (flags &
    USE_SH, `mask` their (K,) band mask) or the (N, 3) colors."""
    global FWD_LAUNCHES
    dev = means3d.device
    if dev.type != "cuda":
        raise ValueError(f"the preprocess kernels need CUDA tensors, got {dev}")
    N = means3d.shape[0]
    cuda_blend._check("means3d", means3d, torch.float32, (N, 3), dev)
    cuda_blend._check("scales", scales, torch.float32, (N, 3), dev)
    cuda_blend._check("quats", quats, torch.float32, (N, 4), dev)
    cuda_blend._check("opacities", opacities, torch.float32, (N,), dev)
    cuda_blend._check("color", color, torch.float32, (N, 3 * K if flags & USE_SH else 3), dev)
    cuda_blend._check("params", params, torch.float32, (PACK_LEN,), dev)
    if flags & USE_SH:
        cuda_blend._check("mask", mask, torch.float32, (K,), dev)
    if mean2d_offset is not None:
        cuda_blend._check("mean2d_offset", mean2d_offset, torch.float32, (N, 2), dev)
    if flags & BOX:
        cuda_blend._check("boxmin", boxmin, torch.float32, (3,), dev)
        cuda_blend._check("boxmax", boxmax, torch.float32, (3,), dev)
        if box_exempt is not None:
            cuda_blend._check("box_exempt", box_exempt, torch.bool, (N,), dev)
    for name in FIELDS:
        dtype = {"radius": torch.int32, "visible": torch.bool}.get(name, torch.float32)
        shape = (N, WIDTHS[name]) if name in WIDTHS else (N,)
        cuda_blend._check(name, out[name], dtype, shape, dev)
    fn = _fn("hidegs_preprocess_fwd", 11, 3, 4, 11)
    with torch.cuda.device(dev):
        rc = fn(means3d.data_ptr(), scales.data_ptr(), quats.data_ptr(), opacities.data_ptr(), color.data_ptr(),
                _ptr(mean2d_offset), params.data_ptr(), _ptr(mask), _ptr(boxmin), _ptr(boxmax), _ptr(box_exempt),
                N, K, flags, h_var, near_z, w_pad, h_pad,
                *(out[name].data_ptr() for name in FIELDS), cuda_blend._stream(dev))
    FWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"preprocess_fwd kernel launch failed: cudaError {rc}")


def launch_preprocess_bwd(means3d, scales, quats, opacities, color, params, mask, visible,
                          cts: Dict[str, Optional[torch.Tensor]], K: int, flags: int, h_var: float, near_z: float,
                          grads: Dict[str, Optional[torch.Tensor]]) -> None:
    """Launch the backward kernel once on the current stream. `cts` holds
    the eight float fields' cotangents (None: zero); writes each tensor of
    `grads` (means3d, scales, quats, opacities, color, mean2d_offset; None:
    not wanted)."""
    global BWD_LAUNCHES
    dev = means3d.device
    if dev.type != "cuda":
        raise ValueError(f"the preprocess kernels need CUDA tensors, got {dev}")
    N = means3d.shape[0]
    width = 3 * K if flags & USE_SH else 3
    cuda_blend._check("means3d", means3d, torch.float32, (N, 3), dev)
    cuda_blend._check("scales", scales, torch.float32, (N, 3), dev)
    cuda_blend._check("quats", quats, torch.float32, (N, 4), dev)
    cuda_blend._check("opacities", opacities, torch.float32, (N,), dev)
    cuda_blend._check("color", color, torch.float32, (N, width), dev)
    cuda_blend._check("params", params, torch.float32, (PACK_LEN,), dev)
    cuda_blend._check("visible", visible, torch.bool, (N,), dev)
    if flags & USE_SH:
        cuda_blend._check("mask", mask, torch.float32, (K,), dev)
    for name in FIELDS[:8]:
        if cts[name] is not None:
            shape = (N, WIDTHS[name]) if name in WIDTHS else (N,)
            cuda_blend._check(f"cotangent of {name}", cts[name], torch.float32, shape, dev)
    shapes = dict(means3d=(N, 3), scales=(N, 3), quats=(N, 4), opacities=(N,), color=(N, width), mean2d_offset=(N, 2))
    for name, shape in shapes.items():
        if grads[name] is not None:
            cuda_blend._check(f"gradient of {name}", grads[name], torch.float32, shape, dev)
    fn = _fn("hidegs_preprocess_bwd", 16, 3, 2, 7)
    with torch.cuda.device(dev):
        rc = fn(means3d.data_ptr(), scales.data_ptr(), quats.data_ptr(), opacities.data_ptr(), color.data_ptr(),
                params.data_ptr(), _ptr(mask), visible.data_ptr(), *(_ptr(cts[name]) for name in FIELDS[:8]),
                N, K, flags, h_var, near_z, *(_ptr(grads[name]) for name in shapes), cuda_blend._stream(dev))
    BWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"preprocess_bwd kernel launch failed: cudaError {rc}")


class PreprocessFn(torch.autograd.Function):
    """(means3d, scales, quats, opacities, color, mean2d_offset) → the ten
    fields of PreprocessedGaussians, forward and backward on the kernels.
    Absent cotangents stay absent (no zeros are made for them)."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, opacities, color, mean2d_offset, params, mask, boxmin, boxmax,
                box_exempt, static):
        K, flags, h_var, near_z, w_pad, h_pad = static
        N = means3d.shape[0]
        dev = means3d.device
        ctx.color_shape = color.shape
        rows = [x.contiguous() for x in (means3d, scales, quats, opacities,
                                         color.reshape(N, 3 * K if flags & USE_SH else 3))]
        params, mask, mean2d_offset, boxmin, boxmax, box_exempt = (
            x if x is None else x.contiguous() for x in (params, mask, mean2d_offset, boxmin, boxmax, box_exempt))
        out = {}
        for name in FIELDS:
            dtype = {"radius": torch.int32, "visible": torch.bool}.get(name, torch.float32)
            out[name] = torch.empty((N, WIDTHS[name]) if name in WIDTHS else (N,), dtype=dtype, device=dev)
        launch_preprocess_fwd(*rows, mean2d_offset, params, mask, boxmin, boxmax, box_exempt, K, flags, h_var,
                              near_z, w_pad, h_pad, out)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(out["radius"], out["visible"])
        ctx.save_for_backward(*rows, params, mask, out["visible"])
        ctx.static = static
        ctx.has_offset = mean2d_offset is not None
        return tuple(out[name] for name in FIELDS)

    @staticmethod
    def backward(ctx, *cts):
        means3d, scales, quats, opacities, color, params, mask, visible = ctx.saved_tensors
        K, flags, h_var, near_z, _, _ = ctx.static
        ct = {name: (None if g is None else g.contiguous()) for name, g in zip(FIELDS[:8], cts[:8])}
        wanted = ctx.needs_input_grad
        if all(g is None for g in ct.values()) or not any(wanted[:6]):
            return (None,) * 12
        grads = {name: (torch.empty_like(x) if wanted[j] else None)
                 for j, (name, x) in enumerate(zip(("means3d", "scales", "quats", "opacities", "color"),
                                                   (means3d, scales, quats, opacities, color)))}
        grads["mean2d_offset"] = (torch.empty((means3d.shape[0], 2), dtype=torch.float32, device=means3d.device)
                                  if ctx.has_offset and wanted[5] and ct["mean2d"] is not None else None)
        launch_preprocess_bwd(means3d, scales, quats, opacities, color, params, mask, visible, ct, K, flags, h_var,
                              near_z, grads)
        d_color = None if grads["color"] is None else grads["color"].view(ctx.color_shape)
        return (grads["means3d"], grads["scales"], grads["quats"], grads["opacities"], d_color,
                grads["mean2d_offset"]) + (None,) * 6


def preprocess_cuda(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    cam: CameraParams,
    active_sh_degree=shm.MAX_SH_DEGREE,
    render_geo: bool = False,
    colors_precomp: Optional[torch.Tensor] = None,
    antialias: bool = True,
    h_var: float = H_VAR,
    near_z: float = NEAR_Z,
    mean2d_offset: Optional[torch.Tensor] = None,
    boxmin: Optional[torch.Tensor] = None,
    boxmax: Optional[torch.Tensor] = None,
    box_exempt: Optional[torch.Tensor] = None,
    screen_bounds: Optional[tuple] = None,
) -> PreprocessedGaussians:
    """`preprocess_gaussians` on the kernels (arguments as there): one
    forward launch, differentiable through PreprocessFn. Reads nothing back
    to the host, so a graph capture can record it."""
    dev = means3d.device
    if dev.type != "cuda":
        raise ValueError(f"the preprocess kernels need CUDA tensors, got {dev}")
    flags = (ANTIALIAS if antialias else 0) | (RENDER_GEO if render_geo else 0)
    if colors_precomp is None:
        K = shs.shape[-1] // 3 if shs.ndim == means3d.ndim else shs.shape[-2]
        mask = shm.degree_mask(active_sh_degree, K, device=dev)
        color, flags = shs, flags | USE_SH
    else:
        K, mask, color = 0, None, colors_precomp
    w_pad = h_pad = 0.0
    if screen_bounds is not None:
        w_pad, h_pad = (float(b) for b in screen_bounds)
        flags |= SCREEN
    if boxmin is not None and boxmax is not None:
        flags |= BOX
    else:
        boxmin = boxmax = box_exempt = None
    static = (K, flags, float(h_var), float(near_z), w_pad, h_pad)
    outs = PreprocessFn.apply(means3d, scales, quats, opacities, color, mean2d_offset, camera_pack(cam), mask,
                              boxmin, boxmax, box_exempt, static)
    return PreprocessedGaussians(*outs)
