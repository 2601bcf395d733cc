# Frozen copy of hidegs_tpu_torch/hier/interp.py:1-414 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Hierarchy render path: parent/child interpolation and the skybox tail.

Port of hidegs_tpu/hier/interp.py, the reference's `render_post` with
interp_python=True (gaussian_renderer/__init__.py:217-324): the attributes
of each selected gaussian are lerped with its parent's by the smooth LOD
weight t (the rotation sign-aligned first), the skybox tail is appended with
t=1, and the LOD alpha correction α ← t·α + (1−t)·(1−(1−α)^(1/kids))
(forward.cu:547-556) is applied to the interpolated opacity. The result
feeds the ordinary `render`; as in the JAX package, the reference's
hand-written hierarchy backward (backward.cu:459-495) is autograd of these
gathers and lerps.

The gathers read one (P, 59) attribute matrix (`pack_attributes`: means,
scales, quats, opacity and the 48 SH values of each gaussian). The JAX
version concatenates it inside every call, ~470 MB per frame at 2M points;
`AdaptiveHierRenderer` builds it once per hierarchy and passes it in.

On a card the renderer replays each frame as a CUDA graph
(`CompiledLodFrame`, the counterpart of JAX's one jit dispatch per frame).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from gsbench.reference.hier.io import Hierarchy
from gsbench.reference.hier.lod import (
    HierCut,
    PackedHier,
    cut_size_packed,
    expand_packed,
    expand_to_size,
    hierarchy_opacity_correction,
    pack_hierarchy,
)
from gsbench.reference.raster.api import RasterConfig, render, round_budget


class InterpolatedGaussians(NamedTuple):
    means3d: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    shs: torch.Tensor


def hierarchy_tensors(h: Hierarchy, device):
    """(nodes, boxes, means3d, scales, quats, opacities, shs) of `h` on
    `device`, scales activated (the file stores their logs)."""
    def tensor(x):
        return torch.as_tensor(x, device=device)

    return (tensor(h.nodes), tensor(h.boxes), tensor(h.pos), torch.exp(tensor(h.scale)), tensor(h.rot),
            tensor(h.alpha), tensor(h.shs))


def pack_attributes(means3d, scales, quats, opacities, shs) -> torch.Tensor:
    """(P, 11 + 48) rows [means(3) scales(3) quats(4) opacity(1) shs(48)]:
    the matrix `interpolate_cut` gathers from."""
    P = means3d.shape[0]
    return torch.cat([means3d, scales, quats, opacities[:, None], shs.reshape(P, -1)], dim=-1)


def interpolate_cut(
    cut: HierCut,
    means3d: torch.Tensor,  # (P, 3)
    scales: torch.Tensor,  # (P, 3) ACTIVATED
    quats: torch.Tensor,  # (P, 4)
    opacities: torch.Tensor,  # (P,) ACTIVATED
    shs: torch.Tensor,  # (P, 16, 3)
    skybox_count: int = 0,
    attrs: Optional[torch.Tensor] = None,
) -> InterpolatedGaussians:
    """The (B [+ skybox],) rendering arrays of one LOD cut.

    Invalid budget slots get opacity 0 (render culls them) and gather row
    (slot mod P), where the JAX package clamps them all to row P - 1: the
    gathers' backward sums each run of equal indices in one thread, and a
    million padding slots on one row cost ~0.8 s per gather on an H100.
    Skybox points are the LAST `skybox_count` gaussians (the reference keeps
    them at the tail, render_post:300-313). `attrs` is `pack_attributes` of
    the five arrays, built here when not given.
    """
    P = means3d.shape[0]
    if attrs is None:
        attrs = pack_attributes(means3d, scales, quats, opacities, shs)
    spread = torch.arange(cut.valid.shape[0], device=cut.valid.device) % P
    ri = torch.where(cut.valid, torch.clamp(cut.render_indices, max=P - 1).long(), spread)
    pi = torch.where(cut.valid, torch.clamp(cut.parent_indices, max=P - 1).long(), spread)
    t = cut.ts[:, None]
    row_c = attrs[ri]
    row_p = attrs[pi]
    sh_shape = shs.shape[1:]
    sh_dim = sh_shape[0] * sh_shape[1]

    m = t * row_c[:, 0:3] + (1 - t) * row_p[:, 0:3]
    s = t * row_c[:, 3:6] + (1 - t) * row_p[:, 3:6]
    sh = (t[..., None] * row_c[:, 11:11 + sh_dim].reshape(-1, *sh_shape)
          + (1 - t[..., None]) * row_p[:, 11:11 + sh_dim].reshape(-1, *sh_shape))

    rot_c = row_c[:, 6:10]
    rot_p = row_p[:, 6:10]
    dot = torch.sum(rot_c * rot_p, dim=-1, keepdim=True)
    sign = torch.where(dot < 0, -torch.ones_like(dot), torch.ones_like(dot))
    q = t * rot_c + (1 - t) * rot_p * sign

    op = cut.ts * row_c[:, 10] + (1 - cut.ts) * row_p[:, 10]
    op = hierarchy_opacity_correction(op, cut.ts, cut.kids)
    op = torch.where(cut.valid, op, torch.zeros_like(op))

    if skybox_count > 0:
        sky = slice(P - skybox_count, P)
        m = torch.cat([m, means3d[sky]])
        s = torch.cat([s, scales[sky]])
        q = torch.cat([q, quats[sky]])
        sh = torch.cat([sh, shs[sky]])
        op = torch.cat([op, opacities[sky]])
    return InterpolatedGaussians(m, s, q, op, sh)


def render_hierarchy(
    cut: HierCut,
    means3d,
    scales,
    quats,
    opacities,
    shs,
    cam,
    skybox_count: int = 0,
    background: Optional[torch.Tensor] = None,
    render_geo: bool = False,
    config: Optional[RasterConfig] = None,
    active_sh_degree: int = 3,
    attrs: Optional[torch.Tensor] = None,
):
    """render_post: interpolate the cut, then the ordinary render."""
    ig = interpolate_cut(cut, means3d, scales, quats, opacities, shs, skybox_count, attrs)
    return render(*ig, cam, background=background, active_sh_degree=active_sh_degree,
                  render_geo=render_geo, config=config or RasterConfig())


def render_coarse(
    nodes,
    boxes,
    means3d,
    scales,
    quats,
    opacities,
    shs,
    cam,
    coarse_target_size: float = 0.1,
    budget: int = 1 << 16,
    **kwargs,
):
    """Coarse render: a large-granularity LOD cut, the scaffold/coarse-opt
    path (render_coarse, gaussian_renderer/__init__.py:376-488) as the
    hierarchy render at a coarse target size."""
    cut = expand_to_size(nodes, boxes, coarse_target_size, cam.camera_center, budget=budget,
                         num_points=int(means3d.shape[0]))
    return render_hierarchy(cut, means3d, scales, quats, opacities, shs, cam, **kwargs)


def fused_lod_frame(
    packed: PackedHier,
    target_size,
    cam,
    means3d, scales, quats, opacities, shs,
    budget: int,
    num_points: int,
    skybox_count: int = 0,
    background=None,
    config: Optional[RasterConfig] = None,
    active_sh_degree: int = 3,
    render_geo: bool = False,
    attrs: Optional[torch.Tensor] = None,
):
    """Cut select, interpolation and raster of one frame in one call, with
    no host read; the render dict gains `num_selected`. (The JAX version is
    one jit dispatch; the reference's interactive loop one CUDA stream.)"""
    cut = expand_packed(packed, target_size, cam.camera_center, budget=budget, num_points=num_points)
    out = dict(render_hierarchy(
        cut, means3d, scales, quats, opacities, shs, cam, skybox_count=skybox_count,
        background=background, render_geo=render_geo, config=config,
        active_sh_degree=active_sh_degree, attrs=attrs))
    out["num_selected"] = cut.num_selected
    return out


# frozen copy: lod_frame_key, CompiledLodFrame and AdaptiveHierRenderer (the program's
# budgets, count cache and capture) removed; the reference selects each cut anew
