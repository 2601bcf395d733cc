"""Per-Gaussian screen-space preprocessing shared by all rasterizer paths.

Port of hidegs_tpu/raster/preprocess.py: frustum cull, EWA projection,
conic, radius, SH→RGB and the planar-geometry channels (camera-space normal
+ plane distance), then the screen-bounds and chunk-AABB culls.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import torch

from hidegs_tpu_torch.core import sh as shm
from hidegs_tpu_torch.core.camera_math import CameraParams
from hidegs_tpu_torch.core.ewa import H_VAR, NEAR_Z, project_gaussians_scq


@dataclass
class PreprocessedGaussians:
    """Screen-space per-Gaussian data consumed by binning and blending."""

    mean2d: torch.Tensor  # (N, 2)
    conic: torch.Tensor  # (N, 3)
    depth: torch.Tensor  # (N,) camera z
    inv_depth: torch.Tensor  # (N,)
    opacity: torch.Tensor  # (N,) post-AA opacity
    rgb: torch.Tensor  # (N, 3)
    normal: torch.Tensor  # (N, 3) camera-space plane normal (zeros if geo off)
    distance: torch.Tensor  # (N,) plane distance (zeros if geo off)
    radius: torch.Tensor  # (N,) int32 pixel radius (0 = culled)
    visible: torch.Tensor  # (N,) bool

    def tensors(self):
        return [getattr(self, f.name) for f in fields(self)]


def preprocess_gaussians(
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
    """means3d (N,3) world; scales (N,3) linear; quats (N,4) wxyz;
    opacities (N,) in [0,1]; shs (N,K,3) or flat (N,3K).

    `colors_precomp` bypasses SH evaluation. `mean2d_offset` is an all-zeros
    (N, 2) tensor whose gradient is the screen-space positional gradient used
    by densification. `boxmin`/`boxmax` ((3,) world) cull gaussians whose
    mean lies outside the box; `box_exempt` ((N,) bool) spares rows from that
    cull. `screen_bounds` is the padded canvas (width, height): fully
    off-screen gaussians are culled.
    """
    proj = project_gaussians_scq(means3d, scales, quats, cam, h_var=h_var, near_z=near_z)
    mean2d = proj.mean2d
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset

    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        dirs = means3d - cam.camera_center
        rgb = shm.sh_to_rgb(active_sh_degree, shs, dirs)

    opac = opacities * proj.aa_factor if antialias else opacities * 1.0

    if render_geo:
        # plane normal = smallest principal axis in the camera frame, flipped
        # toward the camera; distance = |n · p_cam|
        q = quats * torch.rsqrt(torch.sum(quats * quats, dim=-1, keepdim=True) + 1e-12)
        w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        r = [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
        idx = torch.argmin(scales, dim=-1)
        sel = [(idx == j).to(torch.float32) for j in range(3)]
        n_w = [r[i][0] * sel[0] + r[i][1] * sel[1] + r[i][2] * sel[2] for i in range(3)]
        R, t = cam.R, cam.t
        mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
        ncam = [R[i, 0] * n_w[0] + R[i, 1] * n_w[1] + R[i, 2] * n_w[2] for i in range(3)]
        pcam = [R[i, 0] * mx + R[i, 1] * my + R[i, 2] * mz + t[i] for i in range(3)]
        dot = ncam[0] * pcam[0] + ncam[1] * pcam[1] + ncam[2] * pcam[2]
        flip = torch.where(dot > 0, -1.0, 1.0)
        n_cam = torch.stack([ncam[0] * flip, ncam[1] * flip, ncam[2] * flip], dim=-1)
        # with the flip n·p ≤ 0, so |n·p| = −(n·p)
        distance = -flip * dot
    else:
        n_cam = torch.zeros_like(means3d)
        distance = torch.zeros_like(proj.depth)

    visible = proj.in_frustum & (proj.radius > 0)
    if screen_bounds is not None:
        w_pad, h_pad = screen_bounds
        rr = proj.radius
        visible = (
            visible
            & (mean2d[:, 0] + rr > 0.0)
            & (mean2d[:, 0] - rr < w_pad)
            & (mean2d[:, 1] + rr > 0.0)
            & (mean2d[:, 1] - rr < h_pad)
        )
    if boxmin is not None and boxmax is not None:
        inside = torch.all((means3d >= boxmin) & (means3d <= boxmax), dim=-1)
        if box_exempt is not None:
            inside = inside | box_exempt
        visible = visible & inside
    safe_z = torch.clamp(proj.depth, min=near_z)
    zero = torch.zeros_like(proj.depth)
    return PreprocessedGaussians(
        mean2d=mean2d,
        conic=proj.conic,
        depth=proj.depth,
        inv_depth=torch.where(visible, 1.0 / safe_z, zero),
        opacity=torch.where(visible, opac, zero),
        rgb=rgb,
        normal=n_cam,
        distance=distance,
        radius=torch.where(visible, proj.radius, zero).to(torch.int32),
        visible=visible,
    )


class _PermuteRows(torch.autograd.Function):
    """x[min(vidx, N - 1)], whose backward writes each slot's cotangent to
    its own row and drops the padding slots (vidx = N): the JAX package's
    `_permute_rows`, a gather whose transpose is a unique-index scatter.
    Autograd's backward of the plain gather would sum every padding slot
    into row N - 1."""

    @staticmethod
    def forward(ctx, x, vidx):
        ctx.save_for_backward(vidx)
        ctx.num_rows = x.shape[0]
        return x[torch.clamp(vidx, max=x.shape[0] - 1).long()]

    @staticmethod
    def backward(ctx, ct):
        (vidx,) = ctx.saved_tensors
        gx = ct.new_zeros((ctx.num_rows + 1,) + ct.shape[1:])
        gx[vidx.long()] = ct  # padding slots land in row N, which drops
        return gx[:ctx.num_rows], None


def compact_visible(pre: PreprocessedGaussians, budget: int):
    """Pack the VISIBLE rows of `pre` into a (budget, ...) prefix buffer so the
    N-row streams after preprocessing scale with the visible count.

    Static shapes, as in the JAX package: each visible row's slot is the
    exclusive cumsum of the mask, and one int32 scatter builds the slot →
    row map; nothing is read back to the host, so the step that runs it
    can be captured. Rows past `budget` are dropped (highest row indices
    first) and counted in `overflow`. Returns (pre_compact, vidx,
    num_visible, overflow): padding slots carry visible=False / opacity=0 /
    radius=0, and vidx maps each slot to its original row (N on padding
    slots).
    """
    N = pre.visible.shape[0]
    dev = pre.visible.device
    visi = pre.visible.to(torch.int32)
    pos = torch.cumsum(visi, 0, dtype=torch.int32) - visi  # the slot of each visible row
    num_visible = torch.sum(visi)
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    # invisible rows and rows past the budget land in one extra slot, cut off below
    dest = torch.where(pre.visible & (pos < budget), pos, torch.full_like(pos, budget))
    vidx = torch.full((budget + 1,), N, dtype=torch.int32, device=dev)
    vidx = vidx.scatter_(0, dest.long(), rows)[:budget]
    keep = vidx < N

    def take(x):
        return _PermuteRows.apply(x, vidx)

    zero = torch.zeros((budget,), dtype=pre.opacity.dtype, device=dev)
    pre_c = PreprocessedGaussians(
        mean2d=take(pre.mean2d),
        conic=take(pre.conic),
        depth=take(pre.depth),
        inv_depth=take(pre.inv_depth),
        opacity=torch.where(keep, take(pre.opacity), zero),
        rgb=take(pre.rgb),
        normal=take(pre.normal),
        distance=take(pre.distance),
        radius=torch.where(keep, take(pre.radius), torch.zeros_like(vidx)),
        visible=keep,
    )
    overflow = torch.clamp(num_visible - budget, min=0).to(torch.int32)
    return pre_c, vidx, num_visible.to(torch.int32), overflow
