# Frozen copy of hidegs_tpu_torch/raster/preprocess.py:1-497 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Per-Gaussian screen-space preprocessing shared by all rasterizer paths.

Port of hidegs_tpu/raster/preprocess.py: frustum cull, EWA projection,
conic, radius, SH→RGB and the planar-geometry channels (camera-space normal
+ plane distance), then the screen-bounds and chunk-AABB culls.

`preprocess_gaussians` runs where its inputs lie: on CUDA tensors the
hand-written kernels of csrc/preprocess.cu, forward and backward, through
the autograd Function of raster/preprocess_autograd.py; on CPU tensors
`preprocess_plain` under autograd. `preprocess_plain_bwd` is the kernels'
closed-form backward in PyTorch, term for term: the derivation the CPU
tests hold against autograd of `preprocess_plain` and against JAX.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import torch

from gsbench.reference.core import sh as shm
from gsbench.reference.core.camera_math import CameraParams
from gsbench.reference.core.ewa import H_VAR, NEAR_Z, project_gaussians_scq


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

    On CUDA tensors the kernels run (one forward launch, and one backward
    launch when autograd reaches it) or the call raises; on CPU tensors
    `preprocess_plain` runs.
    """
    kw = dict(active_sh_degree=active_sh_degree, render_geo=render_geo, colors_precomp=colors_precomp,
              antialias=antialias, h_var=h_var, near_z=near_z, mean2d_offset=mean2d_offset, boxmin=boxmin,
              boxmax=boxmax, box_exempt=box_exempt, screen_bounds=screen_bounds)
    # frozen copy: the plain preprocess on every device (the kernels' branch removed)
    return preprocess_plain(means3d, scales, quats, opacities, shs, cam, **kw)


def preprocess_plain(
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
    off-screen gaussians are culled. The plain PyTorch version of the
    kernel `preprocess_fwd` (arguments as `preprocess_gaussians`).
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


# The kernels' camera parameters, one float32 vector on the camera's device:
# R row-major, t, fx, fy, cx, cy, the tangent clamp's bounds and the camera
# center, each computed as preprocess_plain computes it.
PACK_R, PACK_T, PACK_F, PACK_C, PACK_LIM, PACK_CENTER, PACK_LEN = 0, 9, 12, 14, 16, 20, 23


def camera_pack(cam: CameraParams) -> torch.Tensor:
    """(PACK_LEN,) float32: the camera as the kernels read it. Device ops
    only (no host copy), so a graph capture can record it."""
    tan_half_x = torch.div(cam.frustum_width, 2.0 * cam.fx)
    tan_half_y = torch.div(cam.frustum_height, 2.0 * cam.fy)
    scalars = torch.stack([cam.fx, cam.fy, cam.cx, cam.cy, -1.3 * tan_half_x, 1.3 * tan_half_x,
                           -1.3 * tan_half_y, 1.3 * tan_half_y])
    parts = (cam.R.reshape(9), cam.t.reshape(3), scalars, cam.camera_center.reshape(3))
    return torch.cat([x.to(torch.float32) for x in parts])


def _quat_rotation(quats):
    """Unit quaternion components and the rotation's rows, as lists of (N,)."""
    n2 = torch.sum(quats * quats, dim=-1, keepdim=True)
    inv = torch.rsqrt(n2 + 1e-12)
    w, x, y, z = (quats * inv).unbind(-1)
    r = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return (w, x, y, z), r, inv[:, 0]


def _quat_rotation_bwd(quats, wxyz, inv, dr):
    """d quats of the rotation rows' cotangents `dr` (3x3 lists of (N,)),
    through the unit quaternion and its rsqrt normalisation."""
    w, x, y, z = wxyz
    dw = 2 * (-z * dr[0][1] + y * dr[0][2] + z * dr[1][0] - x * dr[1][2] - y * dr[2][0] + x * dr[2][1])
    dx = 2 * (y * dr[0][1] + z * dr[0][2] + y * dr[1][0] - 2 * x * dr[1][1] - w * dr[1][2]
              + z * dr[2][0] + w * dr[2][1] - 2 * x * dr[2][2])
    dy = 2 * (-2 * y * dr[0][0] + x * dr[0][1] + w * dr[0][2] + x * dr[1][0] + z * dr[1][2]
              - w * dr[2][0] + z * dr[2][1] - 2 * y * dr[2][2])
    dz = 2 * (-2 * z * dr[0][0] - w * dr[0][1] + x * dr[0][2] + w * dr[1][0] - 2 * z * dr[1][1]
              + y * dr[1][2] + x * dr[2][0] + y * dr[2][1])
    return _normalize_bwd(quats, inv, torch.stack([dw, dx, dy, dz], dim=-1))


def _normalize_bwd(v, inv, dn):
    """d v of n = v · rsqrt(Σ v² + eps), from d n: the direct term, then
    rsqrt's -0.5·inv³ through Σ v²."""
    d_inv = torch.sum(dn * v, dim=-1)
    d_n2 = -0.5 * d_inv * (inv * inv * inv)
    return dn * inv[:, None] + 2 * v * d_n2[:, None]


def _sh_basis_grad(x, y, z):
    """∂ basis_k / ∂ (x, y, z) of core/sh.py's 16 functions, as three lists."""
    C1, C2, C3 = shm.C1, shm.C2, shm.C3
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    gx = [zero, zero, zero, -C1 * one, C2[0] * y, zero, -2 * C2[2] * x, C2[3] * z, 2 * C2[4] * x,
          6 * C3[0] * xy, C3[1] * yz, -2 * C3[2] * xy, -6 * C3[3] * xz, C3[4] * (4 * zz - 3 * xx - yy),
          2 * C3[5] * xz, 3 * C3[6] * (xx - yy)]
    gy = [zero, -C1 * one, zero, zero, C2[0] * x, C2[1] * z, -2 * C2[2] * y, zero, -2 * C2[4] * y,
          3 * C3[0] * (xx - yy), C3[1] * xz, C3[2] * (4 * zz - xx - 3 * yy), -6 * C3[3] * yz,
          -2 * C3[4] * xy, -2 * C3[5] * yz, -6 * C3[6] * xy]
    gz = [zero, zero, C1 * one, zero, zero, C2[1] * y, 4 * C2[2] * z, C2[3] * x, zero,
          zero, C3[1] * xy, 8 * C3[2] * yz, C3[3] * (6 * zz - 3 * xx - 3 * yy), 8 * C3[4] * xz,
          C3[5] * (xx - yy), zero]
    return gx, gy, gz


def preprocess_plain_bwd(
    cts: dict,
    visible: torch.Tensor,
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
) -> dict:
    """The closed-form backward of `preprocess_plain`, term for term as the
    kernel `preprocess_bwd` computes it: the forward's intermediates
    recomputed per row, then the chain rule by hand with torch autograd's
    rules at every tie (clamps pass their bounds, `where` masks, argmin
    takes the first minimum, sqrt's and rsqrt's derivatives as torch
    takes them).

    `cts` maps the eight float fields of PreprocessedGaussians to their
    cotangents; a missing or None field is a zero cotangent. `visible` is
    the forward's mask. Returns the gradients by input name: means3d,
    scales, quats, opacities, shs or colors_precomp (whichever the forward
    read), and mean2d_offset when it was given.
    """
    ct = {k: v for k, v in cts.items() if v is not None}
    P = camera_pack(cam).unbind(0)
    R = [[P[PACK_R + 3 * i + j] for j in range(3)] for i in range(3)]
    t = P[PACK_T:PACK_T + 3]
    fx, fy, cx, cy = P[PACK_F], P[PACK_F + 1], P[PACK_C], P[PACK_C + 1]
    lox, hix, loy, hiy = P[PACK_LIM:PACK_LIM + 4]
    zero = torch.zeros_like(opacities)
    vis = visible

    # the forward's intermediates
    mx, my, mz = means3d.unbind(-1)
    pc = [R[i][0] * mx + R[i][1] * my + R[i][2] * mz + t[i] for i in range(3)]
    px, py, pz = pc
    zs = torch.clamp(pz, min=near_z)
    vx, vy = px / zs, py / zs
    txz = torch.minimum(torch.maximum(vx, lox), hix)
    tyz = torch.minimum(torch.maximum(vy, loy), hiy)
    j00, j11 = fx / zs, fy / zs
    j02, j12 = -fx * txz / zs, -fy * tyz / zs
    A = [[j00 * R[0][k] + j02 * R[2][k] for k in range(3)],
         [j11 * R[1][k] + j12 * R[2][k] for k in range(3)]]
    wxyz, r, qinv = _quat_rotation(quats)
    s = scales.unbind(-1)
    T = [[A[a][0] * r[0][j] + A[a][1] * r[1][j] + A[a][2] * r[2][j] for j in range(3)] for a in range(2)]
    B = [[T[a][j] * s[j] for j in range(3)] for a in range(2)]
    a_ = B[0][0] * B[0][0] + B[0][1] * B[0][1] + B[0][2] * B[0][2]
    b_ = B[0][0] * B[1][0] + B[0][1] * B[1][1] + B[0][2] * B[1][2]
    c_ = B[1][0] * B[1][0] + B[1][1] * B[1][1] + B[1][2] * B[1][2]
    det_raw = a_ * c_ - b_ * b_
    a_d, c_d = a_ + h_var, c_ + h_var
    det_d = a_d * c_d - b_ * b_
    dcl = torch.clamp(det_d, min=1e-12)
    inv_det = 1.0 / dcl

    # screen space: mean2d, depth, inv_depth, opacity, conic
    d_px, d_py, d_pz, d_zs = zero, zero, zero, zero
    d_vx, d_vy = zero, zero
    if "mean2d" in ct:
        d_vx = ct["mean2d"][:, 0] * fx
        d_vy = ct["mean2d"][:, 1] * fy
    if "depth" in ct:
        d_pz = d_pz + ct["depth"]
    if "inv_depth" in ct:
        rz = 1.0 / torch.clamp(pz, min=near_z)
        d_sz = -torch.where(vis, ct["inv_depth"], zero) * (rz * rz)
        d_pz = d_pz + torch.where(pz >= near_z, d_sz, zero)
    d_opac = torch.where(vis, ct["opacity"], zero) if "opacity" in ct else zero
    d_ad, d_cd, d_b, d_dcl = zero, zero, zero, zero
    if "conic" in ct:
        g0, g1, g2 = ct["conic"].unbind(-1)
        d_cd = g0 * inv_det
        d_b = -(g1 * inv_det)
        d_ad = g2 * inv_det
        d_inv = g0 * c_d + g1 * -b_ + g2 * a_d
        d_dcl = -d_inv * (inv_det * inv_det)
    d_a, d_c = zero, zero
    if antialias:
        ratio = det_raw / dcl
        aa = torch.sqrt(torch.clamp(ratio, min=0.0))
        d_opacities = d_opac * aa
        if "opacity" in ct:
            d_ratio = torch.where(ratio >= 0, (d_opac * opacities) / (2 * aa), zero)
            d_raw = d_ratio / dcl
            d_dcl = d_dcl - d_ratio * (ratio / dcl)
            d_a = d_raw * c_
            d_c = d_raw * a_
            d_b = d_b - 2 * b_ * d_raw
    else:
        d_opacities = d_opac
    d_det = torch.where(det_d >= 1e-12, d_dcl, zero)
    d_ad = d_ad + d_det * c_d
    d_cd = d_cd + d_det * a_d
    d_b = d_b - 2 * b_ * d_det
    d_a = d_a + d_ad
    d_c = d_c + d_cd

    # the 2x3 factor B = A·R(q)·diag(s), then A = J·R_cam
    dB = [[2 * B[0][j] * d_a + B[1][j] * d_b for j in range(3)],
          [2 * B[1][j] * d_c + B[0][j] * d_b for j in range(3)]]
    d_s = [dB[0][j] * T[0][j] + dB[1][j] * T[1][j] for j in range(3)]
    dT = [[dB[a][j] * s[j] for j in range(3)] for a in range(2)]
    dA = [[dT[a][0] * r[i][0] + dT[a][1] * r[i][1] + dT[a][2] * r[i][2] for i in range(3)] for a in range(2)]
    dr = [[dT[0][j] * A[0][i] + dT[1][j] * A[1][i] for j in range(3)] for i in range(3)]
    d_j00 = dA[0][0] * R[0][0] + dA[0][1] * R[0][1] + dA[0][2] * R[0][2]
    d_j02 = dA[0][0] * R[2][0] + dA[0][1] * R[2][1] + dA[0][2] * R[2][2]
    d_j11 = dA[1][0] * R[1][0] + dA[1][1] * R[1][1] + dA[1][2] * R[1][2]
    d_j12 = dA[1][0] * R[2][0] + dA[1][1] * R[2][1] + dA[1][2] * R[2][2]
    d_zs = d_zs - d_j00 * (j00 / zs) - d_j11 * (j11 / zs) - d_j02 * (j02 / zs) - d_j12 * (j12 / zs)
    d_vx = d_vx + torch.where((vx >= lox) & (vx <= hix), (d_j02 / zs) * -fx, zero)
    d_vy = d_vy + torch.where((vy >= loy) & (vy <= hiy), (d_j12 / zs) * -fy, zero)
    d_px = d_px + d_vx / zs
    d_py = d_py + d_vy / zs
    d_zs = d_zs - d_vx * (vx / zs) - d_vy * (vy / zs)
    d_pz = d_pz + torch.where(pz >= near_z, d_zs, zero)

    if render_geo and ("normal" in ct or "distance" in ct):
        # the smallest axis's column of R(q), in the camera frame, flipped
        # toward the camera
        idx = torch.argmin(scales, dim=-1)
        sel = [idx == j for j in range(3)]
        n_w = [torch.where(sel[0], r[i][0], torch.where(sel[1], r[i][1], r[i][2])) for i in range(3)]
        ncam = [R[i][0] * n_w[0] + R[i][1] * n_w[1] + R[i][2] * n_w[2] for i in range(3)]
        dot = ncam[0] * pc[0] + ncam[1] * pc[1] + ncam[2] * pc[2]
        flip = torch.where(dot > 0, -1.0, 1.0)
        d_dot = ct["distance"] * -flip if "distance" in ct else zero
        d_nc = [d_dot * pc[i] for i in range(3)]
        if "normal" in ct:
            d_nc = [d_nc[i] + ct["normal"][:, i] * flip for i in range(3)]
        d_px = d_px + d_dot * ncam[0]
        d_py = d_py + d_dot * ncam[1]
        d_pz = d_pz + d_dot * ncam[2]
        d_nw = [R[0][j] * d_nc[0] + R[1][j] * d_nc[1] + R[2][j] * d_nc[2] for j in range(3)]
        dr = [[dr[i][j] + torch.where(sel[j], d_nw[i], zero) for j in range(3)] for i in range(3)]

    d_means = torch.stack([R[0][k] * d_px + R[1][k] * d_py + R[2][k] * d_pz for k in range(3)], dim=-1)
    out = {"scales": torch.stack(d_s, dim=-1), "quats": _quat_rotation_bwd(quats, wxyz, qinv, dr),
           "opacities": d_opacities}
    if mean2d_offset is not None:
        out["mean2d_offset"] = ct["mean2d"] if "mean2d" in ct else torch.zeros_like(mean2d_offset)
    if colors_precomp is not None:
        out["colors_precomp"] = ct["rgb"] if "rgb" in ct else torch.zeros_like(colors_precomp)
    else:
        # SH → RGB: rgb_c = max(Σ_k basis_k·mask_k·sh_kc + 0.5, 0)
        K = shs.shape[-1] // 3 if shs.ndim == 2 else shs.shape[-2]
        sh = shs.reshape(shs.shape[0], K, 3)
        d_sh = torch.zeros_like(sh)
        if "rgb" in ct:
            dirs = means3d - cam.camera_center
            dinv = torch.rsqrt(torch.sum(dirs * dirs, dim=-1) + 1e-24)
            x, y, z = (dirs * dinv[:, None]).unbind(-1)
            bm = torch.stack(shm._sh_basis_components(torch.stack([x, y, z], dim=-1))[:K], dim=-1)
            bm = bm * shm.degree_mask(active_sh_degree, K, device=sh.device)
            ev = torch.sum(bm[:, :, None] * sh, dim=1)
            d_ev = torch.where(ev + 0.5 >= 0, ct["rgb"], torch.zeros_like(ev))
            d_sh = bm[:, :, None] * d_ev[:, None, :]
            d_bm = torch.sum(sh * d_ev[:, None, :], dim=-1) * shm.degree_mask(active_sh_degree, K, device=sh.device)
            gx, gy, gz = _sh_basis_grad(x, y, z)
            d_dn = torch.stack([sum(d_bm[:, k] * g[k] for k in range(K)) for g in (gx, gy, gz)], dim=-1)
            d_means = d_means + _normalize_bwd(dirs, dinv, d_dn)
        out["shs"] = d_sh.reshape(shs.shape)
    out["means3d"] = d_means
    return out


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
