"""EWA splatting math: 3D Gaussians → screen-space mean, conic and radius.

Port of hidegs_tpu/core/ewa.py (`project_gaussians`, `project_gaussians_scq`,
`gaussian_alpha`).
Anti-aliasing follows the reference's convolution-rescale: the low-pass
dilation adds `h_var` to the 2D covariance diagonal and opacity is rescaled
by sqrt(det(cov)/det(cov_dilated)). One H_VAR is used throughout, as in the
JAX package (the reference uses 0.1 forward and 0.3 backward).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from hidegs_tpu_torch.core.camera_math import CameraParams

# Low-pass dilation variance (pixels^2).
H_VAR = 0.1
# Frustum near limit (the reference's in_frustum): cull z <= 0.2.
NEAR_Z = 0.2


class Projected2D(NamedTuple):
    mean2d: torch.Tensor  # (N, 2) pixel coords
    depth: torch.Tensor  # (N,) camera z
    cov2d: torch.Tensor  # (N, 3) (a, b, c) of [[a, b], [b, c]] after dilation
    conic: torch.Tensor  # (N, 3) inverse covariance (a, b, c)
    radius: torch.Tensor  # (N,) float extent radius in pixels (3 sigma)
    aa_factor: torch.Tensor  # (N,) opacity rescale from AA dilation
    in_frustum: torch.Tensor  # (N,) bool


def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    cam: CameraParams,
    h_var: float = H_VAR,
    near_z: float = NEAR_Z,
) -> Projected2D:
    """EWA projection of (N, 3) world means with (N, 3, 3) world-frame
    covariances: cov2d = J R Σ Rᵀ Jᵀ with the tangent-clamped Jacobian J."""
    p_cam = means3d @ cam.R.T + cam.t
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    in_frustum = z > near_z
    zs = torch.clamp(z, min=near_z)

    # tangent clamp at 1.3x the (full-frame) frustum half-extent
    tan_half_x = torch.div(cam.frustum_width, 2.0 * cam.fx)
    tan_half_y = torch.div(cam.frustum_height, 2.0 * cam.fy)
    txz = torch.clamp(x / zs, -1.3 * tan_half_x, 1.3 * tan_half_x)
    tyz = torch.clamp(y / zs, -1.3 * tan_half_y, 1.3 * tan_half_y)
    j00 = cam.fx / zs
    j11 = cam.fy / zs
    j02 = -cam.fx * txz / zs
    j12 = -cam.fy * tyz / zs
    zero = torch.zeros_like(zs)
    J = torch.stack([torch.stack([j00, zero, j02], dim=-1),
                     torch.stack([zero, j11, j12], dim=-1)], dim=-2)  # (N, 2, 3)
    M = J @ cam.R  # (N, 2, 3)
    cov = M @ cov3d @ M.transpose(-1, -2)  # (N, 2, 2)
    a, b, c = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]

    det_raw = a * c - b * b
    a_d = a + h_var
    c_d = c + h_var
    det_d = a_d * c_d - b * b
    aa_factor = torch.sqrt(torch.clamp(det_raw / torch.clamp(det_d, min=1e-12), min=0.0))
    inv_det = 1.0 / torch.clamp(det_d, min=1e-12)
    conic = torch.stack([c_d * inv_det, -b * inv_det, a_d * inv_det], dim=-1)
    mid = 0.5 * (a_d + c_d)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det_d, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    # centers come from the UNCLAMPED projection; the clamp only tames J
    u = cam.fx * (x / zs) + cam.cx
    v = cam.fy * (y / zs) + cam.cy
    valid = in_frustum & (det_d > 0.0)
    return Projected2D(
        mean2d=torch.stack([u, v], dim=-1),
        depth=z,
        cov2d=torch.stack([a_d, b, c_d], dim=-1),
        conic=conic,
        radius=torch.where(valid, radius, torch.zeros_like(radius)),
        aa_factor=aa_factor,
        in_frustum=valid,
    )


def project_gaussians_scq(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    cam: CameraParams,
    h_var: float = H_VAR,
    near_z: float = NEAR_Z,
) -> Projected2D:
    """EWA projection straight from (scales, quats), as (N,) component math:
    cov2d = B Bᵀ with B = J·R_cam·R(q)·diag(s)."""
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    R, t = cam.R, cam.t
    px = R[0, 0] * mx + R[0, 1] * my + R[0, 2] * mz + t[0]
    py = R[1, 0] * mx + R[1, 1] * my + R[1, 2] * mz + t[1]
    pz = R[2, 0] * mx + R[2, 1] * my + R[2, 2] * mz + t[2]
    in_frustum = pz > near_z
    zs = torch.clamp(pz, min=near_z)

    # tangent clamp at 1.3x the (full-frame) frustum half-extent; torch.div,
    # because `scalar / tensor` is reciprocal-then-multiply in torch
    tan_half_x = torch.div(cam.frustum_width, 2.0 * cam.fx)
    tan_half_y = torch.div(cam.frustum_height, 2.0 * cam.fy)
    txz = torch.clamp(px / zs, -1.3 * tan_half_x, 1.3 * tan_half_x)
    tyz = torch.clamp(py / zs, -1.3 * tan_half_y, 1.3 * tan_half_y)
    j00 = cam.fx / zs
    j11 = cam.fy / zs
    j02 = -cam.fx * txz / zs
    j12 = -cam.fy * tyz / zs

    A = [
        [j00 * R[0, k] + j02 * R[2, k] for k in range(3)],
        [j11 * R[1, k] + j12 * R[2, k] for k in range(3)],
    ]
    q = quats * torch.rsqrt(torch.sum(quats * quats, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    s = [scales[:, 0], scales[:, 1], scales[:, 2]]
    Brow = [
        [(A[a][0] * r[0][j] + A[a][1] * r[1][j] + A[a][2] * r[2][j]) * s[j] for j in range(3)]
        for a in range(2)
    ]
    a_ = Brow[0][0] ** 2 + Brow[0][1] ** 2 + Brow[0][2] ** 2
    b_ = Brow[0][0] * Brow[1][0] + Brow[0][1] * Brow[1][1] + Brow[0][2] * Brow[1][2]
    c_ = Brow[1][0] ** 2 + Brow[1][1] ** 2 + Brow[1][2] ** 2

    det_raw = a_ * c_ - b_ * b_
    a_d = a_ + h_var
    c_d = c_ + h_var
    det_d = a_d * c_d - b_ * b_
    aa_factor = torch.sqrt(torch.clamp(det_raw / torch.clamp(det_d, min=1e-12), min=0.0))
    inv_det = 1.0 / torch.clamp(det_d, min=1e-12)
    conic = torch.stack([c_d * inv_det, -b_ * inv_det, a_d * inv_det], dim=-1)

    # radius = ceil(3 sqrt(max eigenvalue))
    mid = 0.5 * (a_d + c_d)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det_d, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    # centers come from the UNCLAMPED projection; the clamp only tames J
    u = cam.fx * (px / zs) + cam.cx
    v = cam.fy * (py / zs) + cam.cy

    valid = in_frustum & (det_d > 0.0)
    return Projected2D(
        mean2d=torch.stack([u, v], dim=-1),
        depth=pz,
        cov2d=torch.stack([a_d, b_, c_d], dim=-1),
        conic=conic,
        radius=torch.where(valid, radius, torch.zeros_like(radius)),
        aa_factor=aa_factor,
        in_frustum=valid,
    )


def gaussian_alpha(
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    opacity: torch.Tensor,
    pix: torch.Tensor,
    alpha_min: float = 1.0 / 255.0,
    alpha_max: float = 0.99,
) -> torch.Tensor:
    """Splat alpha at pixel centers (broadcasting against pix (..., 2)): the
    positive-power guard, the 0.99 clamp, and the 1/255 cut as a zeroing mask."""
    d = pix - mean2d
    dx, dy = d[..., 0], d[..., 1]
    power = -0.5 * (conic[..., 0] * dx * dx + conic[..., 2] * dy * dy) - conic[..., 1] * dx * dy
    alpha = torch.clamp(opacity * torch.exp(torch.clamp(power, max=0.0)), max=alpha_max)
    keep = (power <= 0.0) & (alpha >= alpha_min)
    return torch.where(keep, alpha, torch.zeros_like(alpha))
