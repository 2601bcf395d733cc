# Frozen copy of hidegs_tpu_torch/core/geometry.py:1-123 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Planar-depth geometry: depth ↔ points, depth → normal, homography patch
warps and bilinear lookups.

Port of hidegs_tpu/core/geometry.py. `bilinear_sample` reads its taps by
flat index from the image (`flat[idx]`), never with `torch.gather`: the
backward of an index read is `index_put_(accumulate=True)`, which on CUDA
sorts the indices (a stable radix sort) and sums each index's values in
that fixed order, so the image gradient is bitwise reproducible on the
card; the backward of `torch.gather` is a scatter-add of float atomics,
which is not. On the CPU, `index_put_` accumulates in parallel when torch
runs more than one thread, so there the gradient repeats bit for bit only
single-threaded (as the tests run).
"""
from __future__ import annotations

import torch

from gsbench.reference.core.camera_math import CameraParams, _safe_divisor, depth_to_points_cam, pixel_rays


def depth_to_normal_cam(depth: torch.Tensor, cam: CameraParams, offset: int = 1) -> torch.Tensor:
    """(H, W) z-depth → (H, W, 3) camera-space unit normals from the cross
    product of central differences of the unprojected points; border pixels
    get zero normals, and normals face the camera (n · p < 0)."""
    pts = depth_to_points_cam(depth, cam)
    H, W = depth.shape
    o = offset
    dx = pts[o:-o, 2 * o:, :] - pts[o:-o, : -2 * o, :]
    dy = pts[2 * o:, o:-o, :] - pts[: -2 * o, o:-o, :]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    facing = torch.sum(n * pts[o:-o, o:-o, :], dim=-1, keepdim=True) > 0
    n = torch.where(facing, -n, n)
    out = torch.zeros((H, W, 3), dtype=depth.dtype, device=depth.device)
    out[o:-o, o:-o, :] = n
    return out


def normal_to_world(normal_cam: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """Rotate camera-frame normals to the world frame."""
    return normal_cam @ cam.R


def plane_depth_from_blend(
    blended_distance: torch.Tensor,
    blended_normal: torch.Tensor,
    cam: CameraParams,
    eps: float = 1e-8,
    max_depth: float = 1e4,
) -> torch.Tensor:
    """Per-pixel plane-intersection depth distance / -(normal · ray + eps),
    (H, W) and (H, W, 3) → (H, W), clamped to ±max_depth (empty pixels have
    near-zero normals)."""
    rays = pixel_rays(cam)
    denom = -(torch.sum(blended_normal * rays, dim=-1) + eps)
    sign = torch.where(denom >= 0, 1.0, -1.0)
    d = blended_distance / (sign * torch.clamp(torch.abs(denom), min=eps))
    return torch.clamp(d, -max_depth, max_depth)


def patch_offsets(half_window: int, device=None) -> torch.Tensor:
    """((2h+1)^2, 2) integer (du, dv) offsets of a square patch, du fastest."""
    r = torch.arange(-half_window, half_window + 1, device=device)
    dv, du = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([du.reshape(-1), dv.reshape(-1)], dim=-1).to(torch.float32)


def homography_from_plane(
    normal_ref: torch.Tensor,
    distance_ref: torch.Tensor,
    cam_ref: CameraParams,
    cam_src: CameraParams,
) -> torch.Tensor:
    """Plane-induced homographies mapping ref pixels → src pixels. For the
    plane nᵀX = d in the REF camera frame, H = K_src (R_rel + t_rel nᵀ/d)
    K_ref⁻¹. normal_ref (..., 3), distance_ref (...,) → (..., 3, 3)."""
    R_rel = cam_src.R @ cam_ref.R.T  # ref-cam → src-cam rotation
    t_rel = cam_src.t - R_rel @ cam_ref.t
    d = distance_ref[..., None, None]
    n = normal_ref[..., None, :]  # (..., 1, 3)
    M = R_rel + (t_rel[:, None] * n) / torch.where(torch.abs(d) < 1e-8, 1e-8, d)
    return cam_src.K @ M @ cam_ref.K_inv


def apply_homography(H: torch.Tensor, uv: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Apply (..., 3, 3) homographies to (..., 2) pixel coords (broadcasting)."""
    p = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    q = (H @ p[..., None])[..., 0]
    return q[..., :2] / _safe_divisor(q[..., 2:3], eps)


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor, pad_value: float = 0.0):
    """Bilinear lookup of an (H, W) or (H, W, C) image at float pixel coords
    uv (..., 2) (u = column, v = row; pixel centers at half-integers).
    Returns (..., C) values (C squeezed for a 2D image) and the (...,)
    in-bounds mask; taps outside the image read `pad_value`."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    H, W, C = img.shape
    flat = img.reshape(H * W, C)
    x = uv[..., 0] - 0.5
    y = uv[..., 1] - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    # integer taps from coords clamped a little past the image, so that
    # far-off (or non-finite) warps convert to in-range integers
    x0i = torch.clamp(x0, -2.0, W + 1.0).to(torch.int64)
    y0i = torch.clamp(y0, -2.0, H + 1.0).to(torch.int64)

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
        return torch.where(inb[..., None], flat[idx], pad_value)

    out = (tap(y0i, x0i) * (1 - wx) * (1 - wy) + tap(y0i, x0i + 1) * wx * (1 - wy)
           + tap(y0i + 1, x0i) * (1 - wx) * wy + tap(y0i + 1, x0i + 1) * wx * wy)
    in_bounds = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    if squeeze:
        out = out[..., 0]
    return out, in_bounds
