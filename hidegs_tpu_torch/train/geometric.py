"""Geometric consistency losses (PGSR-style, as wired in HiDeGS).

Port of hidegs_tpu/train/geometric.py.

Single-view: an edge-weighted L1 between the blended gaussian normals and
the normals re-derived from the plane depth map.

Multi-view: sample pixels in the reference view, unproject them through
the plane depth, warp patch neighbourhoods into a source view with the
plane-induced homography and compare them by LNCC; a reprojection check
through the source view's depth trims occluded and badly placed samples.
The JAX package draws the pixels with `jax.random` inside the loss; here
they are drawn by `sample_pixels` from a torch.Generator on the device, or
passed in as `uv` (the parity tests pass JAX's draws).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hidegs_tpu_torch.core.camera_math import CameraParams, project_points
from hidegs_tpu_torch.core.geometry import apply_homography, bilinear_sample, homography_from_plane, patch_offsets
from hidegs_tpu_torch.train.losses import abs_, clip, image_gradient_weight, lncc, maximum, minimum


def single_view_normal_loss(
    rendered_normal: torch.Tensor,  # (3, H, W) blended gaussian normals (camera frame)
    depth_normal: torch.Tensor,  # (3, H, W) normals from the plane depth map
    gt_image: torch.Tensor,  # (3, H, W), for the edge weight
    alpha: torch.Tensor,  # (H, W) coverage
) -> torch.Tensor:
    """Edge-weighted L1 between the two normal estimates; uncovered pixels
    and image edges weigh less, and the border rows and columns (which have
    no depth normal) not at all. Background pixels have alpha exactly 0,
    on clip's lower bound, and both normals exactly 0."""
    w = image_gradient_weight(gt_image) * clip(alpha, 0.0, 1.0)
    diff = torch.sum(abs_(rendered_normal - depth_normal), dim=0)
    valid = torch.zeros_like(diff)
    valid[1:-1, 1:-1] = 1.0
    return torch.sum(diff * w * valid) / maximum(torch.sum(w * valid), 1e-6)


class MultiViewBatch(NamedTuple):
    """Per-step data of one (reference, source) camera pair.

    `src_plane_depth=None` selects the DIFFERENTIABLE source path: the loss
    renders the source view itself and backpropagates through both views
    (the PGSR recipe). A precomputed, detached depth freezes the source
    geometry instead.

    Construct with KEYWORDS only, as the JAX package's: `src_plane_depth`
    follows `src_cam` to take its None default, so a positional
    `(gray, depth, cam)` call would bind the depth to `src_cam`."""

    src_image_gray: torch.Tensor  # (H, W) source view grayscale
    src_cam: CameraParams
    src_plane_depth: Optional[torch.Tensor] = None  # (H, W) detached source depth


def sample_pixels(generator: torch.Generator, num_samples: int, height: int, width: int,
                  patch_half: int = 1) -> torch.Tensor:
    """(num_samples, 2) float32 pixel coords drawn uniformly from
    [ph + 1, W - ph - 1) x [ph + 1, H - ph - 1), away from the border, on
    the generator's device (the JAX package's jax.random.uniform draw)."""
    lo = patch_half + 1.0
    u = torch.rand((num_samples, 2), generator=generator, device=generator.device)
    # scaled per column by Python floats: a constant tensor would be a
    # host-to-device copy, which waits for the device
    return torch.stack([lo + (width - patch_half - 1.0 - lo) * u[:, 0],
                        lo + (height - patch_half - 1.0 - lo) * u[:, 1]], dim=1)


def multi_view_losses(
    plane_depth: torch.Tensor,  # (H, W) reference plane depth
    normal_cam: torch.Tensor,  # (3, H, W) reference blended normals (camera frame)
    ref_image_gray: torch.Tensor,  # (H, W)
    ref_cam: CameraParams,
    src: MultiViewBatch,
    uv: torch.Tensor,  # (S, 2) sampled reference pixels (sample_pixels)
    patch_half: int = 1,
    pixel_noise_th: float = 1.0,
    ncc_threshold: float = 0.9,
):
    """(ncc_loss, geo_loss): the photometric (LNCC) and geometric
    (reprojection distance) multi-view consistency terms over the S samples
    `uv`. Invalid samples (low coverage, a warp out of bounds, a
    reprojection error above the noise threshold) are masked out of the
    means. `src.src_plane_depth` must be set (compute_losses renders it for
    the differentiable source)."""
    depth_s, dep_ok = bilinear_sample(plane_depth, uv)
    normal_s, _ = bilinear_sample(torch.movedim(normal_cam, 0, -1), uv)  # (S, 3)
    n_sq = torch.sum(normal_s * normal_s, dim=-1)
    n_norm = torch.sqrt(n_sq + 1e-12)  # smooth at 0 (empty pixels)
    normal_u = normal_s * torch.rsqrt(n_sq + 1e-12)[:, None]

    # plane distance in the ref camera frame: d = n · X, X = ray * depth
    x = (uv[:, 0] - ref_cam.cx) / ref_cam.fx
    y = (uv[:, 1] - ref_cam.cy) / ref_cam.fy
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    X_ref = rays * depth_s[:, None]
    dist = torch.sum(normal_u * X_ref, dim=-1)

    valid = dep_ok & (depth_s > 1e-3) & (n_norm > 0.1)

    # homography warp of patches ref → src
    Hm = homography_from_plane(normal_u, dist, ref_cam, src.src_cam)  # (S, 3, 3)
    offs = patch_offsets(patch_half, device=uv.device)  # (P, 2)
    patch_uv = uv[:, None, :] + offs[None, :, :]  # (S, P, 2)
    warped_uv = apply_homography(Hm[:, None], patch_uv)  # (S, P, 2)

    ref_patch, ref_ok = bilinear_sample(ref_image_gray, patch_uv)
    src_patch, src_ok = bilinear_sample(src.src_image_gray, warped_uv)
    valid = valid & ref_ok.all(dim=-1) & src_ok.all(dim=-1)

    ncc, ncc_mask = lncc(ref_patch, src_patch, ncc_threshold)

    # geometric check (PGSR): unproject the ref pixel through the ref depth,
    # into the src view, read the SRC view's depth there, unproject, back
    # into the ref view: a large round-trip error means occlusion or bad
    # geometry
    R_rel = src.src_cam.R @ ref_cam.R.T
    t_rel = src.src_cam.t - R_rel @ ref_cam.t
    X_src = X_ref @ R_rel.T + t_rel
    uv_src, z_src = project_points(X_src, src.src_cam)
    src_depth_s, src_dep_ok = bilinear_sample(src.src_plane_depth, uv_src)
    xs = (uv_src[:, 0] - src.src_cam.cx) / src.src_cam.fx
    ys = (uv_src[:, 1] - src.src_cam.cy) / src.src_cam.fy
    X_src2 = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1) * src_depth_s[:, None]
    X_ref2 = (X_src2 - t_rel) @ R_rel
    uv_back, z_back = project_points(X_ref2, ref_cam)
    duv = uv_back - uv
    pix_err = torch.sqrt(torch.sum(duv * duv, dim=-1) + 1e-12)  # smooth at 0
    valid = valid & (z_src > 1e-3) & src_dep_ok & (src_depth_s > 1e-3) & (z_back > 1e-3)
    geo_ok = valid & (pix_err < pixel_noise_th)

    w_ncc = (valid & ncc_mask & geo_ok).to(torch.float32)
    w_geo = valid.to(torch.float32)
    ncc_loss = torch.sum(ncc * w_ncc) / maximum(torch.sum(w_ncc), 1.0)
    geo_loss = torch.sum(minimum(pix_err, pixel_noise_th) * w_geo) / maximum(torch.sum(w_geo), 1.0)
    return ncc_loss, geo_loss
