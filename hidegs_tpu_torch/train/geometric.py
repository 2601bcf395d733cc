"""Geometric consistency losses (PGSR-style, as wired in HiDeGS).

Port of the single-view term of hidegs_tpu/train/geometric.py: an
edge-weighted L1 between the blended gaussian normals and the normals
re-derived from the plane depth map. The multi-view NCC / geometric terms
(`MultiViewBatch`, `multi_view_losses`) are not ported yet (ROADMAP A8).
"""
from __future__ import annotations

import torch

from hidegs_tpu_torch.train.losses import abs_, clip, image_gradient_weight, maximum


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
