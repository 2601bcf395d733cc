"""Scene reorientation + outlier-camera filtering.

Port of hidegs_tpu/preprocess/reorient.py: the camera rotations are
re-quaternionized with the port's core/transforms.rotmat_to_quat on a CPU
tensor.

Equivalents of preprocess/auto_reorient.py:20-30 (least-squares ground-plane
fit from camera centers → rotate so the plane normal becomes the world up
axis) and preprocess/simplify_images.py:17-23 (drop cameras farther than 10x
the median nearest-neighbor distance).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from hidegs_tpu_torch.core.transforms import rotmat_to_quat
from hidegs_tpu_torch.data import colmap


def fit_ground_plane(centers: np.ndarray) -> Tuple[np.ndarray, float]:
    """Least-squares plane through camera centers → (unit normal, offset)."""
    c = centers.mean(axis=0)
    A = centers - c
    _, _, Vt = np.linalg.svd(A, full_matrices=False)
    n = Vt[-1]
    # UAV scenes look down: make the normal oppose the mean view direction
    return n, float(n @ c)


def reorientation_matrix(centers: np.ndarray, up_hint: np.ndarray = None) -> np.ndarray:
    """Rotation R aligning the fitted plane normal with -y (COLMAP up).

    Applied as X' = R @ X to points and (R_cam @ Rᵀ, t) to cameras.
    """
    n, _ = fit_ground_plane(centers)
    target = np.array([0.0, -1.0, 0.0]) if up_hint is None else up_hint / np.linalg.norm(up_hint)
    if n @ target < 0:
        n = -n
    v = np.cross(n, target)
    s = np.linalg.norm(v)
    c = float(n @ target)
    if s < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))


def apply_reorientation(
    R_new: np.ndarray,
    imgs: Dict[int, colmap.ColmapImage],
    xyz: np.ndarray,
):
    """Rotate the whole model: world points and camera extrinsics."""
    xyz2 = xyz @ R_new.T
    out = {}
    for k, im in imgs.items():
        R_cam = colmap.qvec_to_rotmat(im.qvec)
        R2 = R_cam @ R_new.T
        # re-quaternionize (float32, on the host)
        q = rotmat_to_quat(torch.from_numpy(R2[None].astype(np.float32))).numpy()[0]
        out[k] = colmap.ColmapImage(
            im.id, q.astype(np.float64), im.tvec, im.camera_id, im.name, im.xys, im.point3d_ids
        )
    return out, xyz2


def drop_outlier_cameras(
    imgs: Dict[int, colmap.ColmapImage], factor: float = 10.0
) -> Dict[int, colmap.ColmapImage]:
    """simplify_images.py: remove cameras whose nearest-neighbor distance
    exceeds `factor` x the median."""
    keys = sorted(imgs.keys())
    if len(keys) < 3:
        return dict(imgs)
    centers = np.stack(
        [-colmap.qvec_to_rotmat(imgs[k].qvec).T @ imgs[k].tvec for k in keys]
    )
    d = np.linalg.norm(centers[:, None] - centers[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    nn = d.min(axis=1)
    med = np.median(nn)
    keep = nn <= factor * med
    return {k: imgs[k] for k, ok in zip(keys, keep) if ok}
