"""Large-scene spatial chunking.

The port's own copy of hidegs_tpu/preprocess/chunking.py (numpy; OpenCV
only for the optional blur filter, imported when it runs).

Functional equivalent of preprocess/make_chunk.py:33-259 and
concat_chunks_info.py: regular XY grid of `chunk_size` cells over the camera
bounding box; per-chunk camera assignment (inside cells, plus optional
far-looking cameras), 3D-point assignment, blur (Laplacian variance)
filtering, min/max camera bounds; emits per-chunk COLMAP models +
center.txt/extent.txt and an aggregate chunks.txt.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from hidegs_tpu_torch.data import colmap


@dataclass
class ChunkSpec:
    i: int
    j: int
    center: np.ndarray  # (3,)
    extent: np.ndarray  # (3,)
    camera_ids: List[int]
    point_mask: np.ndarray  # (N,) bool over the filtered point set


def laplacian_variance(image_path: str) -> float:
    """Blur score (make_chunk.py get_var_of_laplacian)."""
    try:
        import cv2

        img = cv2.imread(image_path)
        if img is None:
            return 0.0
        gray = cv2.cvtColor(img[..., :3], cv2.COLOR_BGR2GRAY)
        return float(cv2.Laplacian(gray, cv2.CV_32F).var())
    except ImportError:
        return 1e9  # no cv2 → keep everything


def compute_chunks(
    cams: Dict[int, colmap.ColmapCamera],
    imgs: Dict[int, colmap.ColmapImage],
    xyz: np.ndarray,
    errors: np.ndarray,
    chunk_size: float = 30.0,
    min_padd: float = 0.1,
    min_n_cams: int = 100,
    max_n_cams: int = 1500,
    add_far_cams: bool = True,
    lapla_scores: Optional[Dict[int, float]] = None,
    lapla_thresh: float = 1.0,
    error_threshold: float = 10.0,
) -> List[ChunkSpec]:
    """Grid the scene and assign cameras/points per chunk."""
    keys = sorted(imgs.keys())
    centers = np.stack(
        [-colmap.qvec_to_rotmat(imgs[k].qvec).T @ imgs[k].tvec for k in keys]
    )
    fwd = np.stack([colmap.qvec_to_rotmat(imgs[k].qvec)[2] for k in keys])

    pt_keep = errors < error_threshold
    pts = xyz[pt_keep]

    # blur filter: keep images with laplacian ≥ mean − thresh·std
    keep_cam = np.ones(len(keys), bool)
    if lapla_scores is not None and lapla_thresh > 0:
        lap = np.array([lapla_scores.get(k, 0.0) for k in keys])
        keep_cam = lap >= (lap.mean() - lapla_thresh * lap.std())

    bbox_min = centers.min(axis=0).astype(np.float64)
    bbox_max = centers.max(axis=0).astype(np.float64)
    bbox_min[:2] -= min_padd * chunk_size
    bbox_max[:2] += min_padd * chunk_size
    extent = bbox_max - bbox_min
    padd = np.array(
        [chunk_size - extent[0] % chunk_size, chunk_size - extent[1] % chunk_size]
    )
    bbox_min[:2] -= padd / 2
    bbox_max[:2] += padd / 2

    n_w = max(int(round((bbox_max[0] - bbox_min[0]) / chunk_size)), 1)
    n_h = max(int(round((bbox_max[1] - bbox_min[1]) / chunk_size)), 1)

    chunks = []
    for i in range(n_w):
        for j in range(n_h):
            cmin = bbox_min[:2] + np.array([i, j]) * chunk_size
            cmax = cmin + chunk_size
            in_chunk = (
                (centers[:, 0] >= cmin[0]) & (centers[:, 0] < cmax[0])
                & (centers[:, 1] >= cmin[1]) & (centers[:, 1] < cmax[1])
                & keep_cam
            )
            cam_sel = set(np.where(in_chunk)[0])
            if add_far_cams:
                # cameras outside that look toward the chunk center
                ccenter3 = np.array([*(cmin + cmax) / 2, centers[:, 2].mean()])
                to_c = ccenter3 - centers
                d = np.linalg.norm(to_c, axis=-1)
                cosang = np.einsum("nd,nd->n", to_c / np.maximum(d[:, None], 1e-9), fwd)
                far = (~in_chunk) & keep_cam & (cosang > 0.9) & (d < 3 * chunk_size)
                cam_sel |= set(np.where(far)[0])
            if len(cam_sel) < min_n_cams:
                continue
            cam_list = sorted(cam_sel)
            if len(cam_list) > max_n_cams:
                rng = np.random.RandomState(0)
                cam_list = sorted(rng.choice(cam_list, max_n_cams, replace=False))
            in_pts = (
                (pts[:, 0] >= cmin[0]) & (pts[:, 0] < cmax[0])
                & (pts[:, 1] >= cmin[1]) & (pts[:, 1] < cmax[1])
            )
            chunks.append(
                ChunkSpec(
                    i=i,
                    j=j,
                    center=np.array([*(cmin + cmax) / 2, float(centers[:, 2].mean())]),
                    extent=np.array([chunk_size, chunk_size, float(np.ptp(centers[:, 2]) + 1)]),
                    camera_ids=[keys[c] for c in cam_list],
                    point_mask=in_pts,
                )
            )
    return chunks


def write_chunks(
    chunks: List[ChunkSpec],
    cams: Dict[int, colmap.ColmapCamera],
    imgs: Dict[int, colmap.ColmapImage],
    xyz: np.ndarray,
    rgb: np.ndarray,
    errors: np.ndarray,
    output_path: str,
    error_threshold: float = 10.0,
):
    """Write per-chunk COLMAP models + center/extent files + chunks.txt
    (make_chunk.py output layout; concat_chunks_info.py aggregate)."""
    pt_keep = errors < error_threshold
    pts = xyz[pt_keep]
    cols = rgb[pt_keep]
    lines = []
    for ch in chunks:
        d = os.path.join(output_path, f"chunk_{ch.i}_{ch.j}")
        sparse = os.path.join(d, "sparse", "0")
        os.makedirs(sparse, exist_ok=True)
        sub_imgs = {k: imgs[k] for k in ch.camera_ids}
        colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
        colmap.write_images_binary(sub_imgs, os.path.join(sparse, "images.bin"))
        colmap.write_points3d_binary(
            pts[ch.point_mask], cols[ch.point_mask], os.path.join(sparse, "points3D.bin")
        )
        np.savetxt(os.path.join(d, "center.txt"), ch.center[None])
        np.savetxt(os.path.join(d, "extent.txt"), ch.extent[None])
        lines.append(f"chunk_{ch.i}_{ch.j} " + " ".join(map(str, ch.center)) + " " + " ".join(map(str, ch.extent)))
    with open(os.path.join(output_path, "chunks.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
