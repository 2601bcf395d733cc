"""Procrustes re-alignment of a refined chunk back into the global frame.

The port's own copy of hidegs_tpu/preprocess/align.py (numpy only).

Equivalent of preprocess/transform_colmap.py: after a chunk's cameras are
re-bundled (prepare_chunk), its COLMAP frame drifts from the global scene
frame. A similarity transform (sim3) is fit between matching camera centers
(old global model vs. new per-chunk model), outlier cameras are dropped at
5x the median center displacement (transform_colmap.py:80-81), and the new
cameras + filtered points are written back expressed in the global frame.

    python -m hidegs_tpu_torch.preprocess.align --in_dir chunk/ \
        --new_colmap_dir chunk_refined/ --out_dir chunk_aligned/
"""
from __future__ import annotations

import argparse
import os
from typing import NamedTuple

import numpy as np

from hidegs_tpu_torch.data.colmap import (
    ColmapImage,
    qvec_to_rotmat,
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
    write_cameras_binary,
    write_images_binary,
    write_points3d_binary,
)


class Sim3(NamedTuple):
    """Similarity transform fit by :func:`procrustes`; maps frame-1 points to
    frame-0 via ``(x - t1) / s1 @ R.T * s0 + t0``."""

    t0: np.ndarray
    t1: np.ndarray
    s0: float
    s1: float
    R: np.ndarray


def procrustes(X0: np.ndarray, X1: np.ndarray) -> Sim3:
    """Closed-form sim3 aligning point set X1 to X0 (both (N, 3)); the
    classic orthogonal-Procrustes SVD (transform_colmap.py:24-44)."""
    t0 = X0.mean(axis=0)
    t1 = X1.mean(axis=0)
    X0c = X0 - t0
    X1c = X1 - t1
    s0 = float(np.sqrt((X0c**2).sum(axis=-1).mean()))
    s1 = float(np.sqrt((X1c**2).sum(axis=-1).mean()))
    U, _, Vt = np.linalg.svd((X0c / s0).T @ (X1c / s1))
    R = (U @ Vt).astype(np.float64)
    if np.linalg.det(R) < 0:
        R[2] *= -1
    return Sim3(t0=t0, t1=t1, s0=s0, s1=s1, R=R)


def apply_sim3(sim3: Sim3, X: np.ndarray) -> np.ndarray:
    """Map (N, 3) frame-1 points into frame 0."""
    return (X - sim3.t1) / sim3.s1 @ sim3.R.T * sim3.s0 + sim3.t0


def _rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """(3, 3) → (4,) wxyz."""
    K = np.array(
        [
            [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
            [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
            [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1], R[0, 0] + R[1, 1] + R[2, 2]],
        ]
    ) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0] + (q[0] == 0))


def align_chunk(
    in_dir: str,
    new_colmap_dir: str,
    out_dir: str,
    max_error: float = 1.5,
    outlier_factor: float = 5.0,
) -> dict:
    """Fit sim3 on matching camera centers and write the aligned chunk model.

    `in_dir` holds the original chunk (sparse/0 + center.txt/extent.txt),
    `new_colmap_dir` the refined chunk (sparse/0). Cameras whose centers moved
    more than `outlier_factor` x median are dropped (transform_colmap.py:80-81,
    143-160); points with reprojection error ≥ `max_error` are dropped
    (transform_colmap.py:109-111 — our COLMAP reader does not retain track
    lengths, so the reference's additional n_images>3 filter is subsumed by
    the error cut). Returns {'n_cams', 'n_points', 'sim3'}.
    """
    old_images = read_images_binary(os.path.join(in_dir, "sparse/0/images.bin"))
    new_images = read_images_binary(os.path.join(new_colmap_dir, "sparse/0/images.bin"))
    by_name = {im.name: im for im in old_images.values()}

    keys = [k for k in new_images if new_images[k].name in by_name]

    def center(im: ColmapImage) -> np.ndarray:
        return -qvec_to_rotmat(im.qvec).T @ im.tvec

    old_centers = np.stack([center(by_name[new_images[k].name]) for k in keys])
    new_centers = np.stack([center(new_images[k]) for k in keys])

    dists = np.linalg.norm(old_centers - new_centers, axis=-1)
    valid = dists <= np.median(dists) * outlier_factor + 1e-8

    sim3 = procrustes(old_centers[valid], new_centers[valid])
    centers_aligned = apply_sim3(sim3, new_centers)

    xyz, rgb, err, _ids = read_points3d_binary(
        os.path.join(new_colmap_dir, "sparse/0/points3D.bin")
    )
    keep = err < max_error
    pts_aligned = apply_sim3(sim3, xyz[keep])

    out_sparse = os.path.join(out_dir, "sparse/0")
    os.makedirs(out_sparse, exist_ok=True)

    images_out = {}
    for k, c_aligned, ok in zip(keys, centers_aligned, valid):
        if not ok:
            continue
        im = new_images[k]
        R_new = qvec_to_rotmat(im.qvec) @ sim3.R.T
        t_new = -R_new @ c_aligned
        images_out[k] = ColmapImage(
            id=im.id,
            qvec=_rotmat_to_qvec(R_new),
            tvec=t_new,
            camera_id=im.camera_id,
            name=im.name,
            xys=im.xys,
            point3d_ids=im.point3d_ids,
        )
    write_images_binary(images_out, os.path.join(out_sparse, "images.bin"))
    write_points3d_binary(pts_aligned, rgb[keep], os.path.join(out_sparse, "points3D.bin"))
    cams = read_cameras_binary(os.path.join(new_colmap_dir, "sparse/0/cameras.bin"))
    write_cameras_binary(cams, os.path.join(out_sparse, "cameras.bin"))
    for aux in ("center.txt", "extent.txt"):
        src = os.path.join(in_dir, aux)
        if os.path.exists(src):
            with open(src) as f, open(os.path.join(out_dir, aux), "w") as g:
                g.write(f.read())
    return {"n_cams": len(images_out), "n_points": int(keep.sum()), "sim3": sim3}


def main(argv=None):
    p = argparse.ArgumentParser("hidegs_tpu_torch chunk Procrustes alignment")
    p.add_argument("--in_dir", required=True)
    p.add_argument("--new_colmap_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--max_error", type=float, default=1.5)
    args = p.parse_args(argv)
    info = align_chunk(args.in_dir, args.new_colmap_dir, args.out_dir, args.max_error)
    print(f"aligned {info['n_cams']} cameras, {info['n_points']} points → {args.out_dir}")


if __name__ == "__main__":
    main()
