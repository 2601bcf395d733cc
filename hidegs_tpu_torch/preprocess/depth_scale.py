"""Per-image monodepth (scale, offset) fitting against COLMAP sparse depth.

Port of hidegs_tpu/preprocess/depth_scale.py: the 16-bit inverse-depth
PNGs are read with utils/png (Pillow only for other formats).

Functional equivalent of preprocess/make_depth_scale.py:19-115: for each
image, project its COLMAP 3D points, read the inverse monodepth map at those
pixels, and fit the robust median/MAD alignment
    scale  = MAD(inv_colmap) / MAD(inv_mono)
    offset = median(inv_colmap) − median(inv_mono)·scale
Writes depth_params.json consumed by the data layer (scene/cameras.py:101-119).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from hidegs_tpu_torch.data import colmap


def fit_image_depth_scale(
    image: colmap.ColmapImage,
    cam: colmap.ColmapCamera,
    points3d_ordered: np.ndarray,  # (max_id+1, 3), zeros for missing
    inv_monodepth: np.ndarray,  # (h, w) float inverse monodepth in [0,1]
) -> Optional[dict]:
    pts_idx = image.point3d_ids
    mask = (pts_idx >= 0) & (pts_idx < len(points3d_ordered))
    pts_idx_v = pts_idx[mask]
    if len(pts_idx_v) == 0:
        return None
    valid_xys = image.xys[mask]
    pts = points3d_ordered[pts_idx_v]
    nonzero = (pts != 0).any(axis=-1)
    pts, valid_xys = pts[nonzero], valid_xys[nonzero]
    if len(pts) == 0:
        return None

    R = colmap.qvec_to_rotmat(image.qvec)
    p_cam = pts @ R.T + image.tvec
    z = p_cam[:, 2]
    with np.errstate(divide="ignore"):
        inv_colmap = 1.0 / z

    s = inv_monodepth.shape[0] / cam.height
    uv = valid_xys * s
    h, w = inv_monodepth.shape
    ok = (
        (uv[:, 0] >= 0) & (uv[:, 1] >= 0) & (uv[:, 0] < w - 1) & (uv[:, 1] < h - 1)
        & (inv_colmap > 0)
    )
    if ok.sum() <= 10:
        return None
    inv_colmap = inv_colmap[ok]
    if inv_colmap.max() - inv_colmap.min() <= 1e-3:
        return None
    uvo = uv[ok]
    x0 = uvo[:, 0].astype(int)
    y0 = uvo[:, 1].astype(int)
    fx = uvo[:, 0] - x0
    fy = uvo[:, 1] - y0
    inv_mono = (
        inv_monodepth[y0, x0] * (1 - fx) * (1 - fy)
        + inv_monodepth[y0, x0 + 1] * fx * (1 - fy)
        + inv_monodepth[y0 + 1, x0] * (1 - fx) * fy
        + inv_monodepth[y0 + 1, x0 + 1] * fx * fy
    )

    t_colmap = float(np.median(inv_colmap))
    s_colmap = float(np.mean(np.abs(inv_colmap - t_colmap)))
    t_mono = float(np.median(inv_mono))
    s_mono = float(np.mean(np.abs(inv_mono - t_mono)))
    if s_mono < 1e-12:
        return None
    scale = s_colmap / s_mono
    offset = t_colmap - t_mono * scale
    return {"scale": scale, "offset": offset}


def make_depth_params(
    sparse_dir: str, depths_dir: str, out_path: Optional[str] = None
) -> Dict[str, dict]:
    """Fit all images in a COLMAP model; writes sparse_dir/depth_params.json."""
    cams, imgs, (xyz, rgb, err, pt_ids) = colmap.read_model(sparse_dir)
    max_id = int(pt_ids.max()) if len(pt_ids) else 0
    for im in imgs.values():
        if len(im.point3d_ids):
            max_id = max(max_id, int(im.point3d_ids.max()))
    # id-indexed lookup like the reference's points3d_ordered
    # (make_depth_scale.py:81-83); missing ids stay zero and are filtered
    ordered = np.zeros((max_id + 2, 3))
    ordered[pt_ids] = xyz

    from hidegs_tpu_torch.utils.png import read_image

    params: Dict[str, dict] = {}
    for im in imgs.values():
        stem = os.path.splitext(im.name)[0]
        dpath = os.path.join(depths_dir, stem + ".png")
        if not os.path.exists(dpath):
            continue
        arr = read_image(dpath).astype(np.float32)
        if arr.ndim == 3:
            arr = arr[..., 0]
        arr = arr / 65535.0 if arr.max() > 255 else arr / 255.0
        fit = fit_image_depth_scale(im, cams[im.camera_id], ordered, arr)
        if fit is not None:
            params[stem] = fit
    if out_path is None:
        out_path = os.path.join(sparse_dir, "depth_params.json")
    with open(out_path, "w") as f:
        json.dump(params, f, indent=1)
    return params
