"""Scene readers: COLMAP directory → CameraInfos + point cloud + normalization.

Port of hidegs_tpu/data/readers.py (numpy only). Mirrors the reference's
scene/dataset_readers.py: bin/txt extrinsics+intrinsics, PINHOLE /
SIMPLE_PINHOLE with principal point (:85-147), depth_params.json + med_scale
(:227-247), eval split via llffhold=8 or test.txt (:269-282), getNerfppNorm
radius (:61-83).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from hidegs_tpu_torch.data import colmap
from hidegs_tpu_torch.data.cameras import CameraInfo


@dataclass
class SceneInfo:
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    points: np.ndarray  # (N, 3)
    colors: np.ndarray  # (N, 3) in [0, 1]
    nerf_norm_radius: float
    nerf_norm_center: np.ndarray


def get_nerfpp_norm(cam_infos: List[CameraInfo]):
    """Scene normalization radius/center from camera centers
    (dataset_readers.py:61-83): radius = 1.1 * max distance to the average
    camera center."""
    centers = np.stack([-info.R.T @ info.t for info in cam_infos])
    center = centers.mean(axis=0)
    dists = np.linalg.norm(centers - center, axis=-1)
    radius = float(dists.max()) * 1.1
    return max(radius, 1e-3), center


def _camera_infos_from_colmap(
    cams, imgs, images_dir: str, depths_dir: str = "", depth_params: Optional[dict] = None,
    masks_dir: str = "",
) -> List[CameraInfo]:
    infos = []
    for iid in sorted(imgs.keys()):
        im = imgs[iid]
        cam = cams[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
            cx, cy = cam.params[1], cam.params[2]
        elif cam.model == "PINHOLE":
            fx, fy, cx, cy = cam.params[:4]
        else:
            raise ValueError(
                f"Unsupported camera model {cam.model}; undistort with COLMAP first "
                "(reference supports PINHOLE/SIMPLE_PINHOLE only, dataset_readers.py:105-120)"
            )
        R = colmap.qvec_to_rotmat(im.qvec)
        stem = os.path.splitext(im.name)[0]
        dp = None
        if depth_params and stem in depth_params:
            dp = dict(depth_params[stem])
            dp.setdefault("med_scale", depth_params.get("med_scale", 0.0))
        infos.append(
            CameraInfo(
                uid=iid,
                R=R,
                t=im.tvec.astype(np.float64),
                fx=float(fx),
                fy=float(fy),
                cx=float(cx),
                cy=float(cy),
                width=cam.width,
                height=cam.height,
                image_path=os.path.join(images_dir, im.name),
                image_name=im.name,
                depth_path=os.path.join(depths_dir, stem + ".png") if depths_dir else "",
                depth_params=dp,
                mask_path=os.path.join(masks_dir, stem + ".png") if masks_dir else "",
            )
        )
    return infos


def load_colmap_scene(
    source_path: str,
    images: str = "images",
    depths: str = "",
    masks: str = "",
    eval_split: bool = False,
    llffhold: int = 8,
) -> SceneInfo:
    """Load `source_path/sparse/0` (fallback `sparse`) + images dir.

    Split: `test.txt` file when present, else every llffhold-th image when
    eval_split (dataset_readers.py:269-282).
    """
    sparse = os.path.join(source_path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_path, "sparse")
    cams, imgs, (xyz, rgb, _err, _ids) = colmap.read_model(sparse)

    depth_params = None
    dp_path = os.path.join(source_path, "sparse", "0", "depth_params.json")
    if os.path.exists(dp_path):
        with open(dp_path) as f:
            depth_params = json.load(f)
        scales = [v["scale"] for v in depth_params.values() if isinstance(v, dict) and v.get("scale", 0) > 0]
        if scales:
            depth_params["med_scale"] = float(np.median(scales))

    infos = _camera_infos_from_colmap(
        cams,
        imgs,
        os.path.join(source_path, images),
        os.path.join(source_path, depths) if depths else "",
        depth_params,
        os.path.join(source_path, masks) if masks else "",
    )

    test_txt = os.path.join(source_path, "test.txt")
    if os.path.exists(test_txt):
        with open(test_txt) as f:
            test_names = {l.strip() for l in f if l.strip()}
        train = [c for c in infos if c.image_name not in test_names]
        test = [c for c in infos if c.image_name in test_names]
    elif eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    radius, center = get_nerfpp_norm(train if train else infos)
    return SceneInfo(
        train_cameras=train,
        test_cameras=test,
        points=xyz.astype(np.float32),
        colors=rgb.astype(np.float32) / 255.0,
        nerf_norm_radius=radius,
        nerf_norm_center=center,
    )
