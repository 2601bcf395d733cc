"""Scene assembly: cameras + model init + multi-view neighbor graph.

Port of hidegs_tpu/data/scene.py (numpy only). Mirrors the reference's
scene/__init__.py:25-148: loads the COLMAP scene, builds the
train/test camera datasets, computes the multi-view neighbor graph (pairwise
camera distance + center-ray angle filtering, :82-130), and initializes the
Gaussian state from the point cloud (with optional skybox).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from hidegs_tpu_torch.data.cameras import CameraDataset, CameraInfo
from hidegs_tpu_torch.data.readers import SceneInfo, load_colmap_scene


def multi_view_neighbors(
    infos: List[CameraInfo],
    num_neighbors: int = 8,
    max_angle_deg: float = 30.0,
    min_dis: float = 0.01,
    max_dis: float = 1.5,
    scene_radius: float = 1.0,
) -> Dict[int, List[int]]:
    """Per-camera nearest-neighbor views (scene/__init__.py:82-130).

    Distance thresholds are relative to scene radius; angle is between the
    cameras' principal (+z) rays. Returns {camera index: [neighbor indices]}.
    """
    n = len(infos)
    if n == 0:
        return {}
    centers = np.stack([-info.R.T @ info.t for info in infos])  # (n, 3)
    fwd = np.stack([info.R[2] for info in infos])  # camera +z in world
    d = np.linalg.norm(centers[:, None] - centers[None, :], axis=-1)  # (n, n)
    cosang = np.clip(np.einsum("id,jd->ij", fwd, fwd), -1.0, 1.0)
    ang = np.degrees(np.arccos(cosang))

    rel_d = d / max(scene_radius, 1e-8)
    ok = (ang < max_angle_deg) & (rel_d > min_dis) & (rel_d < max_dis)
    np.fill_diagonal(ok, False)

    graph = {}
    for i in range(n):
        cand = np.where(ok[i])[0]
        order = cand[np.argsort(d[i, cand])]
        graph[i] = order[:num_neighbors].tolist()
    return graph


@dataclass
class Scene:
    """Loaded scene: camera datasets + init point cloud + neighbor graph."""

    info: SceneInfo
    train_cameras: CameraDataset
    test_cameras: CameraDataset
    neighbors: Dict[int, List[int]] = field(default_factory=dict)

    @property
    def extent(self) -> float:
        return self.info.nerf_norm_radius

    def save_multi_view_json(self, path: str):
        with open(path, "w") as f:
            json.dump(
                {self.train_cameras.infos[k].image_name: v for k, v in self.neighbors.items()},
                f,
            )


def load_scene(
    source_path: str,
    images: str = "images",
    depths: str = "",
    eval_split: bool = False,
    resolution: int = -1,
    multi_view_num: int = 8,
    multi_view_max_angle: float = 30.0,
    multi_view_min_dis: float = 0.01,
    multi_view_max_dis: float = 1.5,
    cache_all=False,
) -> Scene:
    """`cache_all` may be a bool or a callable(info) -> bool so callers can
    apply a RAM heuristic that needs the camera intrinsics (known from COLMAP
    before any image is decoded)."""
    info = load_colmap_scene(source_path, images=images, depths=depths, eval_split=eval_split)
    if callable(cache_all):
        cache_all = bool(cache_all(info))
    graph = multi_view_neighbors(
        info.train_cameras,
        num_neighbors=multi_view_num,
        max_angle_deg=multi_view_max_angle,
        min_dis=multi_view_min_dis,
        max_dis=multi_view_max_dis,
        scene_radius=info.nerf_norm_radius,
    )
    return Scene(
        info=info,
        train_cameras=CameraDataset(info.train_cameras, resolution, cache_all=cache_all),
        test_cameras=CameraDataset(info.test_cameras, resolution, cache_all=cache_all),
        neighbors=graph,
    )


def camera_to_json(idx: int, info) -> dict:
    """Viewer camera entry (utils/camera_utils.py:98-118 camera_to_JSON):
    camera-to-world rotation + world position, focals in pixels."""
    c2w_rot = np.asarray(info.R).T
    pos = -c2w_rot @ np.asarray(info.t)
    return {
        "id": idx,
        "img_name": info.image_name,
        "width": int(info.width),
        "height": int(info.height),
        "position": pos.tolist(),
        "rotation": [row.tolist() for row in c2w_rot],
        "fy": float(info.fy),
        "fx": float(info.fx),
    }


def save_scene_artifacts(scene: Scene, model_path: str) -> None:
    """Write the viewer-facing scene artifacts next to the checkpoints:
    cameras.json (all test+train cameras) and input.ply (the initialization
    point cloud) — Scene.__init__'s first-run dumps (scene/__init__.py:53-65),
    which the SIBR viewer reads to seed its camera paths."""
    import os

    from hidegs_tpu_torch.utils.ply import write_ply

    cams = []
    idx = 0
    for ds in (scene.test_cameras, scene.train_cameras):
        for info in getattr(ds, "infos", []):
            cams.append(camera_to_json(idx, info))
            idx += 1
    with open(os.path.join(model_path, "cameras.json"), "w") as f:
        json.dump(cams, f)

    pts = np.asarray(scene.info.points, np.float32)
    col = (np.clip(np.asarray(scene.info.colors), 0, 1) * 255).astype(np.uint8)
    write_ply(
        os.path.join(model_path, "input.ply"),
        {
            "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
            "red": col[:, 0], "green": col[:, 1], "blue": col[:, 2],
        },
    )
