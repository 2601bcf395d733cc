"""The training input of a UAV configuration, made in memory from a seed:
the views (targets rendered from the analytic terrain, inverse depth with
a seeded relative error), the initial points on the analytic surfaces and
the multi-view neighbour graph. `TrainScene` has the attributes that
`hidegs_tpu_torch.train.trainer.train(scene=...)` reads of a loaded scene,
so the program takes it as it takes a COLMAP scene."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from gsbench.scenes import flight, uav


def multi_view_neighbors(centres: np.ndarray, forwards: np.ndarray, scene_radius: float, num_neighbors: int = 8,
                         max_angle_deg: float = 30.0, min_dis: float = 0.01, max_dis: float = 1.5):
    """Each view's nearest views whose principal rays differ by less than
    max_angle_deg, within (min_dis, max_dis) scene radii. Frozen copy of
    hidegs_tpu_torch/data/scene.py:22-50 (multi_view_neighbors) at commit
    63641d3, on arrays of centres and forward axes."""
    n = len(centres)
    d = np.linalg.norm(centres[:, None] - centres[None, :], axis=-1)
    ang = np.degrees(np.arccos(np.clip(np.einsum("id,jd->ij", forwards, forwards), -1.0, 1.0)))
    rel_d = d / max(scene_radius, 1e-8)
    ok = (ang < max_angle_deg) & (rel_d > min_dis) & (rel_d < max_dis)
    np.fill_diagonal(ok, False)
    graph = {}
    for i in range(n):
        cand = np.where(ok[i])[0]
        graph[i] = cand[np.argsort(d[i, cand])][:num_neighbors].tolist()
    return graph


@dataclass
class ViewInfo:
    image_path: str
    image_name: str


@dataclass
class TrainView:
    """One training view as the trainer reads it (data/cameras.py:Camera):
    the image on the device, the inverse depth on the host."""

    info: ViewInfo
    pose: flight.Pose
    width: int
    height: int
    image: torch.Tensor  # (3, H, W) on the device
    invdepth: np.ndarray  # (H, W)
    gray: torch.Tensor  # (H, W) on the device
    depth_reliable: bool = True
    alpha_mask: Optional[np.ndarray] = None

    def cam_params(self, device):
        from hidegs_tpu_torch.core.camera_math import make_camera

        p = self.pose
        return make_camera(p.R, p.t, fx=p.fx, fy=p.fy, cx=p.cx, cy=p.cy, height=p.height, width=p.width,
                           device=device)

    def grayscale(self) -> torch.Tensor:
        return self.gray


class TrainViews:
    """The view list, indexed as the trainer indexes its camera dataset."""

    def __init__(self, views: List[TrainView]):
        self.views = views

    def __len__(self):
        return len(self.views)

    def __getitem__(self, idx: int) -> TrainView:
        return self.views[idx]


@dataclass
class SceneInfo:
    points: np.ndarray  # (n, 3) float32
    colors: np.ndarray  # (n, 3) float32 in [0, 1]
    nerf_norm_center: np.ndarray
    nerf_norm_radius: float


@dataclass
class TrainScene:
    info: SceneInfo
    train_cameras: TrainViews
    neighbors: Dict[int, List[int]] = field(default_factory=dict)

    @property
    def extent(self) -> float:
        return self.info.nerf_norm_radius


def flight_poses(cfg: dict) -> List[flight.Pose]:
    f = cfg["flight"]
    return flight.lawnmower(f["cols"], f["rows"], cfg["extent_xy"], f["margin"], f["altitude"], f["oblique_deg"],
                            cfg["width"], cfg["height"], cfg["focal_px"])


def build(cfg: dict, seed: int, device) -> TrainScene:
    """The training scene of configuration `cfg` for `seed`."""
    dev = torch.device(device)
    terrain = uav.Terrain(cfg["layout_seed"], dev, extent_xy=cfg["extent_xy"], hmax=cfg["terrain_hmax"],
                          n_boxes=cfg["n_structs"])
    g = uav.generator(seed, dev)
    pts, cols = terrain.sample_points(g, cfg["n_ground"], cfg["per_struct"])
    poses = flight_poses(cfg)
    assert len(poses) == cfg["views"], (len(poses), cfg["views"])
    H, W = cfg["height"], cfg["width"]
    views = []
    for i, p in enumerate(poses):
        o, d, norm = uav.view_rays(p.R, p.t, p.fx, p.fy, p.cx, p.cy, H, W, dev)
        colour, dist = terrain.cast(o.expand_as(d), d)
        image = colour.T.reshape(3, H, W).contiguous()
        inv = uav.synthetic_inverse_depth(dist / norm, g, H, W, rel_err=cfg["depth_rel_err"])
        views.append(TrainView(info=ViewInfo(image_path=f"gsbench/view{i:03d}", image_name=f"view{i:03d}"),
                               pose=p, width=W, height=H, image=image, invdepth=inv.cpu().numpy(),
                               gray=image.mean(dim=0)))
    centres = np.stack([p.centre for p in poses])
    centre = centres.mean(axis=0)
    radius = 1.1 * float(np.linalg.norm(centres - centre, axis=1).max())
    forwards = np.stack([p.R[2] for p in poses])
    mv = cfg["multi_view"]
    graph = multi_view_neighbors(centres, forwards, radius, mv["num"], mv["max_angle"], mv["min_dis"], mv["max_dis"])
    info = SceneInfo(points=pts.cpu().numpy().astype(np.float32), colors=cols.cpu().numpy().astype(np.float32),
                     nerf_norm_center=centre, nerf_norm_radius=radius)
    return TrainScene(info=info, train_cameras=TrainViews(views), neighbors=graph)
