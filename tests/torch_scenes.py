"""Scenes written by the port for the pipeline tests (the CPU parity tests
and the card tests). Imports neither jax nor the JAX package."""
import numpy as np
import torch

from hidegs_tpu_torch.core.camera_math import make_camera
from hidegs_tpu_torch.core.sh import sh_dc_to_rgb
from hidegs_tpu_torch.core.transforms import rotmat_to_quat
from hidegs_tpu_torch.data import colmap
from hidegs_tpu_torch.data import synthetic as tsyn
from hidegs_tpu_torch.raster.api import RasterConfig, render
from hidegs_tpu_torch.utils.png import write_png


def write_two_cluster_scene(root):
    """A port of the JAX suite's `two_cluster_scene` fixture
    (tests/test_pipeline.py:12-77) as a COLMAP model under `root` (a
    pathlib.Path): two clusters of 80 toy gaussians 20 units apart, five
    40x40 views on a ring around each, in the XY plane, so that the XY-grid
    chunker separates them. Rendered on the CPU. Returns str(root)."""
    (root / "sparse" / "0").mkdir(parents=True)
    (root / "images").mkdir()
    H = W = 40
    cfg = RasterConfig(max_instances=1 << 13)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", W, H, np.array([0.9 * W, 0.9 * W, W / 2, H / 2]))}
    imgs, all_pts, all_cols, iid = {}, [], [], 1
    for cx, seed in [(-10.0, 0), (10.0, 1)]:
        s = tsyn.make_toy_gaussians(80, seed=seed, extent=2.0, device="cpu")
        pts = s.means3d + torch.tensor([cx, 0.0, 0.0])
        for k in range(5):
            ang = 2 * np.pi * k / 5
            pos = np.array([cx + 4.0 * np.sin(ang), 4.0 * np.cos(ang), -7.0])
            fwd = np.array([cx, 0.0, 0.0]) - pos
            fwd = fwd / np.linalg.norm(fwd)
            right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
            right /= np.linalg.norm(right)
            R = np.stack([right, np.cross(fwd, right), fwd])
            t = -R @ pos
            cam = make_camera(R, t, fx=0.9 * W, fy=0.9 * W, height=H, width=W, device="cpu")
            with torch.no_grad():
                img = torch.clamp(render(pts, s.scales, s.quats, s.opacities, s.shs, cam, config=cfg)["render"], 0, 1)
            name = f"v{iid:03d}.png"
            write_png(str(root / "images" / name), (img.permute(1, 2, 0).numpy() * 255).astype(np.uint8))
            q = rotmat_to_quat(torch.from_numpy(R[None].astype(np.float32))).numpy()[0]
            imgs[iid] = colmap.ColmapImage(iid, q.astype(np.float64), t.astype(np.float64), 1, name,
                                           np.zeros((0, 2)), np.zeros((0,), np.int64))
            iid += 1
        all_pts.append(pts[::2].numpy())
        all_cols.append(torch.clamp(sh_dc_to_rgb(s.shs[::2, 0, :]), 0, 1).numpy())
    colmap.write_cameras_binary(cams, str(root / "sparse/0/cameras.bin"))
    colmap.write_images_binary(imgs, str(root / "sparse/0/images.bin"))
    colmap.write_points3d_binary(np.concatenate(all_pts), (np.concatenate(all_cols) * 255).astype(np.uint8),
                                 str(root / "sparse/0/points3D.bin"))
    return str(root)
