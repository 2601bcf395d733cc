"""Synthetic scenes and cameras for tests, smoke runs and benchmarks.

Port of the render-path part of hidegs_tpu/data/synthetic.py.
`make_uav_gaussians`, `ring_camera` and `nadir_grid_camera` are numpy
builders and reproduce the JAX package's arrays bit for bit.
`make_toy_gaussians` draws from a `torch.Generator`, whose numbers differ
from `jax.random`: tests that need the JAX toy scene build it with JAX and
convert it (convert.py). `make_blend_boundary_scene` builds screen-space
gaussians that stress the blend kernels' warp-block mask.
`write_synthetic_colmap_scene` renders a scene into a COLMAP-layout dataset
that `data/scene.py:load_scene`, `evaluate.py` and `render_cli.py` read.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from hidegs_tpu_torch.core.camera_math import CameraParams, make_camera
from hidegs_tpu_torch.core.sh import NUM_SH_COEFFS, rgb_to_sh_dc
from hidegs_tpu_torch.device import DeviceLike, resolve_device
from hidegs_tpu_torch.raster.preprocess import PreprocessedGaussians


class ToyScene(NamedTuple):
    means3d: torch.Tensor  # (N, 3)
    scales: torch.Tensor  # (N, 3) linear
    quats: torch.Tensor  # (N, 4) wxyz
    opacities: torch.Tensor  # (N,)
    shs: torch.Tensor  # (N, 16, 3)


def _dc_only_shs(rgb: torch.Tensor) -> torch.Tensor:
    shs = torch.zeros((rgb.shape[0], NUM_SH_COEFFS, 3), dtype=torch.float32, device=rgb.device)
    shs[:, 0, :] = rgb_to_sh_dc(rgb)
    return shs


def make_toy_gaussians(
    n: int,
    generator: Optional[torch.Generator] = None,
    extent: float = 2.0,
    scale_range=(0.02, 0.12),
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> ToyScene:
    """Random gaussians in a cube of half-width `extent`, DC-only color.
    Numbers are drawn on the CPU from `generator` (seeded with `seed` when
    None) and then moved to `device`, so a seed gives the same scene on any
    device."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator) * (hi - lo) + lo

    means = uniform((n, 3), -extent, extent)
    log_lo, log_hi = float(np.log(scale_range[0])), float(np.log(scale_range[1]))
    scales = torch.exp(uniform((n, 3), log_lo, log_hi))
    quats = torch.randn((n, 4), generator=generator)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    opac = uniform((n,), 0.3, 0.95)
    rgb = uniform((n, 3), 0.05, 0.95)
    return ToyScene(means.to(dev), scales.to(dev), quats.to(dev), opac.to(dev),
                    _dc_only_shs(rgb).to(dev))


def ring_camera(
    idx: int,
    n_cams: int = 8,
    radius: float = 6.0,
    height: int = 128,
    width: int = 128,
    focal: float = None,
    target=(0.0, 0.0, 0.0),
    device: DeviceLike = "cuda",
) -> CameraParams:
    """Camera `idx` on a horizontal ring looking at `target`."""
    if focal is None:
        focal = 0.9 * max(height, width)
    theta = 2.0 * np.pi * idx / n_cams
    pos = np.array([radius * np.sin(theta), -0.5, -radius * np.cos(theta)])
    tgt = np.asarray(target, dtype=np.float64)
    fwd = tgt - pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])  # image +y is down
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    # rows of R are camera axes in world coords (x=right, y=down, z=fwd)
    R = np.stack([right, down, fwd], axis=0)
    t = -R @ pos
    return make_camera(R, t, fx=focal, fy=focal, height=height, width=width, device=device)


def make_uav_gaussians(
    n_ground: int = 20_000,
    n_structs: int = 24,
    extent_xy: float = 12.0,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> ToyScene:
    """UAV-nadir-style scene: a textured ground sheet of thin disks at z≈0
    (checker + sine albedo + noise) plus box-like structures of splats
    (walls and roofs). n_ground + 160·n_structs gaussians."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    # ---- ground sheet ----
    gx = rng.uniform(-extent_xy, extent_xy, n_ground)
    gy = rng.uniform(-extent_xy, extent_xy, n_ground)
    gz = rng.normal(0.0, 0.02, n_ground)
    g_means = np.stack([gx, gy, gz], -1)
    cell = 2 * extent_xy / np.sqrt(n_ground)  # mean spacing
    g_scales = np.stack(
        [rng.uniform(0.8, 1.6, n_ground) * cell,
         rng.uniform(0.8, 1.6, n_ground) * cell,
         np.full(n_ground, 0.1 * cell)], -1)
    g_quats = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (n_ground, 1))
    checker = ((np.floor(gx / 1.5) + np.floor(gy / 1.5)) % 2) * 0.25
    waves = 0.15 * np.sin(3.1 * gx) * np.cos(2.7 * gy) + 0.1 * np.sin(11.0 * gy)
    base = np.stack([0.35 + checker, 0.45 + waves, 0.3 + 0.2 * checker], -1)
    g_rgb = np.clip(base + rng.normal(0, 0.08, (n_ground, 3)), 0.02, 0.98)
    g_opac = rng.uniform(0.7, 0.98, n_ground)

    # ---- structures: boxes of splats (walls + roof) ----
    s_means, s_scales, s_rgb = [], [], []
    for _ in range(n_structs):
        cx_, cy_ = rng.uniform(-0.8 * extent_xy, 0.8 * extent_xy, 2)
        w, d, h = rng.uniform(0.6, 1.8, 3) * np.array([1, 1, 1.6])
        col = rng.uniform(0.2, 0.9, 3)
        m = 160
        face = rng.integers(0, 5, m)
        u, v = rng.uniform(-1, 1, (2, m))
        px = np.where(face == 0, -w, np.where(face == 1, w, u * w))
        py = np.where(face == 2, -d, np.where(face == 3, d, v * d))
        # the first draw is overwritten; it stays to keep the random stream
        # identical to the JAX package's builder
        pz = np.where(face == 4, h, (rng.uniform(0, 1, m)) * h)
        pz = np.where(face < 4, rng.uniform(0, 1, m) * h, h)
        s_means.append(np.stack([cx_ + px, cy_ + py, pz], -1))
        s_scales.append(np.full((m, 3), 0.12) * rng.uniform(0.7, 1.5, (m, 1)))
        s_rgb.append(np.clip(col + rng.normal(0, 0.06, (m, 3)), 0.05, 0.95))
    means = np.concatenate([g_means] + s_means).astype(np.float32)
    scales = np.concatenate([g_scales] + s_scales).astype(np.float32)
    rgb = np.concatenate([g_rgb] + s_rgb).astype(np.float32)
    n = means.shape[0]
    quats = np.concatenate(
        [g_quats, np.tile(np.array([1.0, 0, 0, 0]), (n - n_ground, 1))]
    ).astype(np.float32)
    opac = np.concatenate(
        [g_opac, rng.uniform(0.75, 0.98, n - n_ground)]
    ).astype(np.float32)

    def tensor(x):
        return torch.as_tensor(x, device=dev)

    return ToyScene(tensor(means), tensor(scales), tensor(quats), tensor(opac),
                    _dc_only_shs(tensor(rgb)))


def nadir_grid_camera(
    ix: int, iy: int, nx: int, ny: int,
    extent_xy: float = 12.0, altitude: float = 14.0, tilt: float = 0.12,
    height: int = 256, width: int = 256, focal: float = None,
    device: DeviceLike = "cuda",
) -> CameraParams:
    """Camera (ix, iy) of a UAV lawnmower grid: near-nadir, with a slight
    alternating tilt."""
    if focal is None:
        focal = 0.9 * max(height, width)
    margin = 0.75
    x = (-margin + 2 * margin * ix / max(nx - 1, 1)) * extent_xy
    y = (-margin + 2 * margin * iy / max(ny - 1, 1)) * extent_xy
    pos = np.array([x, y, altitude])
    # look mostly straight down (+z is up in scene coords)
    ang = tilt * (1 if (ix + iy) % 2 == 0 else -1)
    fwd = np.array([np.sin(ang), 0.02, -np.cos(ang)])
    fwd /= np.linalg.norm(fwd)
    up_hint = np.array([0.0, 1.0, 0.0])
    right = np.cross(up_hint, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    t = -R @ pos
    return make_camera(R, t, fx=focal, fy=focal, height=height, width=width, device=device)


BOUNDARY_FAMILIES = ("random", "corner", "edge", "thin", "opacity")


def make_blend_boundary_scene(
    families=BOUNDARY_FAMILIES,
    height: int = 64,
    width: int = 96,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> PreprocessedGaussians:
    """Screen-space gaussians (already preprocessed) whose α ≥ 1/255 level
    set ends on the boundary of an 8x4 pixel block, the unit of the blend
    kernels' warp-block mask. Blocks tile the canvas from (0, 0) at tile 16
    and 32 alike. With q_budget = ln(255·op), the families are:

      random   seeded means, scales, angles and opacities;
      corner   the level set q = t touches a block's corner pixel centre
               from outside, t = q_budget·(1 ± 1e-6) or (q_budget + 1e-3)·
               (1 ± 1e-6) (the mask's own margin);
      edge     the same at a pixel centre on a block's edge;
      thin     corner and edge cases with thin covariances (σ 20-200 by
               0.2-0.6 px) and near-singular conics (b² = ac·(1 - δ)²);
      opacity  corner cases with op at 1/255·(1 ± 1e-5), 1/255·(1 + 1e-3)
               and 0.99-1.0 (α clamps at 0.99).

    All numbers come from numpy with `seed`, in float64, rounded once to
    float32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rows = []  # (mean_x, mean_y, a, b, c, op)

    def rotated_conic(s1, s2, ang):
        rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        conic = np.linalg.inv(rot @ np.diag([s1 * s1, s2 * s2]) @ rot.T)
        return conic[0, 0], conic[0, 1], conic[1, 1]

    def random_conic():
        s1, s2 = np.exp(rng.uniform(np.log(0.4), np.log(16.0), 2))
        return rotated_conic(s1, s2, rng.uniform(0, np.pi))

    def thin_conic():
        if rng.random() < 0.5:
            ang = rng.choice([0.0, 1e-3, np.pi / 4, rng.uniform(0, np.pi)])
            return rotated_conic(rng.uniform(20, 200), rng.uniform(0.2, 0.6), ang)
        a = np.exp(rng.uniform(np.log(0.05), np.log(5.0)))
        c = a * np.exp(rng.uniform(-2.0, 2.0))
        delta = rng.choice([1e-3, 1e-5])
        return a, rng.choice([-1.0, 1.0]) * np.sqrt(a * c) * (1.0 - delta), c

    def target(op):
        q_budget = np.log(255.0 * op)
        base = q_budget + rng.choice([0.0, 1e-3])
        return base * (1.0 + rng.choice([-1e-6, 1e-6]))

    def random_block():
        bx, by = rng.integers(0, width // 8), rng.integers(0, height // 4)
        return 8 * bx + 0.5, 4 * by + 0.5  # top-left pixel centre

    def place(conic, op, where):
        """A mean whose level set q = target(op) touches the chosen point
        of a random block from outside, where the box minimum lies: the
        gradient of q there is an outward normal of the block."""
        a, b, c = conic
        A = np.array([[a, b], [b, c]])
        x0, y0 = random_block()
        if where == "corner":
            sx, sy = rng.choice([-1.0, 1.0], 2)
            p = np.array([x0 + (7.0 if sx > 0 else 0.0), y0 + (3.0 if sy > 0 else 0.0)])
            grad = np.array([sx * rng.uniform(0.2, 1.0), sy * rng.uniform(0.2, 1.0)])
        else:
            side = rng.integers(0, 4)
            if side < 2:  # left / right edge, at a pixel row inside the block
                p = np.array([x0 + 7.0 * side, y0 + rng.integers(1, 3)])
                grad = np.array([1.0 if side else -1.0, 0.0])
            else:  # top / bottom edge, at a pixel column inside the block
                p = np.array([x0 + rng.integers(1, 7), y0 + 3.0 * (side - 2)])
                grad = np.array([0.0, 1.0 if side == 3 else -1.0])
        # d = p - mean with A d = -g·grad (q rises into the block), scaled
        # so that q(p) = ½ dᵀ A d = t
        d = -np.linalg.solve(A, grad)
        d *= np.sqrt(2.0 * max(target(op), 0.0) / float(d @ A @ d))
        rows.append((*(p - d), a, b, c, op))

    for family in families:
        if family == "random":
            for _ in range(150):
                a, b, c = random_conic()
                rows.append((rng.uniform(-8, width + 8), rng.uniform(-8, height + 8), a, b, c,
                             rng.uniform(0.01, 1.0)))
        elif family in ("corner", "edge"):
            for _ in range(96):
                if rng.random() < 0.5:
                    conic = random_conic()
                else:  # isotropic
                    a = np.exp(rng.uniform(np.log(0.05), np.log(2.0)))
                    conic = (a, 0.0, a)
                place(conic, rng.uniform(0.05, 1.0), family)
        elif family == "thin":
            for _ in range(96):
                place(thin_conic(), rng.uniform(0.05, 1.0), rng.choice(["corner", "edge"]))
        elif family == "opacity":
            ops = [(1 - 1e-5) / 255, (1 + 1e-5) / 255, (1 + 1e-3) / 255, 0.99, 0.995, 1.0]
            for op in ops * 8:
                place(random_conic(), op, rng.choice(["corner", "edge"]))
        else:
            raise ValueError(f"unknown family {family!r}; expected one of {BOUNDARY_FAMILIES}")

    g = np.asarray(rows, dtype=np.float64)
    n = g.shape[0]
    det = g[:, 2] * g[:, 4] - g[:, 3] ** 2
    sigma_max = np.sqrt(np.maximum(g[:, 2], g[:, 4]) / np.maximum(det, 1e-12))
    depth = rng.uniform(1.0, 10.0, n)
    normal = rng.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    return PreprocessedGaussians(
        mean2d=tensor(g[:, 0:2]),
        conic=tensor(g[:, 2:5]),
        depth=tensor(depth),
        inv_depth=tensor(1.0 / depth),
        opacity=tensor(g[:, 5]),
        rgb=tensor(rng.uniform(0.05, 0.95, (n, 3))),
        normal=tensor(normal),
        distance=tensor(rng.uniform(0.5, 5.0, n)),
        radius=tensor(np.minimum(np.ceil(3.0 * sigma_max), 4096), torch.int32),
        visible=torch.ones((n,), dtype=torch.bool, device=dev),
    )


def write_synthetic_colmap_scene(
    root: str,
    scene: ToyScene,
    cams,
    render_config=None,
    point_stride: int = 4,
    jitter_points: float = 0.0,
    seed: int = 0,
):
    """Render `scene` from `cams` and write a COLMAP-layout dataset
    (sparse/0/*.bin + images/*.png), as hidegs_tpu/data/synthetic.py:
    write_synthetic_colmap_scene does. The renders run through the port's
    `render` on the scene's device; the PNGs go through utils/png.py.
    `point_stride` thins the gaussian centers into the sparse point cloud
    (COLMAP sparse points are far sparser than the final model);
    `jitter_points` adds noise like real triangulation error."""
    from hidegs_tpu_torch.core.sh import sh_dc_to_rgb
    from hidegs_tpu_torch.core.transforms import rotmat_to_quat
    from hidegs_tpu_torch.data import colmap
    from hidegs_tpu_torch.raster.api import RasterConfig, render
    from hidegs_tpu_torch.utils.png import write_png

    if render_config is None:
        render_config = RasterConfig(max_instances=1 << 18)
    os.makedirs(os.path.join(root, "sparse", "0"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)

    H, W = cams[0].height, cams[0].width
    ccams = {1: colmap.ColmapCamera(
        1, "PINHOLE", W, H,
        np.array([float(cams[0].fx), float(cams[0].fy), W / 2, H / 2]))}
    imgs = {}
    for i, cam in enumerate(cams, start=1):
        with torch.no_grad():
            out = render(*scene, cam, config=render_config)
        img = np.clip(out["render"].cpu().numpy().transpose(1, 2, 0), 0, 1)
        name = f"v{i:04d}.png"
        write_png(os.path.join(root, "images", name), (img * 255).astype(np.uint8))
        q = rotmat_to_quat(cam.R.cpu()[None])[0].numpy()
        imgs[i] = colmap.ColmapImage(
            i, q.astype(np.float64), cam.t.cpu().numpy().astype(np.float64), 1, name,
            np.zeros((0, 2)), np.zeros((0,), np.int64))

    rng = np.random.default_rng(seed)
    pts = scene.means3d[::point_stride].cpu().numpy().astype(np.float64)
    if jitter_points:
        pts = pts + rng.normal(0, jitter_points, pts.shape)
    cols = np.clip(sh_dc_to_rgb(scene.shs[::point_stride, 0, :]).cpu().numpy(), 0, 1)
    colmap.write_cameras_binary(ccams, os.path.join(root, "sparse/0/cameras.bin"))
    colmap.write_images_binary(imgs, os.path.join(root, "sparse/0/images.bin"))
    colmap.write_points3d_binary(
        pts, (cols * 255).astype(np.uint8), os.path.join(root, "sparse/0/points3D.bin"))
    return root
