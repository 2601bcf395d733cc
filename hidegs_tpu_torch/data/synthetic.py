"""Synthetic scenes and cameras for tests, smoke runs and benchmarks.

Port of the render-path part of hidegs_tpu/data/synthetic.py.
`make_uav_gaussians`, `ring_camera` and `nadir_grid_camera` are numpy
builders and reproduce the JAX package's arrays bit for bit.
`make_toy_gaussians` draws from a `torch.Generator`, whose numbers differ
from `jax.random`: tests that need the JAX toy scene build it with JAX and
convert it (convert.py). `make_blend_boundary_scene` builds screen-space
gaussians that stress the blend kernels' warp-block mask.
`write_synthetic_colmap_scene` renders a scene into a COLMAP-layout dataset
that `data/scene.py:load_scene`, `evaluate.py` and `render_cli.py` read;
`write_analytic_colmap_scene` (a ray-cast textured plane with spheres) and
`write_terrain_colmap_scene` (a ray-marched height field with 16-bit
monodepth maps and noisy sparse points) write datasets whose ground truth
lies outside the gaussian model class, for training runs.
"""
from __future__ import annotations

import json
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

# --------------------------------------------------------------------------
# Scenes with analytic ground truth: ray-cast images that are NOT in the
# gaussian model class, written as COLMAP datasets (numpy math, the JAX
# package's functions line for line; the images and monodepth maps go
# through utils/png.py).
# --------------------------------------------------------------------------


def _host_camera(cam: CameraParams):
    """(R, t, cx, cy, fx, fy) of `cam` on the host, R and t as float64
    arrays: one copy from the camera's device."""
    leaves = torch.cat([cam.R.reshape(-1), cam.t, torch.stack([cam.cx, cam.cy, cam.fx, cam.fy])])
    v = leaves.detach().cpu().numpy()
    return (v[:9].reshape(3, 3).astype(np.float64), v[9:12].astype(np.float64), v[12], v[13], v[14], v[15])


def _colmap_cameras(colmap, cam: CameraParams):
    """The one PINHOLE camera of a synthetic scene (principal point at the
    centre)."""
    H, W = cam.height, cam.width
    _, _, _, _, fx, fy = _host_camera(cam)
    return {1: colmap.ColmapCamera(1, "PINHOLE", W, H, np.array([float(fx), float(fy), W / 2, H / 2]))}


def _colmap_image(colmap, i: int, cam: CameraParams, name: str):
    from hidegs_tpu_torch.core.transforms import rotmat_to_quat

    R, t, *_ = _host_camera(cam)
    q = rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32)[None])[0].numpy()
    return colmap.ColmapImage(i, q.astype(np.float64), t, 1, name, np.zeros((0, 2)), np.zeros((0,), np.int64))


def procedural_texture(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """High-frequency procedural albedo at world ground coordinates (u, v).

    Checker + two sine octaves + hash-based value noise — content a finite
    gaussian mixture can approximate but never represent exactly, so quality
    deltas between loss configurations are meaningful (ground truth rendered
    FROM gaussians is fitted exactly by the model class). Returns (..., 3)
    in [0, 1].
    """
    checker = ((np.floor(u / 0.9) + np.floor(v / 0.9)) % 2.0) * 0.30
    fine = ((np.floor(u / 0.22) + np.floor(v / 0.22)) % 2.0) * 0.12
    waves = 0.14 * np.sin(5.3 * u) * np.cos(4.1 * v) + 0.10 * np.sin(17.0 * v + 2.0 * u)
    # deterministic value noise from an integer lattice hash, bilinear interp
    def hash01(ix, iy):
        h = (ix.astype(np.int64) * 374761393 + iy.astype(np.int64) * 668265263) % 2147483647
        h = (h ^ (h >> 13)) * 1274126177 % 2147483647
        return (h % 65536).astype(np.float64) / 65536.0

    gu, gv = u / 0.35, v / 0.35
    iu, iv = np.floor(gu), np.floor(gv)
    fu, fv = gu - iu, gv - iv
    n = (
        hash01(iu, iv) * (1 - fu) * (1 - fv)
        + hash01(iu + 1, iv) * fu * (1 - fv)
        + hash01(iu, iv + 1) * (1 - fu) * fv
        + hash01(iu + 1, iv + 1) * fu * fv
    )
    r = 0.38 + checker + 0.18 * (n - 0.5)
    g = 0.45 + waves + fine
    b = 0.33 + 0.22 * checker - 0.10 * waves + 0.12 * (n - 0.5)
    return np.clip(np.stack([r, g, b], axis=-1), 0.02, 0.98)


def render_analytic_scene(
    cam: CameraParams,
    spheres: np.ndarray = None,
    sphere_colors: np.ndarray = None,
    sky=(0.70, 0.80, 0.95),
    sun=(0.45, 0.35, 0.80),
) -> np.ndarray:
    """Exact ray-cast render of a procedurally-textured ground plane (z=0)
    plus lambertian spheres — analytic ground truth that is NOT in the
    gaussian model class. Returns (3, H, W) float32 in [0, 1].

    spheres: (K, 4) rows [cx, cy, cz, radius]; scene coords have +z up.
    """
    H, W = cam.height, cam.width
    R, t, cx_, cy_, fx_, fy_ = _host_camera(cam)
    origin = -R.T @ t  # camera center in world
    xs = (np.arange(W) + 0.5 - float(cx_)) / float(fx_)
    ys = (np.arange(H) + 0.5 - float(cy_)) / float(fy_)
    dx, dy = np.meshgrid(xs, ys)  # (H, W)
    d_cam = np.stack([dx, dy, np.ones_like(dx)], axis=-1)
    d_world = d_cam @ R  # rows of R are camera axes => d_world = Rᵀ d_cam
    d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)

    t_hit = np.full((H, W), np.inf)
    color = np.tile(np.asarray(sky, np.float64), (H, W, 1))

    # ground plane z = 0
    dz = d_world[..., 2]
    t_pl = np.where(np.abs(dz) > 1e-9, -origin[2] / dz, np.inf)
    ok = (t_pl > 1e-6) & (t_pl < t_hit)
    pu = origin[0] + t_pl * d_world[..., 0]
    pv = origin[1] + t_pl * d_world[..., 1]
    tex = procedural_texture(pu, pv)
    color = np.where(ok[..., None], tex, color)
    t_hit = np.where(ok, t_pl, t_hit)

    if spheres is not None:
        sundir = np.asarray(sun, np.float64)
        sundir = sundir / np.linalg.norm(sundir)
        for (cx_, cy_, cz_, rad), col in zip(np.asarray(spheres), np.asarray(sphere_colors)):
            oc = origin - np.array([cx_, cy_, cz_])
            b = np.einsum("hwc,c->hw", d_world, oc)
            c = oc @ oc - rad * rad
            disc = b * b - c
            t_sp = np.where(disc >= 0, -b - np.sqrt(np.maximum(disc, 0.0)), np.inf)
            ok = (t_sp > 1e-6) & (t_sp < t_hit)
            p = origin[None, None] + t_sp[..., None] * d_world
            n = (p - np.array([cx_, cy_, cz_])[None, None]) / rad
            lam = np.clip(np.einsum("hwc,c->hw", n, sundir), 0.0, 1.0) * 0.7 + 0.3
            shaded = np.asarray(col)[None, None] * lam[..., None]
            color = np.where(ok[..., None], shaded, color)
            t_hit = np.where(ok, t_sp, t_hit)

    return np.transpose(color, (2, 0, 1)).astype(np.float32)


def analytic_init_points(
    n_ground: int,
    extent_xy: float,
    spheres: np.ndarray = None,
    sphere_colors: np.ndarray = None,
    n_per_sphere: int = 400,
    seed: int = 0,
):
    """Noisy init point cloud for the analytic scene (plays COLMAP sparse
    points): ground samples colored by the true texture + sphere-surface
    samples. Returns (points (N,3), colors (N,3))."""
    rng = np.random.default_rng(seed)
    gx = rng.uniform(-extent_xy, extent_xy, n_ground)
    gy = rng.uniform(-extent_xy, extent_xy, n_ground)
    gz = rng.normal(0.0, 0.01, n_ground)
    cols = procedural_texture(gx, gy)
    pts = [np.stack([gx, gy, gz], -1)]
    cs = [cols]
    if spheres is not None:
        for (cx_, cy_, cz_, rad), col in zip(np.asarray(spheres), np.asarray(sphere_colors)):
            v = rng.normal(size=(n_per_sphere, 3))
            v /= np.linalg.norm(v, axis=-1, keepdims=True)
            pts.append(np.array([cx_, cy_, cz_]) + rad * v)
            cs.append(np.tile(np.asarray(col, np.float64)[None], (n_per_sphere, 1)))
    return (
        np.concatenate(pts).astype(np.float32),
        np.clip(np.concatenate(cs), 0, 1).astype(np.float32),
    )


def write_analytic_colmap_scene(
    root: str,
    cams,
    spheres: np.ndarray = None,
    sphere_colors: np.ndarray = None,
    extent_xy: float = 12.0,
    n_points: int = 12_000,
    seed: int = 0,
):
    """COLMAP-layout dataset whose GT images are the ANALYTIC ray-cast scene
    (render_analytic_scene) — ground truth outside the gaussian model class,
    so quality numbers measure reconstruction, not self-fitting
    (write_synthetic_colmap_scene's fits exactly by construction). Sparse points
    come from analytic_init_points (noisy ground/sphere samples standing in
    for triangulation)."""
    from hidegs_tpu_torch.data import colmap
    from hidegs_tpu_torch.utils.png import write_png

    os.makedirs(os.path.join(root, "sparse", "0"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    ccams = _colmap_cameras(colmap, cams[0])
    imgs = {}
    for i, cam in enumerate(cams, start=1):
        img = render_analytic_scene(cam, spheres, sphere_colors)
        name = f"v{i:04d}.png"
        write_png(os.path.join(root, "images", name),
                  (np.clip(img.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8))
        imgs[i] = _colmap_image(colmap, i, cam, name)
    pts, cols = analytic_init_points(
        n_points, extent_xy, spheres, sphere_colors, seed=seed
    )
    colmap.write_cameras_binary(ccams, os.path.join(root, "sparse/0/cameras.bin"))
    colmap.write_images_binary(imgs, os.path.join(root, "sparse/0/images.bin"))
    colmap.write_points3d_binary(
        pts.astype(np.float64), (cols * 255).astype(np.uint8),
        os.path.join(root, "sparse/0/points3D.bin"))
    return root


# --------------------------------------------------------------------------
# Realistic-image benchmark scene: a textured HEIGHT
# FIELD rendered with view-dependent lighting, plus synthetic monodepth with
# realistic error statistics and COLMAP-style noisy sparse points. Unlike
# the plane+spheres analytic scene, this workload carries the error modes
# the HiDeGS-specific losses exist for: parallax-dependent shading (multi-
# view NCC), smooth monodepth bias (depth reliability + multi-view geo),
# sharp texture over smooth geometry (frequency regularizer).
# --------------------------------------------------------------------------




def _value_noise(u, v, cell, seed=0):
    """Deterministic bilinear value noise on a lattice of size `cell`."""

    def hash01(ix, iy):
        h = (
            ix.astype(np.int64) * 374761393
            + iy.astype(np.int64) * 668265263
            + np.int64(seed) * 97002337
        ) % 2147483647
        h = (h ^ (h >> 13)) * 1274126177 % 2147483647
        return (h % 65536).astype(np.float64) / 65536.0

    gu, gv = u / cell, v / cell
    iu, iv = np.floor(gu), np.floor(gv)
    fu, fv = gu - iu, gv - iv
    fu = fu * fu * (3 - 2 * fu)  # smoothstep → C1 height field
    fv = fv * fv * (3 - 2 * fv)
    return (
        hash01(iu, iv) * (1 - fu) * (1 - fv)
        + hash01(iu + 1, iv) * fu * (1 - fv)
        + hash01(iu, iv + 1) * (1 - fu) * fv
        + hash01(iu + 1, iv + 1) * fu * fv
    )


def terrain_height(u, v, hmax: float = 2.4, seed: int = 0):
    """Smooth multi-octave height field h(u, v) ≥ 0 (+z up)."""
    h = (
        0.50 * _value_noise(u, v, 9.0, seed)
        + 0.30 * _value_noise(u, v, 3.7, seed + 1)
        + 0.14 * _value_noise(u, v, 1.6, seed + 2)
        + 0.06 * _value_noise(u, v, 0.7, seed + 3)
    )
    # gentle large-scale swell so oblique rays see silhouettes
    h = h + 0.18 * (1 + np.sin(0.21 * u + 0.8) * np.cos(0.17 * v - 0.4)) / 2
    return hmax * h


def _terrain_normal(u, v, hmax, seed, eps=0.05):
    hx = (terrain_height(u + eps, v, hmax, seed) - terrain_height(u - eps, v, hmax, seed)) / (2 * eps)
    hy = (terrain_height(u, v + eps, hmax, seed) - terrain_height(u, v - eps, hmax, seed)) / (2 * eps)
    n = np.stack([-hx, -hy, np.ones_like(hx)], axis=-1)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def render_terrain_scene(
    cam: CameraParams,
    extent_xy: float = 12.0,
    hmax: float = 2.4,
    seed: int = 0,
    sun=(0.45, 0.35, 0.80),
    sky=(0.70, 0.80, 0.95),
    n_steps: int = 160,
    n_bisect: int = 12,
):
    """Ray-marched render of the textured height field with Lambert + Blinn-
    Phong (view-dependent) shading. Returns ((3, H, W) image in [0, 1],
    (H, W) ray-hit distance with inf for sky)."""
    H, W = cam.height, cam.width
    R, t, cx_, cy_, fx_, fy_ = _host_camera(cam)
    origin = -R.T @ t
    xs = (np.arange(W) + 0.5 - float(cx_)) / float(fx_)
    ys = (np.arange(H) + 0.5 - float(cy_)) / float(fy_)
    dx, dy = np.meshgrid(xs, ys)
    d = np.stack([dx, dy, np.ones_like(dx)], axis=-1) @ R
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dz = d[..., 2]

    # march only descending rays, from just below the camera to the z=0 crossing
    desc = dz < -1e-4
    t_lo = np.where(desc, np.maximum((origin[2] - hmax) / -np.where(desc, dz, -1.0), 0.3), 0.3)
    t_hi = np.where(desc, (origin[2] - 0.0) / -np.where(desc, dz, -1.0) + 1.0, 1.0)

    # The march and the bisection evaluate the height field only on the
    # rays still looking for their crossing (descending, not hit yet), as
    # flat index subsets: every value is the elementwise result the JAX
    # package computes on the whole image, at a fraction of the work.
    dxf, dyf, dzf = d[..., 0].ravel(), d[..., 1].ravel(), dz.ravel()
    t_lo_f, t_hi_f = t_lo.ravel(), t_hi.ravel()
    hit_f = np.full(H * W, np.inf)
    act = np.flatnonzero(desc)
    prev_above = np.ones(act.shape, bool)
    prev_t = t_lo_f[act]
    for s in range(n_steps):
        lo, hi = t_lo_f[act], t_hi_f[act]
        tt = lo + (hi - lo) * (s / (n_steps - 1))
        px = origin[0] + tt * dxf[act]
        py = origin[1] + tt * dyf[act]
        pz = origin[2] + tt * dzf[act]
        above = pz > terrain_height(px, py, hmax, seed)
        crossed = prev_above & ~above
        # bracket [prev_t, tt] for newly crossed rays
        if crossed.any():
            ci = act[crossed]
            a, b = prev_t[crossed], tt[crossed]
            for _ in range(n_bisect):
                m = 0.5 * (a + b)
                mx = origin[0] + m * dxf[ci]
                my = origin[1] + m * dyf[ci]
                mz = origin[2] + m * dzf[ci]
                mabove = mz > terrain_height(mx, my, hmax, seed)
                a = np.where(mabove, m, a)
                b = np.where(mabove, b, m)
            hit_f[ci] = 0.5 * (a + b)
        act, prev_above, prev_t = act[~crossed], above[~crossed], tt[~crossed]
    hit_t = hit_f.reshape(H, W)
    hit = np.isfinite(hit_t)

    th = np.where(hit, hit_t, 1.0)
    pu = origin[0] + th * d[..., 0]
    pv = origin[1] + th * d[..., 1]
    albedo = procedural_texture(pu, pv)
    n = _terrain_normal(pu, pv, hmax, seed)
    # slope-tinted albedo (rockier on steep faces) — more texture variety
    slope = np.clip(1.0 - n[..., 2], 0.0, 1.0)
    albedo = albedo * (1.0 - 0.5 * slope[..., None]) + 0.5 * slope[..., None] * np.array([0.45, 0.40, 0.36])

    sund = np.asarray(sun, np.float64)
    sund /= np.linalg.norm(sund)
    lam = np.clip(np.einsum("hwc,c->hw", n, sund), 0.0, 1.0)
    # Blinn-Phong specular: view direction makes shading VIEW-DEPENDENT —
    # the same surface point changes appearance across cameras, which is the
    # photometric inconsistency the LNCC multi-view term is built for
    view = -d
    half = view + sund[None, None]
    half /= np.linalg.norm(half, axis=-1, keepdims=True) + 1e-9
    spec = np.clip(np.einsum("hwc,c->hw", n, sund) > 0, 0, 1) * (
        np.clip(np.einsum("hwc,hwc->hw", n, half), 0.0, 1.0) ** 32
    )
    shaded = albedo * (0.30 + 0.70 * lam)[..., None] + 0.18 * spec[..., None]

    # sky gradient for non-hit rays
    skyc = np.asarray(sky, np.float64)[None, None] * (
        0.85 + 0.15 * np.clip(dz, 0, 1)[..., None]
    )
    color = np.where(hit[..., None], shaded, skyc)
    return (
        np.transpose(np.clip(color, 0, 1), (2, 0, 1)).astype(np.float32),
        np.where(hit, hit_t, np.inf).astype(np.float32),
    )


def synthetic_monodepth(
    ray_depth: np.ndarray,  # (H, W) hit distance, inf = sky
    seed: int = 0,
    rel_err: float = 0.04,
    hole_frac: float = 0.01,
):
    """Corrupt true inverse depth the way a monodepth net fails: an unknown
    per-image affine (scale, offset), a SMOOTH low-frequency multiplicative
    error field (rel_err amplitude), and holes. Returns (uint16 png array,
    depth_params {scale, offset} that map png/65535 back to scene inverse
    depth up to the smooth error — exactly what make_depth_scale's robust
    fit would recover from COLMAP sparse depth)."""
    rng = np.random.default_rng(seed)
    H, W = ray_depth.shape
    inv = np.where(np.isfinite(ray_depth), 1.0 / np.maximum(ray_depth, 1e-6), 0.0)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    err = rel_err * _value_noise(
        xx / W * 6.0, yy / H * 6.0, 1.0, seed=seed + 11
    )
    err = 2.0 * (err / rel_err - 0.5) * rel_err  # [-rel_err, rel_err]
    inv_md = inv * (1.0 + err)
    # unknown per-image affine the depth_params must undo
    alpha = float(rng.uniform(0.6, 1.6))
    beta = float(rng.uniform(0.02, 0.1))
    raw = alpha * inv_md + beta
    raw[inv <= 0] = 0.0  # sky: no monodepth sample
    # random hole blotches (failed predictions)
    n_holes = max(int(hole_frac * H * W / 64), 1)
    for _ in range(n_holes):
        hy, hx = rng.integers(0, H), rng.integers(0, W)
        r = int(rng.integers(3, 9))
        raw[max(hy - r, 0):hy + r, max(hx - r, 0):hx + r] = 0.0
    mx = raw.max()
    png = np.clip(raw / max(mx, 1e-9) * 65535.0, 0, 65535).astype(np.uint16)
    # the loader first normalizes png→[0,1]: png/65535 = raw/mx, so
    # (png/65535)·(mx/α) − β/α = inv_md — the affine make_depth_scale's
    # robust fit would recover; the smooth `err` field remains as the
    # realistic residual the multi-view terms must handle
    params = {"scale": mx / alpha, "offset": -beta / alpha}
    return png, params


def _write_terrain_view(job):
    """Ray-march view i of the terrain scene and write its image and
    monodepth PNGs; returns (name, depth params)."""
    from hidegs_tpu_torch.utils.png import write_png

    root, i, cam, extent_xy, hmax, seed, depth_rel_err = job
    img, ray_depth = render_terrain_scene(cam, extent_xy=extent_xy, hmax=hmax, seed=seed)
    name = f"v{i:04d}"
    write_png(os.path.join(root, "images", name + ".png"),
              (np.clip(img.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8))
    png, params = synthetic_monodepth(ray_depth, seed=seed + i, rel_err=depth_rel_err)
    write_png(os.path.join(root, "depths", name + ".png"), png)
    return name, params


def _terrain_view_jobs(root, cams, extent_xy=12.0, hmax=2.4, seed=0, depth_rel_err=0.04):
    """The scene's directories, and one `_write_terrain_view` job per
    camera."""
    for sub in (os.path.join("sparse", "0"), "images", "depths"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    return [(root, i, cam, extent_xy, hmax, seed, depth_rel_err) for i, cam in enumerate(cams, start=1)]


def _write_terrain_sparse(root, cams, depth_params, extent_xy=12.0, hmax=2.4, n_points=16_000, seed=0,
                          point_noise=0.04, outlier_frac=0.01):
    """The scene's sparse/0: cameras, images, noisy points and the
    monodepth affine of each view."""
    from hidegs_tpu_torch.data import colmap

    ccams = _colmap_cameras(colmap, cams[0])
    imgs = {i: _colmap_image(colmap, i, cam, f"v{i:04d}.png") for i, cam in enumerate(cams, start=1)}

    # sparse points: surface samples with depth-proportional noise + outliers
    rng = np.random.default_rng(seed + 999)
    gx = rng.uniform(-extent_xy, extent_xy, n_points)
    gy = rng.uniform(-extent_xy, extent_xy, n_points)
    gz = terrain_height(gx, gy, hmax, seed)
    noise = rng.normal(0.0, point_noise, (n_points, 3))
    pts = np.stack([gx, gy, gz], -1) + noise
    n_out = int(outlier_frac * n_points)
    if n_out:
        idx = rng.choice(n_points, n_out, replace=False)
        pts[idx, 2] += rng.uniform(1.0, 6.0, n_out)  # floaters
    cols = procedural_texture(pts[:, 0], pts[:, 1])
    cols = np.clip(cols + rng.normal(0, 0.05, cols.shape), 0, 1)

    colmap.write_cameras_binary(ccams, os.path.join(root, "sparse/0/cameras.bin"))
    colmap.write_images_binary(imgs, os.path.join(root, "sparse/0/images.bin"))
    colmap.write_points3d_binary(
        pts.astype(np.float64), (cols * 255).astype(np.uint8),
        os.path.join(root, "sparse/0/points3D.bin"))
    with open(os.path.join(root, "sparse/0/depth_params.json"), "w") as f:
        json.dump(depth_params, f)


def write_terrain_colmap_scene(
    root: str,
    cams,
    extent_xy: float = 12.0,
    hmax: float = 2.4,
    n_points: int = 16_000,
    seed: int = 0,
    point_noise: float = 0.04,
    outlier_frac: float = 0.01,
    depth_rel_err: float = 0.04,
):
    """COLMAP-layout dataset for the realistic benchmark: ray-marched GT
    images, 16-bit monodepth pngs + sparse/0/depth_params.json, and noisy
    sparse points (triangulation noise ∝ depth + gross outliers)."""
    jobs = _terrain_view_jobs(root, cams, extent_xy, hmax, seed, depth_rel_err)
    depth_params = dict(map(_write_terrain_view, jobs))
    _write_terrain_sparse(root, cams, depth_params, extent_xy, hmax, n_points, seed, point_noise, outlier_frac)
    return root
