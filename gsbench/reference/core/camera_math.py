# Frozen copy of hidegs_tpu_torch/core/camera_math.py:1-170 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Camera matrices, projections and ray generation.

Port of hidegs_tpu/core/camera_math.py. Conventions (COLMAP / reference):
  * `R` is world→camera rotation, `t` world→camera translation:
    X_cam = R @ X_world + t.  +z looks forward, +y down in image space.
  * Pixel coordinates: u = fx * x/z + cx, v = fy * y/z + cy; pixel (i, j)
    has its center at (j + 0.5, i + 0.5).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from gsbench.reference.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class CameraParams:
    """Pose and intrinsics as tensors on one device; image size as ints."""

    R: torch.Tensor  # (3, 3) world→camera rotation
    t: torch.Tensor  # (3,)   world→camera translation
    fx: torch.Tensor  # ()
    fy: torch.Tensor  # ()
    cx: torch.Tensor  # ()  principal point, pixels
    cy: torch.Tensor  # ()
    height: int
    width: int
    # Frustum extent used by the EWA tangent clamp. Differs from height/width
    # only for band crops: a crop keeps the FULL frame's clamp.
    full_height: int = 0  # 0 → height
    full_width: int = 0  # 0 → width

    def to(self, device: DeviceLike) -> "CameraParams":
        dev = resolve_device(device)
        return replace(
            self, R=self.R.to(dev), t=self.t.to(dev), fx=self.fx.to(dev),
            fy=self.fy.to(dev), cx=self.cx.to(dev), cy=self.cy.to(dev),
        )

    @property
    def device(self) -> torch.device:
        return self.R.device

    @property
    def frustum_height(self) -> int:
        return self.full_height or self.height

    @property
    def frustum_width(self) -> int:
        return self.full_width or self.width

    @property
    def camera_center(self) -> torch.Tensor:
        """World-space camera origin: -Rᵀ t."""
        return -self.R.T @ self.t

    @property
    def K(self) -> torch.Tensor:
        """3x3 intrinsics, stacked on the camera's device (no host copy)."""
        zero, one = torch.zeros_like(self.fx), torch.ones_like(self.fx)
        return torch.stack([torch.stack([self.fx, zero, self.cx]),
                            torch.stack([zero, self.fy, self.cy]),
                            torch.stack([zero, zero, one])])

    @property
    def K_inv(self) -> torch.Tensor:
        """Inverse intrinsics in closed form: the back substitution of the
        upper-triangular K, which is what an LU inverse computes for it."""
        zero, one = torch.zeros_like(self.fx), torch.ones_like(self.fx)
        return torch.stack([torch.stack([1.0 / self.fx, zero, -self.cx / self.fx]),
                            torch.stack([zero, 1.0 / self.fy, -self.cy / self.fy]),
                            torch.stack([zero, zero, one])])

    @property
    def fov_x(self) -> torch.Tensor:
        return 2.0 * torch.atan(torch.div(self.width, 2.0 * self.fx))

    @property
    def fov_y(self) -> torch.Tensor:
        return 2.0 * torch.atan(torch.div(self.height, 2.0 * self.fy))


def make_camera(
    R,
    t,
    fx,
    fy,
    cx=None,
    cy=None,
    height: int = 0,
    width: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = "cuda",
) -> CameraParams:
    """Build a camera from array-likes; the principal point defaults to the
    image center."""
    dev = resolve_device(device)
    if cx is None:
        cx = width / 2.0
    if cy is None:
        cy = height / 2.0

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    return CameraParams(
        R=tensor(R), t=tensor(t), fx=tensor(fx), fy=tensor(fy), cx=tensor(cx),
        cy=tensor(cy), height=int(height), width=int(width),
    )


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_camera(points: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """(N, 3) world points → camera frame."""
    return points @ cam.R.T + cam.t


def camera_to_world(points_cam: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    return (points_cam - cam.t) @ cam.R


def _safe_divisor(z: torch.Tensor, eps: float) -> torch.Tensor:
    """z, with |z| < eps replaced by ±eps (+eps at 0), as the JAX package
    guards its perspective divisions."""
    return torch.where(torch.abs(z) < eps, torch.sign(z) * eps + (z == 0) * eps, z)


def project_points(points_cam: torch.Tensor, cam: CameraParams, eps: float = 1e-6):
    """Camera-frame points → pixel coords (u, v) and depth z: ((..., 2),
    (...,)). No clipping; callers cull on z."""
    z = points_cam[..., 2]
    zs = _safe_divisor(z, eps)
    u = cam.fx * points_cam[..., 0] / zs + cam.cx
    v = cam.fy * points_cam[..., 1] / zs + cam.cy
    return torch.stack([u, v], dim=-1), z


def pixel_rays(cam: CameraParams) -> torch.Tensor:
    """Unit-z camera-space ray directions per pixel center, shape (H, W, 3)."""
    dev = cam.device
    v, u = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(cam.width, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    x = (u - cam.cx) / cam.fx
    y = (v - cam.cy) / cam.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def depth_to_points_cam(depth: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """(H, W) z-depth map → (H, W, 3) camera-space points."""
    return pixel_rays(cam) * depth[..., None]


def ndc_from_pixels(uv: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """Pixel coords → [-1, 1] NDC (grid-sample style lookups)."""
    u = uv[..., 0] / cam.width * 2.0 - 1.0
    v = uv[..., 1] / cam.height * 2.0 - 1.0
    return torch.stack([u, v], dim=-1)
