"""Host-side camera/dataset containers.

Port of hidegs_tpu/data/cameras.py: the reference's Camera (image, alpha
mask, scaled inverse monodepth with reliability gating) and its lazy
CameraDataset with the resolution policy (incl. the 1.6K auto-downscale).
Images stay numpy on the host; `Camera.cam_params(device)` gives the port's
CameraParams on the caller's device.

Images decode through utils/png.py, which needs no Pillow. Resizing (a
`resolution_policy` scale other than 1) uses Pillow's LANCZOS (images) and
NEAREST (masks, depth) filters, as the JAX package does; that branch imports
Pillow only then and raises an ImportError without it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from hidegs_tpu_torch.core.camera_math import CameraParams, make_camera
from hidegs_tpu_torch.device import DeviceLike
from hidegs_tpu_torch.utils.png import read_image


@dataclass
class CameraInfo:
    """Lightweight metadata parsed from COLMAP (dataset_readers.py:85-147)."""

    uid: int
    R: np.ndarray  # (3,3) world→cam
    t: np.ndarray  # (3,)
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    image_path: str
    image_name: str
    depth_path: str = ""
    depth_params: Optional[dict] = None  # {scale, offset, med_scale}
    mask_path: str = ""


def resolution_policy(width: int, height: int, resolution: int = -1, max_side: int = 1600):
    """Reference resolution rules (camera_utils.py:23-60): explicit divisor if
    resolution ∈ {1,2,4,8}; otherwise auto-downscale so the longer side is
    ≤ 1.6K (with a warning in the reference)."""
    if resolution in (1, 2, 4, 8):
        scale = float(resolution)
    else:
        scale = max(1.0, max(width, height) / max_side)
    return int(round(width / scale)), int(round(height / scale)), scale


@dataclass
class Camera:
    """A loaded training camera: arrays on host, lazily materialized."""

    info: CameraInfo
    width: int
    height: int
    image: np.ndarray  # (3, H, W) float32 in [0,1]
    alpha_mask: Optional[np.ndarray] = None  # (H, W)
    invdepth: Optional[np.ndarray] = None  # (H, W) scaled inverse monodepth
    depth_reliable: bool = True
    gray: Optional[np.ndarray] = None  # (H, W) cached grayscale

    def cam_params(self, device: DeviceLike = "cuda") -> CameraParams:
        s = self.width / self.info.width
        sy = self.height / self.info.height
        return make_camera(
            self.info.R,
            self.info.t,
            fx=self.info.fx * s,
            fy=self.info.fy * sy,
            cx=self.info.cx * s,
            cy=self.info.cy * sy,
            height=self.height,
            width=self.width,
            device=device,
        )

    def grayscale(self) -> np.ndarray:
        if self.gray is None:
            self.gray = self.image.mean(axis=0)
        return self.gray


def _resize(arr: np.ndarray, w: int, h: int, method: str, path: str) -> np.ndarray:
    """Pillow's resize of the decoded pixels (the mode Pillow opens the file
    in), as the JAX package resizes before converting."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path} is {arr.shape[1]}x{arr.shape[0]} and must be resized to {w}x{h}; "
                          "resizing needs Pillow, which is not installed (load at --resolution 1)") from e
    return np.asarray(Image.fromarray(arr).resize((w, h), getattr(Image, method)))


def _sized(path: str, w: int, h: int, method: str) -> np.ndarray:
    arr = read_image(path)
    if arr.shape[:2] != (h, w):
        arr = _resize(arr, w, h, method, path)
    return arr


def to_rgb(arr: np.ndarray, path: str = "") -> np.ndarray:
    """Decoded 8-bit pixels → (H, W, 3), as Pillow's convert("RGB"):
    grayscale is repeated, alpha dropped."""
    if arr.dtype != np.uint8:
        raise ValueError(f"{path}: {arr.dtype} pixels; an image must be 8-bit")
    if arr.ndim == 2:
        return np.repeat(arr[..., None], 3, axis=-1)
    if arr.shape[-1] == 2:
        return np.repeat(arr[..., :1], 3, axis=-1)
    return arr[..., :3]


def to_gray(arr: np.ndarray, path: str = "") -> np.ndarray:
    """Decoded 8-bit pixels → (H, W), as Pillow's convert("L"): alpha
    dropped, RGB weighted by ITU-R 601-2 in Pillow's fixed point."""
    if arr.dtype != np.uint8:
        raise ValueError(f"{path}: {arr.dtype} pixels; a mask must be 8-bit")
    if arr.ndim == 2:
        return arr
    if arr.shape[-1] == 2:
        return arr[..., 0]
    rgb = arr[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def _load_image(path: str, w: int, h: int) -> np.ndarray:
    arr = to_rgb(_sized(path, w, h, "LANCZOS"), path).astype(np.float32) / 255.0
    return arr.transpose(2, 0, 1)


def _load_invdepth(path: str, w: int, h: int, params: Optional[dict]) -> Optional[np.ndarray]:
    """16-bit inverse-depth png scaled by per-image (scale, offset) with
    reliability gating vs med_scale (scene/cameras.py:101-119)."""
    if not path or not os.path.exists(path):
        return None, True
    inv = np.asarray(_sized(path, w, h, "NEAREST"), dtype=np.float32)
    if inv.ndim == 3:
        inv = inv[..., 0]
    inv = inv / 65535.0 if inv.max() > 255 else inv / 255.0
    reliable = True
    if params is not None:
        scale = float(params.get("scale", 1.0))
        offset = float(params.get("offset", 0.0))
        med = float(params.get("med_scale", scale if scale > 0 else 1.0))
        # reliability: per-image scale within [0.2x, 5x] of the scene median
        if med > 0 and (scale < 0.2 * med or scale > 5.0 * med):
            reliable = False
        inv = inv * scale + offset
    inv = np.maximum(inv, 0.0)
    return inv, reliable


def load_camera(info: CameraInfo, resolution: int = -1) -> Camera:
    w, h, _ = resolution_policy(info.width, info.height, resolution)
    image = _load_image(info.image_path, w, h)
    alpha = None
    if info.mask_path and os.path.exists(info.mask_path):
        # the JAX package converts to L before it resizes
        m = to_gray(read_image(info.mask_path), info.mask_path)
        if m.shape != (h, w):
            m = _resize(m, w, h, "NEAREST", info.mask_path)
        alpha = (np.asarray(m, dtype=np.float32) / 255.0 > 0.5).astype(np.float32)
    invdepth, reliable = (
        _load_invdepth(info.depth_path, w, h, info.depth_params)
        if info.depth_path
        else (None, True)
    )
    return Camera(
        info=info,
        width=w,
        height=h,
        image=image,
        alpha_mask=alpha,
        invdepth=invdepth,
        depth_reliable=reliable,
    )


class CameraDataset:
    """Lazy per-item loader (utils/camera_utils.py:122-144 CameraDataset):
    keeps CameraInfo metadata in memory, decodes images on access, with an
    optional LRU cache for small scenes."""

    def __init__(self, infos, resolution: int = -1, cache_all: bool = False):
        self.infos = list(infos)
        self.resolution = resolution
        self._cache = {} if cache_all else None

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, idx: int) -> Camera:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        cam = load_camera(self.infos[idx], self.resolution)
        if self._cache is not None:
            self._cache[idx] = cam
        return cam
