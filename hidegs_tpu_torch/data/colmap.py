"""COLMAP model parsers (binary + text) and writers.

The port's own copy of hidegs_tpu/data/colmap.py: the standard COLMAP
format readers of the reference (scene/colmap_loader.py:83-271) as plain
NumPy, host-side IO. Supports cameras.bin/txt, images.bin/txt,
points3D.bin/txt.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# COLMAP camera model ids → (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (M, 2)
    point3d_ids: np.ndarray  # (M,)


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, width, height = _read(f, 24, "iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * num_params, "d" * num_params))
            out[cid] = ColmapCamera(cid, name, int(width), int(height), params)
    return out


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cid = int(el[0])
            out[cid] = ColmapCamera(
                cid, el[1], int(el[2]), int(el[3]), np.array([float(p) for p in el[4:]])
            )
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            (iid,) = _read(f, 4, "i")
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            (camera_id,) = _read(f, 4, "i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, 8, "Q")
            data = np.frombuffer(f.read(24 * num_pts), dtype=np.float64).reshape(-1, 3)
            xys = data[:, :2].copy()
            ids = np.frombuffer(
                np.ascontiguousarray(data[:, 2]).tobytes(), dtype=np.int64
            ).copy()
            out[iid] = ColmapImage(
                iid, qvec, tvec, camera_id, name.decode("utf-8"), xys, ids
            )
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f if not l.startswith("#")]
    # format: 2 lines per image; the POINTS2D line is EMPTY for images with
    # no triangulated points, so it must NOT be filtered out (the reference
    # reads it unconditionally, colmap_loader.py) — skip empties only when
    # expecting a header.
    i = 0
    while i < len(lines):
        header = lines[i].strip()
        i += 1
        if not header:
            continue
        pts_line = lines[i].strip() if i < len(lines) else ""
        i += 1
        el = header.split()
        iid = int(el[0])
        qvec = np.array([float(x) for x in el[1:5]])
        tvec = np.array([float(x) for x in el[5:8]])
        camera_id = int(el[8])
        name = el[9]
        pts = pts_line.split()
        xys = np.array([float(x) for x in pts], dtype=np.float64)
        if xys.size:
            xys = xys.reshape(-1, 3)
            p3d = xys[:, 2].astype(np.int64)
            xys = xys[:, :2]
        else:
            xys = np.zeros((0, 2))
            p3d = np.zeros((0,), np.int64)
        out[iid] = ColmapImage(iid, qvec, tvec, camera_id, name, xys, p3d)
    return out


def read_points3d_binary(path: str):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, errors (N,), ids (N,) i64)."""
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty(num)
        ids = np.empty(num, np.int64)
        for i in range(num):
            data = _read(f, 43, "QdddBBBd")
            ids[i] = data[0]
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, 8, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb, err, ids


def read_points3d_text(path: str):
    xyz, rgb, err, ids = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            ids.append(int(el[0]))
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([int(x) for x in el[4:7]])
            err.append(float(el[7]))
    return (
        np.array(xyz).reshape(-1, 3),
        np.array(rgb, np.uint8).reshape(-1, 3),
        np.array(err),
        np.array(ids, np.int64),
    )


def write_cameras_binary(cams: Dict[int, ColmapCamera], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(imgs: Dict[int, ColmapImage], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.xys)
            f.write(struct.pack("<Q", n))
            for (x, y), pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def write_points3d_binary(xyz: np.ndarray, rgb: np.ndarray, path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(
                struct.pack(
                    "<QdddBBBd",
                    i,
                    *xyz[i],
                    int(rgb[i][0]),
                    int(rgb[i][1]),
                    int(rgb[i][2]),
                    0.0,
                )
            )
            f.write(struct.pack("<Q", 0))  # empty track


def read_model(sparse_dir: str):
    """Auto-detect bin/txt model in `sparse_dir` → (cameras, images, points)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        pts = read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
        pts = read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, pts
