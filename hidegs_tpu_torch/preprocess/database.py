"""COLMAP SQLite database API + model→database fill.

The port's own copy of hidegs_tpu/preprocess/database.py (sqlite3, numpy).

Equivalent of the reference's `preprocess/database.py` (COLMAP's standard
schema API, :145) and `preprocess/fill_database.py` (populate a fresh
database from a sparse model so per-chunk feature extraction / matching /
triangulation can run against known poses). Pure sqlite3 + numpy — fully
functional without COLMAP installed (unlike the wrappers that need the COLMAP
binary).

Schema follows the public COLMAP database layout: cameras, images,
keypoints, descriptors, matches, two_view_geometries. pair_id packing uses
COLMAP's convention pair_id = image_id1 * MAX_IMAGE_ID + image_id2 with the
smaller id first.
"""
from __future__ import annotations

import sqlite3
from typing import Dict, Optional

import numpy as np

from hidegs_tpu_torch.data.colmap import (
    CAMERA_MODEL_IDS,
    CAMERA_MODELS,
    ColmapCamera,
    ColmapImage,
)

MAX_IMAGE_ID = 2**31 - 1
CAMERA_MODEL_NAMES = {mid: name for mid, (name, _) in CAMERA_MODELS.items()}

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int):
    image_id2 = pair_id % MAX_IMAGE_ID
    image_id1 = (pair_id - image_id2) // MAX_IMAGE_ID
    return int(image_id1), int(image_id2)


def _blob(arr: np.ndarray, dtype) -> bytes:
    return np.ascontiguousarray(arr, dtype).tobytes()


class COLMAPDatabase(sqlite3.Connection):
    """sqlite3 connection with COLMAP-schema helpers."""

    @staticmethod
    def connect(path: str) -> "COLMAPDatabase":
        return sqlite3.connect(path, factory=COLMAPDatabase)

    def create_tables(self):
        self.executescript(_SCHEMA)

    # ---------------------------------------------------------- add rows
    def add_camera(
        self,
        model,
        width: int,
        height: int,
        params: np.ndarray,
        prior_focal_length: bool = True,
        camera_id: Optional[int] = None,
    ) -> int:
        if isinstance(model, str):
            model = CAMERA_MODEL_IDS[model]
        cur = self.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (
                camera_id,
                int(model),
                int(width),
                int(height),
                _blob(np.asarray(params), np.float64),
                int(prior_focal_length),
            ),
        )
        return cur.lastrowid

    def add_image(
        self,
        name: str,
        camera_id: int,
        prior_q: Optional[np.ndarray] = None,
        prior_t: Optional[np.ndarray] = None,
        image_id: Optional[int] = None,
    ) -> int:
        q = np.full(4, np.nan) if prior_q is None else np.asarray(prior_q, float)
        t = np.full(3, np.nan) if prior_t is None else np.asarray(prior_t, float)
        cur = self.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, int(camera_id), *q.tolist(), *t.tolist()),
        )
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray):
        keypoints = np.asarray(keypoints, np.float32)
        assert keypoints.ndim == 2 and keypoints.shape[1] in (2, 4, 6)
        self.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (int(image_id), *keypoints.shape, _blob(keypoints, np.float32)),
        )

    def add_descriptors(self, image_id: int, descriptors: np.ndarray):
        descriptors = np.asarray(descriptors, np.uint8)
        self.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (int(image_id), *descriptors.shape, _blob(descriptors, np.uint8)),
        )

    def add_matches(self, image_id1: int, image_id2: int, matches: np.ndarray):
        matches = np.asarray(matches, np.uint32)
        assert matches.ndim == 2 and matches.shape[1] == 2
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        self.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (pair_id, *matches.shape, _blob(matches, np.uint32)),
        )

    def add_two_view_geometry(
        self,
        image_id1: int,
        image_id2: int,
        matches: np.ndarray,
        F=None,
        E=None,
        H=None,
        config: int = 2,
    ):
        matches = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        F = np.eye(3) if F is None else np.asarray(F)
        E = np.eye(3) if E is None else np.asarray(E)
        H = np.eye(3) if H is None else np.asarray(H)
        self.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (
                pair_id,
                *matches.shape,
                _blob(matches, np.uint32),
                int(config),
                _blob(F, np.float64),
                _blob(E, np.float64),
                _blob(H, np.float64),
                _blob(np.array([1.0, 0, 0, 0]), np.float64),
                _blob(np.zeros(3), np.float64),
            ),
        )

    # --------------------------------------------------------- read rows
    def read_cameras(self) -> Dict[int, ColmapCamera]:
        out = {}
        for cid, model, w, h, params, _prior in self.execute(
            "SELECT camera_id, model, width, height, params, prior_focal_length "
            "FROM cameras"
        ):
            out[cid] = ColmapCamera(
                id=cid,
                model=CAMERA_MODEL_NAMES.get(model, str(model)),
                width=int(w),
                height=int(h),
                params=np.frombuffer(params, np.float64).copy(),
            )
        return out

    def read_images(self) -> Dict[int, "ColmapImage"]:
        out = {}
        for iid, name, cid, qw, qx, qy, qz, tx, ty, tz in self.execute(
            "SELECT image_id, name, camera_id, prior_qw, prior_qx, prior_qy, "
            "prior_qz, prior_tx, prior_ty, prior_tz FROM images"
        ):
            out[iid] = ColmapImage(
                id=iid,
                qvec=np.array([qw, qx, qy, qz], float),
                tvec=np.array([tx, ty, tz], float),
                camera_id=cid,
                name=name,
                xys=np.zeros((0, 2)),
                point3d_ids=np.zeros((0,), np.int64),
            )
        return out


def fill_database_from_model(sparse_dir: str, database_path: str):
    """Create a fresh COLMAP database seeded with a sparse model's cameras and
    images (with pose priors) — the reference's preprocess/fill_database.py
    step that precedes per-chunk feature extraction + matching."""
    from hidegs_tpu_torch.data.colmap import read_model

    cams, imgs, _pts = read_model(sparse_dir)
    db = COLMAPDatabase.connect(database_path)
    try:
        db.create_tables()
        for cid, cam in sorted(cams.items()):
            db.add_camera(
                cam.model, cam.width, cam.height, cam.params, camera_id=cid
            )
        for iid, im in sorted(imgs.items()):
            db.add_image(
                im.name, im.camera_id, prior_q=im.qvec, prior_t=im.tvec,
                image_id=iid,
            )
        db.commit()
    finally:
        db.close()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=fill_database_from_model.__doc__)
    p.add_argument("--in_dir", required=True, help="sparse model dir")
    p.add_argument("--database_path", required=True)
    a = p.parse_args(argv)
    fill_database_from_model(a.in_dir, a.database_path)


if __name__ == "__main__":
    main()
