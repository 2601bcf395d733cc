"""COLMAP CLI wrappers + spatial match-pair generation.

The port's own copy of hidegs_tpu/preprocess/colmap_driver.py.

Equivalents of scripts/convert.py:8-60 (feature extract → match → map →
undistort) and preprocess/make_colmap_custom_matcher.py:17-30 /
make_colmap_custom_matcher_distance.py (match pairs from spatial/EXIF-GPS
KNN). The COLMAP binary is not a dependency of the package, so the wrappers
check for it and raise a clear error; the pair generation is pure Python and
fully functional.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, List, Sequence, Tuple

import numpy as np


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def _run(args: Sequence[str]):
    if not colmap_available():
        raise RuntimeError(
            "COLMAP binary not found on PATH — install COLMAP to run the "
            "calibration pipeline (scripts/convert.py equivalent)"
        )
    subprocess.run(list(args), check=True)


def feature_extract(database: str, images_dir: str, camera_model: str = "PINHOLE"):
    _run([
        "colmap", "feature_extractor",
        "--database_path", database,
        "--image_path", images_dir,
        "--ImageReader.camera_model", camera_model,
        "--ImageReader.single_camera", "1",
    ])


def exhaustive_match(database: str):
    _run(["colmap", "exhaustive_matcher", "--database_path", database])


def custom_match(database: str, match_list: str):
    _run([
        "colmap", "matches_importer",
        "--database_path", database,
        "--match_list_path", match_list,
    ])


def mapper(database: str, images_dir: str, output_dir: str, hierarchical: bool = False):
    cmd = "hierarchical_mapper" if hierarchical else "mapper"
    _run([
        "colmap", cmd,
        "--database_path", database,
        "--image_path", images_dir,
        "--output_path", output_dir,
    ])


def undistort(images_dir: str, sparse_dir: str, output_dir: str):
    _run([
        "colmap", "image_undistorter",
        "--image_path", images_dir,
        "--input_path", sparse_dir,
        "--output_path", output_dir,
        "--output_type", "COLMAP",
    ])


def convert_scene(source_path: str, camera_model: str = "PINHOLE"):
    """Full scripts/convert.py flow for one scene directory."""
    db = os.path.join(source_path, "database.db")
    images = os.path.join(source_path, "input")
    sparse = os.path.join(source_path, "distorted", "sparse")
    os.makedirs(sparse, exist_ok=True)
    feature_extract(db, images, camera_model)
    exhaustive_match(db)
    mapper(db, images, sparse)
    undistort(images, os.path.join(sparse, "0"), source_path)


# ------------------------------------------------- spatial match pairs


def knn_match_pairs(
    positions: Dict[str, np.ndarray], k: int = 40
) -> List[Tuple[str, str]]:
    """Match pairs from spatial K-nearest neighbors of per-image positions
    (camera centers or EXIF GPS) — make_colmap_custom_matcher.py:17-30."""
    names = sorted(positions.keys())
    P = np.stack([positions[n] for n in names])
    d = np.linalg.norm(P[:, None] - P[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    pairs = set()
    for i, n in enumerate(names):
        nn = np.argsort(d[i])[: min(k, len(names) - 1)]
        for j in nn:
            a, b = sorted((n, names[int(j)]))
            pairs.add((a, b))
    return sorted(pairs)


def write_match_list(pairs: Sequence[Tuple[str, str]], path: str):
    with open(path, "w") as f:
        for a, b in pairs:
            f.write(f"{a} {b}\n")
