"""Per-chunk COLMAP refinement — the reference's preprocess/prepare_chunk.py.

The port's own copy of hidegs_tpu/preprocess/chunk_refine.py.

Flow (prepare_chunk.py:33-190): seed a fresh database from the raw chunk's
sparse model → distance-KNN match list → undistort the chunk's image subset →
feature extraction (reusing known camera ids) → matches import → two rounds
of point triangulation + bundle adjustment (one short round when
skip_bundle_adjustment) → Procrustes re-alignment of the refined model back
to the global frame (our `preprocess.align.align_chunk`).

The COLMAP binary is not a dependency of the package; every COLMAP
invocation goes through `colmap_driver._run`, which gates on its presence.
Tests exercise the flow with a stub `colmap` on PATH.
"""
from __future__ import annotations

import os
import shutil
from typing import Sequence

import numpy as np

from hidegs_tpu_torch.data.colmap import (
    qvec_to_rotmat,
    read_images_binary,
    write_points3d_binary,
)
from hidegs_tpu_torch.preprocess.align import align_chunk
from hidegs_tpu_torch.preprocess.colmap_driver import _run
from hidegs_tpu_torch.preprocess.database import fill_database_from_model

TRIANGULATOR_ARGS = [
    "--Mapper.ba_global_function_tolerance", "0.000001",
    "--Mapper.ba_global_max_num_iterations", "30",
    "--Mapper.ba_global_max_refinements", "3",
]
FAST_TRIANGULATOR_ARGS = [
    "--Mapper.ba_global_max_num_iterations", "5",
    "--Mapper.ba_global_max_refinements", "1",
]
BUNDLE_ADJUSTER_ARGS = [
    "--BundleAdjustment.refine_extra_params", "0",
    "--BundleAdjustment.function_tolerance", "0.000001",
    "--BundleAdjustment.max_linear_solver_iterations", "100",
    "--BundleAdjustment.max_num_iterations", "50",
    "--BundleAdjustment.refine_focal_length", "0",
]


def write_distance_match_list(sparse_dir: str, path: str, n_neighbours: int):
    """Distance-KNN pairs from the chunk's camera centers
    (make_colmap_custom_matcher_distance.py)."""
    from hidegs_tpu_torch.preprocess.colmap_driver import knn_match_pairs, write_match_list

    imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    centers = {
        im.name: -qvec_to_rotmat(im.qvec).T @ im.tvec for im in imgs.values()
    }
    pairs = knn_match_pairs(centers, k=n_neighbours)
    write_match_list(pairs, path)
    return pairs


def _triangulate(db: str, images: str, inp: str, out: str, fast: bool):
    os.makedirs(out, exist_ok=True)
    args = FAST_TRIANGULATOR_ARGS if fast else TRIANGULATOR_ARGS
    _run(
        ["colmap", "point_triangulator", *args,
         "--database_path", db, "--image_path", images,
         "--input_path", inp, "--output_path", out]
    )


def _bundle_adjust(inp: str, out: str):
    os.makedirs(out, exist_ok=True)
    _run(
        ["colmap", "bundle_adjuster", *BUNDLE_ADJUSTER_ARGS,
         "--input_path", inp, "--output_path", out]
    )


def prepare_chunk(
    raw_chunk: str,
    out_chunk: str,
    images_dir: str,
    skip_bundle_adjustment: bool = False,
) -> dict:
    """Refine one chunk's poses/points with COLMAP and re-align to global.

    Returns align_chunk's stats dict."""
    matching_nb = 50 if skip_bundle_adjustment else 200
    ba_dir = os.path.join(raw_chunk, "bundle_adjustment")
    sparse_raw = os.path.join(raw_chunk, "sparse", "0")
    os.makedirs(os.path.join(ba_dir, "sparse"), exist_ok=True)

    db = os.path.join(ba_dir, "database.db")
    if os.path.exists(db):
        os.remove(db)
    fill_database_from_model(sparse_raw, db)

    match_list = os.path.join(ba_dir, f"matching_{matching_nb}.txt")
    write_distance_match_list(sparse_raw, match_list, matching_nb)

    # undistorted copies of just this chunk's images
    _run(
        ["colmap", "image_undistorter",
         "--image_path", images_dir,
         "--input_path", sparse_raw,
         "--output_path", ba_dir,
         "--output_type", "COLMAP"]
    )
    chunk_images = os.path.join(ba_dir, "images")

    _run(
        ["colmap", "feature_extractor",
         "--database_path", db,
         "--image_path", chunk_images,
         "--ImageReader.existing_camera_id", "1"]
    )
    _run(
        ["colmap", "matches_importer",
         "--database_path", db,
         "--match_list_path", match_list]
    )

    # seed model: known poses, empty points (prepare_chunk.py:100-110)
    seed = os.path.join(ba_dir, "sparse", "o")
    os.makedirs(seed, exist_ok=True)
    for f in ("images.bin", "cameras.bin"):
        shutil.copy(os.path.join(sparse_raw, f), os.path.join(seed, f))
    write_points3d_binary(
        np.zeros((0, 3)), np.zeros((0, 3)), os.path.join(seed, "points3D.bin")
    )

    sparse = lambda name: os.path.join(ba_dir, "sparse", name)
    if skip_bundle_adjustment:
        _triangulate(db, chunk_images, seed, sparse("0"), fast=True)
    else:
        _triangulate(db, chunk_images, seed, sparse("t"), fast=False)
        _bundle_adjust(sparse("t"), sparse("b"))
        _triangulate(db, chunk_images, sparse("b"), sparse("t2"), fast=False)
        _bundle_adjust(sparse("t2"), sparse("0"))

    return align_chunk(raw_chunk, ba_dir, out_chunk)


def main(argv: Sequence[str] = None):
    import argparse

    p = argparse.ArgumentParser(description=prepare_chunk.__doc__)
    p.add_argument("--raw_chunk", required=True)
    p.add_argument("--out_chunk", required=True)
    p.add_argument("--images_dir", required=True)
    p.add_argument("--skip_bundle_adjustment", action="store_true")
    a = p.parse_args(argv)
    stats = prepare_chunk(
        a.raw_chunk, a.out_chunk, a.images_dir, a.skip_bundle_adjustment
    )
    print(f"chunk refined: {stats['n_cams']} cams, {stats['n_points']} points")


if __name__ == "__main__":
    main()
