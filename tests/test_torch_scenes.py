"""The port's scene writers against the JAX package's: the analytic scene
(a ray-cast textured plane with spheres) and the terrain scene (a
ray-marched height field with 16-bit monodepth maps) at 64x48, and the
PNG writer of utils/png.py against Pillow.

Tolerances: the COLMAP cameras and points files are equal byte for byte;
the quaternions within 1 ulp (XLA's rsqrt against torch.rsqrt); the images
and monodepth maps within one 8- or 16-bit level (both packages compute
them with the same numpy code from the same float32 cameras).
"""
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from hidegs_tpu.data import colmap as jcolmap
from hidegs_tpu.data import synthetic as jsyn
from hidegs_tpu_torch.data import colmap as tcolmap
from hidegs_tpu_torch.data import synthetic as tsyn
from hidegs_tpu_torch.data.scene import load_scene as tload_scene
from hidegs_tpu_torch.utils import png

TOOL = Path(__file__).resolve().parents[1] / "tools" / "terrain_quality_run.py"


def _grid_cams(pkg, device_kw):
    return [pkg.nadir_grid_camera(ix, iy, 2, 2, height=48, width=64, **device_kw)
            for iy in range(2) for ix in range(2)]


def _compare_scenes(a, b, depths=False):
    for name in ("cameras.bin", "points3D.bin"):
        with open(os.path.join(a, "sparse/0", name), "rb") as fa, open(os.path.join(b, "sparse/0", name), "rb") as fb:
            assert fa.read() == fb.read(), name
    ia = tcolmap.read_images_binary(os.path.join(a, "sparse/0/images.bin"))
    ib = jcolmap.read_images_binary(os.path.join(b, "sparse/0/images.bin"))
    assert ia.keys() == ib.keys()
    for k in ia:
        assert ia[k].name == ib[k].name and np.array_equal(ia[k].tvec, ib[k].tvec)
        # the known 1-ulp float32 difference of the quaternion (XLA's rsqrt)
        np.testing.assert_allclose(ia[k].qvec, ib[k].qvec, rtol=2.5e-7, atol=1e-7)
        img_a = np.asarray(Image.open(os.path.join(a, "images", ia[k].name)), np.int64)
        img_b = np.asarray(Image.open(os.path.join(b, "images", ib[k].name)), np.int64)
        assert img_a.shape == (48, 64, 3) and np.abs(img_a - img_b).max() <= 1
        if depths:
            d_a = np.asarray(Image.open(os.path.join(a, "depths", ia[k].name)), np.int64)
            d_b = np.asarray(Image.open(os.path.join(b, "depths", ib[k].name)), np.int64)
            assert d_a.shape == (48, 64) and d_a.max() > 1000 and np.abs(d_a - d_b).max() <= 1


def test_analytic_scene_writer_matches_jax(tmp_path):
    spheres = np.array([[1.0, -2.0, 1.0, 1.2], [-4.0, 3.0, 0.8, 0.8]])
    colors = np.array([[0.8, 0.2, 0.2], [0.2, 0.3, 0.9]])
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    tsyn.write_analytic_colmap_scene(a, _grid_cams(tsyn, dict(device="cpu")), spheres, colors, n_points=500)
    jsyn.write_analytic_colmap_scene(b, _grid_cams(jsyn, {}), spheres, colors, n_points=500)
    _compare_scenes(a, b)
    tpts, tcols = tsyn.analytic_init_points(300, 12.0, spheres, colors, seed=2)
    jpts, jcols = jsyn.analytic_init_points(300, 12.0, spheres, colors, seed=2)
    assert np.array_equal(tpts, jpts) and np.array_equal(tcols, jcols)


def test_terrain_scene_writer_matches_jax(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    tsyn.write_terrain_colmap_scene(a, _grid_cams(tsyn, dict(device="cpu")), n_points=800)
    jsyn.write_terrain_colmap_scene(b, _grid_cams(jsyn, {}), n_points=800)
    _compare_scenes(a, b, depths=True)
    assert json.load(open(os.path.join(a, "sparse/0/depth_params.json"))) == \
        json.load(open(os.path.join(b, "sparse/0/depth_params.json")))
    # tools/terrain_quality_run.py ray-marches the views in worker
    # processes: the files are the same
    spec = importlib.util.spec_from_file_location("terrain_quality_run", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    c = str(tmp_path / "port_processes")
    tool.write_scene(c, _grid_cams(tsyn, dict(device="cpu"))[:2], processes=2, n_points=800)
    for sub in ("images", "depths"):
        for name in sorted(os.listdir(os.path.join(c, sub))):
            with open(os.path.join(a, sub, name), "rb") as fa, open(os.path.join(c, sub, name), "rb") as fc:
                assert fa.read() == fc.read(), (sub, name)
    with open(os.path.join(c, "sparse/0/points3D.bin"), "rb") as fc, \
            open(os.path.join(a, "sparse/0/points3D.bin"), "rb") as fa:
        assert fc.read() == fa.read()
    # the port's loader reads the 16-bit monodepth maps back
    scene = tload_scene(a, depths="depths")
    cam = scene.train_cameras[0]
    assert cam.invdepth is not None and cam.invdepth.shape == (48, 64) and float(cam.invdepth.max()) > 0


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
def test_png_writer_matches_pillow(tmp_path, kind):
    """utils/png.py writes what Pillow reads back as the same array, in the
    mode Pillow itself would write it, and reads Pillow's files."""
    rng = np.random.default_rng(7)
    shape, dtype, mode = {"gray8": ((13, 17), np.uint8, "L"), "gray16": ((13, 17), np.uint16, "I;16"),
                          "rgb8": ((13, 17, 3), np.uint8, "RGB")}[kind]
    arr = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    arr.flat[:3] = [0, np.iinfo(dtype).max, 1]
    png.write_png(str(tmp_path / "port.png"), arr)
    with Image.open(tmp_path / "port.png") as img:
        assert img.mode == mode
        assert np.array_equal(np.asarray(img), arr)
    Image.fromarray(arr).save(tmp_path / "pil.png")
    assert np.array_equal(png.read_image(str(tmp_path / "pil.png")), arr)
    with pytest.raises(ValueError, match="write_png takes"):
        png.write_png(str(tmp_path / "bad.png"), arr.astype(np.float32))
