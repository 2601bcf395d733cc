"""The port's data layer against the JAX package's: COLMAP readers, the
numpy + zlib PNG codec against Pillow, camera and scene loading, and the
synthetic COLMAP scene writer.

Tolerances, and why:
  * COLMAP records, decoded pixels, images, masks, inverse depth, the
    neighbour graph, the split and camera_to_json: exactly equal (the same
    numpy arithmetic on the same bytes);
  * cam_params against convert.camera_from_jax of the JAX camera: atol
    1e-6 (both round the same float64 intrinsics to float32);
  * nerf_norm radius and centre: rtol 1e-6;
  * the writer's PNGs: within 1 level of 255 on at most 0.5% of pixels (the
    renders agree at the golden render's atol 2e-3 before 8-bit rounding;
    a value near a rounding edge can land one level apart).
"""
import json
import os
import struct
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hidegs_tpu.data import cameras as jcameras
from hidegs_tpu.data import colmap as jcolmap
from hidegs_tpu.data import scene as jscene
from hidegs_tpu.data.synthetic import make_toy_gaussians as jtoy
from hidegs_tpu.data.synthetic import ring_camera as jring_camera
from hidegs_tpu.data.synthetic import write_synthetic_colmap_scene as jwrite_scene
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.data import cameras as tcameras
from hidegs_tpu_torch.data import colmap as tcolmap
from hidegs_tpu_torch.data import scene as tscene
from hidegs_tpu_torch.data.synthetic import ToyScene, write_synthetic_colmap_scene
from hidegs_tpu_torch.raster.api import RasterConfig
from hidegs_tpu_torch.utils import png

torch.set_num_threads(1)

H, W, N_VIEWS = 48, 64, 3


def _jcam_to_torch(cam):
    leaves = [np.asarray(x) for x in (cam.R, cam.t, cam.fx, cam.fy, cam.cx, cam.cy)]
    return convert.camera_from_jax(*leaves, cam.height, cam.width, device="cpu")


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """A COLMAP scene of a 300-gaussian toy model, written by the JAX
    package's writer (jnp backend), 3 views of 64x48; plus its depth maps
    and masks written by Pillow."""
    root = str(tmp_path_factory.mktemp("jax_scene"))
    scene = jtoy(300, seed=4)
    cams = [jring_camera(i, n_cams=N_VIEWS, height=H, width=W) for i in range(N_VIEWS)]
    jwrite_scene(root, scene, cams, render_config=JConfig(backend="jnp", max_instances=1 << 14))
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "depths"))
    os.makedirs(os.path.join(root, "masks"))
    for i in range(1, N_VIEWS + 1):
        Image.fromarray((rng.random((H, W)) * 65535).astype(np.uint16)).save(
            os.path.join(root, "depths", f"v{i:04d}.png"))
        mask = (rng.random((H, W, 3)) * 255).astype(np.uint8)
        Image.fromarray(mask).save(os.path.join(root, "masks", f"v{i:04d}.png"))
    return dict(root=root, scene=scene, cams=cams)


# ----------------------------------------------------------------- COLMAP


def _write_text_model(sparse, cams, imgs, xyz, rgb):
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} " + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# Image list\n")
        for im in imgs.values():
            f.write(" ".join([str(im.id), *map(repr, map(float, im.qvec)), *map(repr, map(float, im.tvec)),
                              str(im.camera_id), im.name]) + "\n")
            f.write(" ".join(f"{x!r} {y!r} {int(p)}" for (x, y), p in zip(im.xys.tolist(), im.point3d_ids)) + "\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for i, (p, c) in enumerate(zip(xyz.tolist(), rgb.tolist())):
            f.write(f"{i} {p[0]!r} {p[1]!r} {p[2]!r} {c[0]} {c[1]} {c[2]} 0.5\n")


@pytest.mark.parametrize("fmt", ["bin", "txt"])
def test_colmap_readers_match_jax(tmp_path, fmt):
    """Files written by the JAX package's writers (text: in COLMAP's text
    layout) read the same through both packages' read_model."""
    rng = np.random.default_rng(1)
    sparse = str(tmp_path)
    cams = {1: jcolmap.ColmapCamera(1, "PINHOLE", 640, 480, np.array([500.0, 501.5, 320.25, 239.75])),
            2: jcolmap.ColmapCamera(2, "SIMPLE_PINHOLE", 320, 200, np.array([280.0, 160.0, 100.0]))}
    imgs = {}
    for i in range(1, 6):
        q = rng.normal(size=4)
        n = int(rng.integers(0, 4))
        imgs[i] = jcolmap.ColmapImage(i, q / np.linalg.norm(q), rng.normal(size=3), 1 + i % 2, f"im_{i}.png",
                                      rng.random((n, 2)) * 100, rng.integers(-1, 40, n).astype(np.int64))
    xyz = rng.normal(size=(40, 3))
    rgb = (rng.random((40, 3)) * 255).astype(np.uint8)
    if fmt == "bin":
        jcolmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
        jcolmap.write_images_binary(imgs, os.path.join(sparse, "images.bin"))
        jcolmap.write_points3d_binary(xyz, rgb, os.path.join(sparse, "points3D.bin"))
    else:
        _write_text_model(sparse, cams, imgs, xyz, rgb)
    jc, ji, jp = jcolmap.read_model(sparse)
    tc, ti, tp = tcolmap.read_model(sparse)
    assert jc.keys() == tc.keys() and ji.keys() == ti.keys()
    for k in jc:
        a, b = jc[k], tc[k]
        assert (a.id, a.model, a.width, a.height) == (b.id, b.model, b.width, b.height)
        np.testing.assert_array_equal(a.params, b.params)
    for k in ji:
        a, b = ji[k], ti[k]
        assert (a.id, a.camera_id, a.name) == (b.id, b.camera_id, b.name)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for x, y in zip(jp, tp):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tp[1], rgb)


# -------------------------------------------------------------------- PNG


def _pixels(mode, rng, h=23, w=37):
    if mode == "I;16":
        return (rng.random((h, w)) * 65535).astype(np.uint16)
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    arr = (rng.random((h, w, c)) * 255).astype(np.uint8)
    arr[: h // 2, : w // 2] = arr[0, 0]  # flat regions, as real images have
    return arr[..., 0] if c == 1 else arr


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
def test_png_decodes_pillow_files_exactly(tmp_path, mode):
    arr = _pixels(mode, np.random.default_rng(2))
    path = str(tmp_path / "a.png")
    Image.fromarray(arr).save(path)
    want = np.asarray(Image.open(path))
    got = png.read_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _filter_row(kind, cur, prev, bpp):
    """PNG filter `kind` of one row (the encoder's side, as the format
    defines it), on Python ints."""
    out = []
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((x - pred) & 0xFF)
    return out


def _write_filtered_png(path, arr, depth, colour, kinds):
    """A PNG whose row y uses filter kinds[y % len(kinds)]."""
    h, w = arr.shape[:2]
    raw = arr.astype(">u2").tobytes() if depth == 16 else arr.tobytes()
    stride = len(raw) // h
    bpp = stride // w
    rows, prev = b"", [0] * stride
    for y in range(h):
        cur = list(raw[y * stride:(y + 1) * stride])
        kind = kinds[y % len(kinds)]
        rows += bytes([kind] + _filter_row(kind, cur, prev, bpp))
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,depth,colour", [("L", 8, 0), ("LA", 8, 4), ("RGB", 8, 2), ("RGBA", 8, 6),
                                               ("I;16", 16, 0)])
@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png_decodes_every_filter_as_pillow(tmp_path, mode, depth, colour, kinds):
    arr = _pixels(mode, np.random.default_rng(sum(kinds) + depth), h=9, w=13)
    path = str(tmp_path / "f.png")
    _write_filtered_png(path, arr, depth, colour, kinds)
    want = np.asarray(Image.open(path))
    np.testing.assert_array_equal(want, arr)  # the hand encoder is right
    got = png.read_image(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_png_writer_decodes_in_pillow(tmp_path):
    arr = _pixels("RGB", np.random.default_rng(3), h=48, w=64)
    path = str(tmp_path / "w.png")
    png.write_png(path, arr)
    with Image.open(path) as img:
        assert img.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(img), arr)
    np.testing.assert_array_equal(png.read_png(path), arr)
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(path, arr.astype(np.float32))


def _interlaced_copy(src, dst):
    """`src` with the interlace flag of its IHDR set (a file this decoder
    refuses before it reads the pixels)."""
    data = bytearray(open(src, "rb").read())
    body = bytes(data[16:29])
    body = body[:12] + b"\x01"
    data[16:29] = body
    data[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    open(dst, "wb").write(bytes(data))


def test_other_files_go_to_pillow_and_need_it(tmp_path, monkeypatch):
    arr = _pixels("RGB", np.random.default_rng(4), h=16, w=16)
    jpg = str(tmp_path / "a.jpg")
    Image.fromarray(arr).save(jpg, quality=95)
    np.testing.assert_array_equal(png.read_image(jpg), np.asarray(Image.open(jpg)))
    pal = str(tmp_path / "p.png")
    Image.fromarray(arr).convert("P").save(pal)
    np.testing.assert_array_equal(png.read_image(pal), np.asarray(Image.open(pal).convert("RGBA")))
    src = str(tmp_path / "s.png")
    Image.fromarray(arr).save(src)
    interlaced = str(tmp_path / "i.png")
    _interlaced_copy(src, interlaced)
    monkeypatch.setitem(sys.modules, "PIL", None)  # Pillow absent
    np.testing.assert_array_equal(png.read_image(src), arr)
    for path, why in ((jpg, "not a PNG"), (interlaced, "interlaced"), (pal, "colour type 3")):
        with pytest.raises(ImportError, match=f"{path}.*{why}.*Pillow"):
            png.read_image(path)


# --------------------------------------------------------- cameras, scene


def _assert_cameras_equal(jc, tc):
    np.testing.assert_array_equal(tc.image, jc.image)
    for f in ("alpha_mask", "invdepth"):
        a, b = getattr(jc, f), getattr(tc, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert (tc.width, tc.height, tc.depth_reliable) == (jc.width, jc.height, jc.depth_reliable)
    want = _jcam_to_torch(jc.cam_params())
    got = tc.cam_params("cpu")
    assert (got.height, got.width) == (want.height, want.width)
    for f in ("R", "t", "fx", "fy", "cx", "cy"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), atol=1e-6, rtol=0)


@pytest.mark.parametrize("resolution", [1, 2])
def test_load_scene_matches_jax(jax_scene, resolution):
    """resolution 2 resizes through Pillow (LANCZOS), as the JAX package."""
    root = jax_scene["root"]
    js = jscene.load_scene(root, eval_split=True, resolution=resolution)
    ts = tscene.load_scene(root, eval_split=True, resolution=resolution)
    assert [c.image_name for c in ts.train_cameras.infos] == [c.image_name for c in js.train_cameras.infos]
    assert [c.image_name for c in ts.test_cameras.infos] == [c.image_name for c in js.test_cameras.infos]
    assert len(ts.test_cameras) == 1 and len(ts.train_cameras) == N_VIEWS - 1
    for jd, td in ((js.train_cameras, ts.train_cameras), (js.test_cameras, ts.test_cameras)):
        for i in range(len(jd)):
            _assert_cameras_equal(jd[i], td[i])
    np.testing.assert_allclose(ts.info.nerf_norm_radius, js.info.nerf_norm_radius, rtol=1e-6)
    np.testing.assert_allclose(ts.info.nerf_norm_center, js.info.nerf_norm_center, rtol=1e-6)
    np.testing.assert_array_equal(ts.info.points, js.info.points)
    np.testing.assert_array_equal(ts.info.colors, js.info.colors)
    assert ts.neighbors == js.neighbors
    assert ts.extent == js.extent
    for i, (a, b) in enumerate(zip(js.train_cameras.infos, ts.train_cameras.infos)):
        assert tscene.camera_to_json(i, b) == jscene.camera_to_json(i, a)


@pytest.mark.parametrize("resolution", [1, 2])
def test_load_camera_with_depth_and_mask_matches_jax(jax_scene, resolution):
    """The 16-bit inverse-depth map (scaled, gated) and an RGB mask (to L,
    thresholded), as the JAX loader reads them."""
    root = jax_scene["root"]
    info = jscene.load_scene(root).train_cameras.infos[1]
    stem = os.path.splitext(info.image_name)[0]
    kw = dict(uid=info.uid, R=info.R, t=info.t, fx=info.fx, fy=info.fy, cx=info.cx, cy=info.cy,
              width=info.width, height=info.height, image_path=info.image_path, image_name=info.image_name,
              depth_path=os.path.join(root, "depths", stem + ".png"),
              depth_params={"scale": 2.0, "offset": 0.1, "med_scale": 0.3},
              mask_path=os.path.join(root, "masks", stem + ".png"))
    jc = jcameras.load_camera(jcameras.CameraInfo(**kw), resolution)
    tc = tcameras.load_camera(tcameras.CameraInfo(**kw), resolution)
    assert not jc.depth_reliable and 0.0 < float(jc.alpha_mask.mean()) < 1.0
    _assert_cameras_equal(jc, tc)


def test_scene_artifacts_match_jax(jax_scene, tmp_path):
    root = jax_scene["root"]
    for name, mod in (("jax", jscene), ("port", tscene)):
        os.makedirs(tmp_path / name)
        mod.save_scene_artifacts(mod.load_scene(root, eval_split=True), str(tmp_path / name))
    for f in ("cameras.json", "input.ply"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
    assert len(json.loads((tmp_path / "port" / "cameras.json").read_text())) == N_VIEWS


def test_resolution_policy_matches_jax():
    for args in ((640, 480, 1), (640, 480, 2), (640, 480, 3), (4000, 3000, -1), (1000, 800, -1)):
        assert tcameras.resolution_policy(*args) == jcameras.resolution_policy(*args)


def test_resize_without_pillow_raises(jax_scene, monkeypatch):
    info = tscene.load_scene(jax_scene["root"]).train_cameras.infos[0]
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert tcameras.load_camera(info, 1).image.shape == (3, H, W)
    with pytest.raises(ImportError, match="Pillow"):
        tcameras.load_camera(info, 2)


# ------------------------------------------------------------ scene writer


def test_synthetic_colmap_scene_writer_matches_jax(jax_scene, tmp_path):
    """The port's writer (plain backend) on the same model and cameras:
    cameras.bin and points3D.bin byte-equal; images.bin equal but for the
    quaternions, which may differ by one float32 ulp (both packages compute
    them in float32 through rsqrt, and XLA's CPU rsqrt and torch.rsqrt round
    differently); images within 1 level on <= 0.5% of pixels."""
    s = jax_scene["scene"]
    scene = ToyScene(*(torch.tensor(np.asarray(x)) for x in s))
    cams = [_jcam_to_torch(c) for c in jax_scene["cams"]]
    root = str(tmp_path / "port_scene")
    write_synthetic_colmap_scene(root, scene, cams, render_config=RasterConfig(backend="plain",
                                                                                max_instances=1 << 14))
    for f in ("cameras.bin", "points3D.bin"):
        a = open(os.path.join(jax_scene["root"], "sparse", "0", f), "rb").read()
        b = open(os.path.join(root, "sparse", "0", f), "rb").read()
        assert a == b, f
    jimgs = jcolmap.read_images_binary(os.path.join(jax_scene["root"], "sparse", "0", "images.bin"))
    timgs = tcolmap.read_images_binary(os.path.join(root, "sparse", "0", "images.bin"))
    assert jimgs.keys() == timgs.keys()
    for k in jimgs:
        a, b = jimgs[k], timgs[k]
        assert (a.id, a.camera_id, a.name, a.xys.shape) == (b.id, b.camera_id, b.name, b.xys.shape)
        np.testing.assert_array_equal(b.tvec, a.tvec)
        ulp = np.spacing(np.abs(a.qvec).astype(np.float32)).astype(np.float64)
        assert np.all(np.abs(b.qvec - a.qvec) <= ulp), (a.qvec, b.qvec)
    for i in range(1, N_VIEWS + 1):
        name = f"v{i:04d}.png"
        want = np.asarray(Image.open(os.path.join(jax_scene["root"], "images", name))).astype(int)
        got = png.read_image(os.path.join(root, "images", name)).astype(int)
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3, (name, diff.max(), (diff > 0).mean())
        assert want.std() > 5  # a real render
