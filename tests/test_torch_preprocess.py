"""Port parity: the nine preprocess modules of hidegs_tpu_torch against
hidegs_tpu, on the CPU, on the inputs of tests/test_preprocess.py and
tests/test_preprocess_drivers.py.

Tolerances: none but one. The modules are the same numpy, sqlite3 and
subprocess code in both packages, so chunk directories, databases, match
lists, depth-scale JSON, masks and 16-bit depth PNGs are byte- or
value-equal. The reoriented camera quaternions are within 1 float32 ulp:
JAX's rotmat_to_quat takes XLA's rsqrt, the port's torch's.
"""
import json
import os
import shutil
import sqlite3
import stat
import sys

import numpy as np
import pytest

from hidegs_tpu.preprocess import align as jalign
from hidegs_tpu.preprocess import chunk_refine as jrefine
from hidegs_tpu.preprocess import chunking as jchunking
from hidegs_tpu.preprocess import colmap_driver as jdriver
from hidegs_tpu.preprocess import database as jdb
from hidegs_tpu.preprocess import depth_scale as jdepth
from hidegs_tpu.preprocess import masks as jmasks
from hidegs_tpu.preprocess import monodepth as jmono
from hidegs_tpu.preprocess import reorient as jreorient
from hidegs_tpu_torch.data import colmap
from hidegs_tpu_torch.preprocess import align as talign
from hidegs_tpu_torch.preprocess import chunk_refine as trefine
from hidegs_tpu_torch.preprocess import chunking as tchunking
from hidegs_tpu_torch.preprocess import colmap_driver as tdriver
from hidegs_tpu_torch.preprocess import database as tdb
from hidegs_tpu_torch.preprocess import depth_scale as tdepth
from hidegs_tpu_torch.preprocess import masks as tmasks
from hidegs_tpu_torch.preprocess import monodepth as tmono
from hidegs_tpu_torch.preprocess import reorient as treorient
from hidegs_tpu_torch.utils.png import read_png, write_png
from tests.test_preprocess import _make_colmap_model, grid_scene
from tests.test_preprocess_drivers import _toy_model


def tree_bytes(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def assert_same_tree(a, b):
    ta, tb = tree_bytes(a), tree_bytes(b)
    assert sorted(ta) == sorted(tb) and ta
    for rel in ta:
        assert ta[rel] == tb[rel], rel


def assert_same_pngs(port_dir, jax_dir):
    """The same PNG files with the same pixels (as Pillow reads them; the
    port's encoder compresses differently from Pillow's)."""
    from PIL import Image

    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir)) and names
    for f in names:
        a, b = np.asarray(Image.open(os.path.join(port_dir, f))), np.asarray(Image.open(os.path.join(jax_dir, f)))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# ------------------------------------------------------------ chunking


@pytest.mark.parametrize("case", ["grid", "far_cams", "blur_filter"])
def test_chunks_and_chunk_directories_equal_jax(tmp_path, case):
    cams, imgs, xyz, rgb, err = grid_scene()
    kw = dict(chunk_size=30.0, min_n_cams=4, add_far_cams=case == "far_cams")
    if case == "blur_filter":
        kw["lapla_scores"] = {k: float(v) for k, v in zip(sorted(imgs), np.random.RandomState(4).rand(len(imgs)))}
    jchunks = jchunking.compute_chunks(cams, imgs, xyz, err, **kw)
    tchunks = tchunking.compute_chunks(cams, imgs, xyz, err, **kw)
    assert len(tchunks) == len(jchunks) >= 2
    for j, t in zip(jchunks, tchunks):
        assert (t.i, t.j, t.camera_ids) == (j.i, j.j, j.camera_ids)
        assert np.array_equal(t.center, j.center) and np.array_equal(t.extent, j.extent)
        assert np.array_equal(t.point_mask, j.point_mask)
    jchunking.write_chunks(jchunks, cams, imgs, xyz, rgb, err, str(tmp_path / "jax"))
    tchunking.write_chunks(tchunks, cams, imgs, xyz, rgb, err, str(tmp_path / "port"))
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


def test_laplacian_variance_with_and_without_cv2(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    path = str(tmp_path / "a.png")
    write_png(path, (rng.rand(24, 32, 3) * 255).astype(np.uint8))
    pytest.importorskip("cv2")
    got, want = tchunking.laplacian_variance(path), jchunking.laplacian_variance(path)
    assert got == want and 0 < got < 1e9
    assert tchunking.laplacian_variance(str(tmp_path / "missing.png")) == 0.0
    monkeypatch.setitem(sys.modules, "cv2", None)  # no cv2: keep everything
    assert tchunking.laplacian_variance(path) == jchunking.laplacian_variance(path) == 1e9


# ------------------------------------------------------------ reorient


def test_reorientation_matches_jax():
    rng = np.random.RandomState(2)
    n_vec = np.array([0.3, -0.9, 0.3])
    n_vec /= np.linalg.norm(n_vec)
    basis = np.linalg.svd(n_vec[None])[2][1:]
    centers = rng.rand(50, 2) * 10 @ basis + 0.01 * rng.randn(50, 3)
    n_t, off_t = treorient.fit_ground_plane(centers)
    n_j, off_j = jreorient.fit_ground_plane(centers)
    assert np.array_equal(n_t, n_j) and off_t == off_j
    R = treorient.reorientation_matrix(centers)
    assert np.array_equal(R, jreorient.reorientation_matrix(centers))
    assert np.array_equal(treorient.reorientation_matrix(centers, np.array([0.0, 0.0, 1.0])),
                          jreorient.reorientation_matrix(centers, np.array([0.0, 0.0, 1.0])))
    _, imgs, xyz, _, _ = grid_scene(n_side=4)
    timgs, txyz = treorient.apply_reorientation(R, imgs, xyz)
    jimgs, jxyz = jreorient.apply_reorientation(R, imgs, xyz)
    assert np.array_equal(txyz, jxyz) and sorted(timgs) == sorted(jimgs)
    for k in jimgs:
        t, j = timgs[k], jimgs[k]
        assert t.qvec.dtype == j.qvec.dtype == np.float64
        np.testing.assert_array_max_ulp(t.qvec.astype(np.float32), j.qvec.astype(np.float32), maxulp=1)
        assert np.array_equal(t.tvec, j.tvec) and (t.id, t.name, t.camera_id) == (j.id, j.name, j.camera_id)


def test_drop_outlier_cameras_matches_jax():
    _, imgs, _, _, _ = grid_scene(n_side=3)
    imgs[99] = colmap.ColmapImage(99, np.array([1.0, 0, 0, 0]), np.array([-1e4, -1e4, 0.0]), 1, "far.png",
                                  np.zeros((0, 2)), np.zeros((0,), np.int64))
    kept = treorient.drop_outlier_cameras(imgs)
    assert sorted(kept) == sorted(jreorient.drop_outlier_cameras(imgs)) and 99 not in kept
    two = {k: imgs[k] for k in sorted(imgs)[:2]}
    assert sorted(treorient.drop_outlier_cameras(two)) == sorted(jreorient.drop_outlier_cameras(two))


# ------------------------------------------------------------ align


def test_procrustes_and_apply_sim3_match_jax():
    rng = np.random.RandomState(0)
    X0 = rng.randn(50, 3)
    Q, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    X1 = (X0 @ Q.T) * 2.5 + np.array([3.0, -1.0, 0.5])
    t, j = talign.procrustes(X0, X1), jalign.procrustes(X0, X1)
    for a, b in zip(t, j):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(talign.apply_sim3(t, X1), jalign.apply_sim3(j, X1))
    assert np.allclose(talign.apply_sim3(t, X1), X0, atol=1e-6)


def test_align_chunk_writes_the_jax_model(tmp_path):
    """tests/test_preprocess.py::test_align_chunk_end_to_end's drifted
    model, aligned back by both packages (function and CLI)."""
    rng = np.random.RandomState(3)
    centers = rng.randn(10, 3) * 2.0
    R_list = []
    for _ in range(10):
        Q, _ = np.linalg.qr(rng.randn(3, 3))
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        R_list.append(Q)
    pts, rgb = rng.randn(40, 3), rng.randint(0, 255, (40, 3)).astype(np.uint8)
    _make_colmap_model(str(tmp_path / "orig"), R_list, [-R @ c for R, c in zip(R_list, centers)], pts, rgb)
    (tmp_path / "orig" / "center.txt").write_text("0 0 0\n")
    (tmp_path / "orig" / "extent.txt").write_text("100 100 100\n")
    Qd, _ = np.linalg.qr(rng.randn(3, 3))
    if np.linalg.det(Qd) < 0:
        Qd[:, 0] *= -1
    centers_new = centers @ Qd.T * 1.7 + np.array([5.0, 2.0, -3.0])
    R_new = [R @ Qd.T for R in R_list]
    _make_colmap_model(str(tmp_path / "refined"), R_new, [-R @ c for R, c in zip(R_new, centers_new)],
                       pts @ Qd.T * 1.7 + np.array([5.0, 2.0, -3.0]), rgb)
    args = (str(tmp_path / "orig"), str(tmp_path / "refined"))
    got, want = talign.align_chunk(*args, str(tmp_path / "port")), jalign.align_chunk(*args, str(tmp_path / "jax"))
    assert (got["n_cams"], got["n_points"]) == (want["n_cams"], want["n_points"]) == (10, 40)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got["sim3"], want["sim3"]))
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    talign.main(["--in_dir", args[0], "--new_colmap_dir", args[1], "--out_dir", str(tmp_path / "port_cli")])
    assert_same_tree(tmp_path / "jax", tmp_path / "port_cli")


# ------------------------------------------------------------ database


def db_rows(path):
    con = sqlite3.connect(path)
    tables = sorted(r[0] for r in con.execute("SELECT name FROM sqlite_master WHERE type='table'"))
    rows = {t: sorted(con.execute(f"SELECT * FROM {t}").fetchall(), key=repr) for t in tables}
    con.close()
    return rows


def _fill_by_hand(mod, path):
    rng = np.random.RandomState(7)
    db = mod.COLMAPDatabase.connect(path)
    db.create_tables()
    cid = db.add_camera("PINHOLE", 640, 480, np.array([500.0, 500.0, 320.0, 240.0]))
    i1 = db.add_image("a.png", cid, prior_q=np.array([1.0, 0, 0, 0]), prior_t=np.zeros(3))
    i2 = db.add_image("b.png", cid)
    db.add_keypoints(i1, rng.rand(10, 2).astype(np.float32))
    db.add_descriptors(i1, rng.randint(0, 255, (10, 128)).astype(np.uint8))
    matches = np.array([[0, 1], [2, 3]], np.uint32)
    db.add_matches(i2, i1, matches)
    db.add_two_view_geometry(i1, i2, matches)
    db.commit()
    out = (db.read_cameras(), db.read_images())
    db.close()
    return out


def test_database_contents_equal_jax(tmp_path):
    tcams, timgs = _fill_by_hand(tdb, str(tmp_path / "port.db"))
    jcams, jimgs = _fill_by_hand(jdb, str(tmp_path / "jax.db"))
    assert db_rows(str(tmp_path / "port.db")) == db_rows(str(tmp_path / "jax.db"))
    assert repr(tcams) == repr(jcams) and repr(timgs) == repr(jimgs)
    for a, b in ((7, 3), (3, 7), (1, 2)):
        assert tdb.image_ids_to_pair_id(a, b) == jdb.image_ids_to_pair_id(a, b)
        pid = tdb.image_ids_to_pair_id(a, b)
        assert tdb.pair_id_to_image_ids(pid) == jdb.pair_id_to_image_ids(pid)


def test_fill_database_from_model_equals_jax(tmp_path):
    _toy_model(tmp_path)
    sparse = str(tmp_path / "sparse/0")
    tdb.fill_database_from_model(sparse, str(tmp_path / "port.db"))
    jdb.fill_database_from_model(sparse, str(tmp_path / "jax.db"))
    rows = db_rows(str(tmp_path / "port.db"))
    assert rows == db_rows(str(tmp_path / "jax.db")) and len(rows["images"]) == 6
    tdb.main(["--in_dir", sparse, "--database_path", str(tmp_path / "cli.db")])
    assert db_rows(str(tmp_path / "cli.db")) == rows


# ------------------------------------------------------------ COLMAP wrappers

STUB_COLMAP = """#!/usr/bin/env python3
import json, os, shutil, sys

args = sys.argv[1:]
cmd = args[0]
opt = dict(zip(args[1::2], args[2::2]))
with open(os.path.join({log_dir!r}, "colmap_calls.txt"), "a") as log:
    log.write(json.dumps(args) + "\\n")
if cmd == "image_undistorter":
    os.makedirs(os.path.join(opt["--output_path"], "images"), exist_ok=True)
elif cmd in ("point_triangulator", "bundle_adjuster"):
    inp, out = opt["--input_path"], opt["--output_path"]
    os.makedirs(out, exist_ok=True)
    for f in ("cameras.bin", "images.bin"):
        shutil.copy(os.path.join(inp, f), os.path.join(out, f))
    # triangulation "recovers" the 15 points written beside the stub
    shutil.copy({points!r}, os.path.join(out, "points3D.bin"))
elif cmd in ("mapper", "hierarchical_mapper"):
    os.makedirs(opt["--output_path"], exist_ok=True)
elif cmd not in ("feature_extractor", "matches_importer", "exhaustive_matcher"):
    sys.exit("unexpected colmap command: " + cmd)
"""


@pytest.fixture
def stub_colmap(tmp_path, monkeypatch):
    """A stub `colmap` on PATH that logs its argv (one JSON line per call)
    to <tmp_path>/colmap_calls.txt and writes the files the next step
    reads. Returns a function that reads and clears the log."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "colmap"
    rng = np.random.RandomState(0)
    points = str(bindir / "points3D.bin")
    colmap.write_points3d_binary(rng.randn(15, 3), rng.randint(0, 255, (15, 3)), points)
    stub.write_text(STUB_COLMAP.format(points=points, log_dir=str(tmp_path)))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    log = tmp_path / "colmap_calls.txt"

    def calls():
        out = [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []
        log.unlink(missing_ok=True)
        return out

    return calls


def test_colmap_available_reports_the_binary(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert tdriver.colmap_available() is jdriver.colmap_available() is False
    for mod in (tdriver, jdriver):
        with pytest.raises(RuntimeError, match="COLMAP binary not found"):
            mod.feature_extract("db", "images")


def test_colmap_wrappers_run_the_jax_commands(stub_colmap, tmp_path):
    assert tdriver.colmap_available()
    for mod in (jdriver, tdriver):
        mod.feature_extract("db", "imgs", "OPENCV")
        mod.exhaustive_match("db")
        mod.custom_match("db", "pairs.txt")
        mod.mapper("db", "imgs", str(tmp_path / "m"))
        mod.mapper("db", "imgs", str(tmp_path / "m"), hierarchical=True)
        mod.undistort("imgs", "sparse", str(tmp_path / "u"))
        mod.convert_scene(str(tmp_path / "scene"))
    calls = stub_colmap()
    assert len(calls) == 2 * 10 and calls[:10] == calls[10:]


def test_knn_match_pairs_and_match_list_equal_jax(tmp_path):
    rng = np.random.RandomState(5)
    pos = {f"im{i}": rng.randn(3) for i in range(12)}
    for k in (2, 5, 40):
        assert tdriver.knn_match_pairs(pos, k=k) == jdriver.knn_match_pairs(pos, k=k)
    pairs = tdriver.knn_match_pairs(pos, k=3)
    tdriver.write_match_list(pairs, str(tmp_path / "t.txt"))
    jdriver.write_match_list(pairs, str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


@pytest.mark.parametrize("skip_ba", [False, True])
def test_prepare_chunk_matches_jax_with_stub_colmap(stub_colmap, tmp_path, skip_ba):
    outs = {}
    for name, mod in (("jax", jrefine), ("port", trefine)):
        raw = tmp_path / name / "chunk_raw"
        _toy_model(raw)
        (raw / "center.txt").write_text("0 0 0\n")
        (raw / "extent.txt").write_text("50 50 50\n")
        (tmp_path / name / "images").mkdir()
        args = (str(raw), str(tmp_path / name / "out"), str(tmp_path / name / "images"))
        if mod is trefine and skip_ba:  # the port's CLI
            mod.main(["--raw_chunk", args[0], "--out_chunk", args[1], "--images_dir", args[2],
                      "--skip_bundle_adjustment"])
            stats = talign.align_chunk(args[0], str(raw / "bundle_adjustment"), str(tmp_path / "realigned"))
        else:
            stats = mod.prepare_chunk(*args, skip_bundle_adjustment=skip_ba)
        sim3 = stats.pop("sim3")
        outs[name] = (stats, [[a.replace(f"/{name}/", "/X/") for a in c] for c in stub_colmap()])
        nb = 50 if skip_ba else 200
        outs[name] += (db_rows(str(raw / "bundle_adjustment" / "database.db")),
                       (raw / "bundle_adjustment" / f"matching_{nb}.txt").read_bytes())
        outs[name] += (sim3,)
    sim3_t, sim3_j = outs["port"][-1], outs["jax"][-1]
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(sim3_t, sim3_j))
    assert outs["port"][:-1] == outs["jax"][:-1]
    assert outs["port"][0]["n_cams"] == 6 and outs["port"][0]["n_points"] == 15
    assert_same_tree(tmp_path / "jax" / "out", tmp_path / "port" / "out")
    names = [c[0] for c in outs["port"][1]]
    assert names.count("bundle_adjuster") == (0 if skip_ba else 2)


# ------------------------------------------------------------ depth


def test_depth_scale_fit_matches_jax():
    """tests/test_preprocess.py's known transform, fitted by both."""
    rng = np.random.RandomState(1)
    n, fx, fy, cx, cy, H, W = 100, 60.0, 60.0, 32.0, 24.0, 48, 64
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    mono = (0.2 + 0.004 * uu + 0.006 * vv).astype(np.float32)
    uv = np.stack([rng.uniform(2, W - 3, n), rng.uniform(2, H - 3, n)], -1)
    xi, yi = uv[:, 0].astype(int), uv[:, 1].astype(int)
    uv = np.stack([xi, yi], -1).astype(np.float64)
    z = 1.0 / (mono[yi, xi] * 0.05 + 0.1)
    pts = np.stack([(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z, z], -1)
    img = colmap.ColmapImage(1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, "a.png", uv,
                             np.arange(len(pts), dtype=np.int64))
    cam = colmap.ColmapCamera(1, "PINHOLE", W, H, np.array([fx, fy, cx, cy]))
    ordered = np.zeros((len(pts) + 1, 3))
    ordered[:len(pts)] = pts
    got = tdepth.fit_image_depth_scale(img, cam, ordered, mono)
    assert got == jdepth.fit_image_depth_scale(img, cam, ordered, mono) and got is not None
    assert abs(got["scale"] - 0.05) / 0.05 < 0.2


def test_depth_maps_and_depth_params_equal_jax(tmp_path):
    """generate_depth_maps with a predictor writes the JAX package's 16-bit
    PNGs (read back as Pillow reads them), and make_depth_params fits the
    same depth_params.json from them; per chunk too."""
    from PIL import Image

    _toy_model(tmp_path / "model", n_cams=4)
    sparse = str(tmp_path / "model" / "sparse" / "0")
    _, imgs, _ = colmap.read_model(sparse)
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.RandomState(2)
    for im in imgs.values():
        write_png(str(images / im.name), (rng.rand(16, 20, 3) * 255).astype(np.uint8))

    def predictor(rgb):
        h, w, _ = rgb.shape
        return np.linspace(0.1, 1.0, w)[None, :] * (rgb.mean() + 0.5) * np.ones((h, 1))

    written = {}
    for name, mod in (("jax", jmono), ("port", tmono)):
        written[name] = mod.generate_depth_maps(str(images), str(tmp_path / name / "depths"), predictor=predictor)
    assert [os.path.basename(p) for p in written["port"]] == [os.path.basename(p) for p in written["jax"]]
    for t, j in zip(written["port"], written["jax"]):
        a, b = read_png(t), np.asarray(Image.open(j))
        assert a.dtype == np.uint16 and np.array_equal(a, b) and np.array_equal(np.asarray(Image.open(t)), b)
    # metric-depth heads are inverted first
    tmono.generate_depth_maps(str(images), str(tmp_path / "p_inv"), predictor=predictor, predicts_inverse=False)
    jmono.generate_depth_maps(str(images), str(tmp_path / "j_inv"), predictor=predictor, predicts_inverse=False)
    assert_same_pngs(tmp_path / "p_inv", tmp_path / "j_inv")

    params = {}
    for name, mod in (("jax", jdepth), ("port", tdepth)):
        out = str(tmp_path / name / "depth_params.json")
        params[name] = mod.make_depth_params(sparse, str(tmp_path / name / "depths"), out_path=out)
    assert params["port"] == params["jax"]
    assert (tmp_path / "port" / "depth_params.json").read_bytes() == (tmp_path / "jax" / "depth_params.json").read_bytes()

    chunks = tmp_path / "chunks"
    shutil.copytree(tmp_path / "model", chunks / "chunk_0_0")
    tres = tmono.generate_depth_for_chunks(str(chunks), str(images), out_subdir="d_port", predictor=predictor)
    jres = jmono.generate_depth_for_chunks(str(chunks), str(images), out_subdir="d_jax", predictor=predictor)
    assert list(tres) == list(jres) == ["chunk_0_0"] and len(tres["chunk_0_0"]) == 4
    assert_same_pngs(chunks / "chunk_0_0" / "d_port", chunks / "chunk_0_0" / "d_jax")


def test_monodepth_command_backend_and_errors(tmp_path, monkeypatch):
    images = tmp_path / "images"
    images.mkdir()
    marker = tmp_path / "ran.json"
    script = tmp_path / "fake_depth.py"
    script.write_text(f"import json, sys\njson.dump(sys.argv[1:], open({str(marker)!r}, 'w'))\n")
    for mod, device_args in ((jmono, []), (tmono, ["--device", "cpu"])):
        mod.generate_depth_maps(str(images), str(tmp_path / "out"), command=[sys.executable, str(script), "--flag"])
        assert json.load(open(marker)) == ["--flag", str(images), str(tmp_path / "out")]
        marker.unlink()
        mod.main(["--images_dir", str(images), "--out_dir", str(tmp_path / "cli"), *device_args, "--command",
                  sys.executable, str(script), "flag"])
        assert json.load(open(marker)) == ["flag", str(images), str(tmp_path / "cli")]
        marker.unlink()
        with pytest.raises(ValueError, match="requires the command"):
            mod.generate_depth_maps(str(images), str(tmp_path / "out"), backend="command")
        with pytest.raises(ValueError, match="unknown backend"):
            mod.generate_depth_maps(str(images), str(tmp_path / "out"), backend="nope")
    # no predictor: the transformers backend cannot load (here: no package)
    monkeypatch.setitem(sys.modules, "transformers", None)
    for mod, device_kw in ((jmono, {}), (tmono, {"device": "cpu"})):
        with pytest.raises(RuntimeError, match="no monodepth predictor available"):
            mod.generate_depth_maps(str(images), str(tmp_path / "out"), model_name="nonexistent/model", **device_kw)
    assert tmono.list_images(str(images)) == jmono.list_images(str(images)) == []


# ------------------------------------------------------------ masks


def test_masks_equal_jax(tmp_path):
    from PIL import Image

    img = np.full((8, 8, 3), 128, np.uint8)
    img[:2, :] = 0
    for thr in (8.0 / 255.0, 0.6):
        assert np.array_equal(tmasks.black_border_mask(img, thr), jmasks.black_border_mask(img, thr))
        assert np.array_equal(tmasks.black_border_mask(img / 255.0, thr), jmasks.black_border_mask(img / 255.0, thr))
    for m in (np.array([[True, False]]), np.array([[0.9, 0.1]], np.float32), np.array([[60000, 10]], np.uint16),
              np.array([[200, 3]], np.uint8), np.zeros((2, 2, 3), np.uint8) + 255):
        assert np.array_equal(tmasks.normalize_mask(m), jmasks.normalize_mask(m))

    for name in ("jax", "port"):
        (tmp_path / name / "images").mkdir(parents=True)
        Image.fromarray(img).save(tmp_path / name / "images" / "a.png")
        Image.fromarray(img[..., 0]).save(tmp_path / name / "images" / "g.png")
        Image.fromarray(img).save(tmp_path / name / "images" / "c.jpg")
        masks = tmp_path / name / "masks"
        masks.mkdir()
        Image.fromarray((np.arange(64).reshape(8, 8) * 1000).astype(np.uint16)).save(masks / "m16.png")
        Image.fromarray(np.where(img[..., 0] > 0, 255, 0).astype(np.uint8)).save(masks / "m8.png")
    for name, mod in (("jax", jmasks), ("port", tmasks)):
        assert mod.prepare_masks(str(tmp_path / name / "images"), str(tmp_path / name / "bb"),
                                 from_black_border=True) == 3
        assert mod.prepare_masks(str(tmp_path / name / "images"), str(tmp_path / name / "masks")) == 2
    for sub in ("bb", "masks"):
        for f in sorted(os.listdir(tmp_path / "jax" / sub)):
            a = np.asarray(Image.open(tmp_path / "port" / sub / f))
            b = np.asarray(Image.open(tmp_path / "jax" / sub / f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (sub, f)
            assert np.array_equal(read_png(str(tmp_path / "port" / sub / f)), b), (sub, f)


def test_mask_writer_needs_no_pillow_for_pngs(tmp_path, monkeypatch):
    img = np.full((8, 8, 3), 128, np.uint8)
    img[:2] = 0
    (tmp_path / "images").mkdir()
    write_png(str(tmp_path / "images" / "a.png"), img)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert tmasks.prepare_masks(str(tmp_path / "images"), str(tmp_path / "masks"), from_black_border=True) == 1
    out = read_png(str(tmp_path / "masks" / "a.png"))
    assert (out[:2] == 0).all() and (out[2:] == 255).all()
