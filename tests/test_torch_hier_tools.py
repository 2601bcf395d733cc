"""Port parity: the hierarchy tools (hier/refine.py, hier/merge.py and
`python -m hidegs_tpu_torch.hier.cli create|merge`) against hidegs_tpu, on
the CPU.

Inputs are numpy-seeded toy leaves and a toy COLMAP scene written by the
port. Tolerance: none. The refinement passes and the merge are the same
numpy code in both packages, the builder is the same C++ source, so every
array and every file the CLIs write is bitwise the JAX package's.
"""
import os

import numpy as np
import pytest
import torch

from hidegs_tpu.hier import build as jbuild
from hidegs_tpu.hier import cli as jcli
from hidegs_tpu.hier import merge as jmerge
from hidegs_tpu.hier import refine as jrefine
from hidegs_tpu_torch.data import synthetic as tsyn
from hidegs_tpu_torch.hier import cli as tcli
from hidegs_tpu_torch.hier import io as tio
from hidegs_tpu_torch.hier import merge as tmerge
from hidegs_tpu_torch.hier import refine as trefine
from hidegs_tpu_torch.raster.api import RasterConfig
from hidegs_tpu_torch.utils.ply import gaussian_properties, write_ply

torch.set_num_threads(1)


def toy_leaves(n, seed=0, extent=2.0, offset=(0.0, 0.0, 0.0)):
    """(pos, rot, scale, alpha, shs) numpy leaves in a cube of half-width
    `extent` around `offset`, with full SH."""
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(-extent, extent, (n, 3)) + np.asarray(offset)).astype(np.float32)
    scale = np.exp(rng.uniform(np.log(0.02), np.log(0.12), (n, 3))).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    alpha = rng.uniform(0.3, 0.95, n).astype(np.float32)
    shs = (rng.normal(size=(n, 16, 3)) * 0.2).astype(np.float32)
    return pos, rot, scale, alpha, shs


def assert_hier_equal(a, b):
    for name in tio.Hierarchy._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def both(h):
    return h, tio.Hierarchy(*h)


@pytest.mark.parametrize("seed", [3, 4])
def test_align_rotations_bitwise_jax(seed):
    jh, th = both(jbuild._build_hierarchy_py(*toy_leaves(48, seed=seed)))
    assert_hier_equal(trefine.align_rotations(th), jrefine.align_rotations(jh))


@pytest.mark.parametrize("limit", [5e-4, 0.05])
def test_appearance_filter_and_anchors_bitwise_jax(limit):
    """The JAX suite's cases: far cameras and a coarse limit collapse
    detail; a camera next to the scene at the default limit keeps it."""
    pos, *rest = toy_leaves(64, seed=5)
    jh, th = both(jbuild._build_hierarchy_py(pos, *rest))
    cams = np.array([[0.0, 0.0, 10.0], [10.0, 0.0, 0.0]], np.float32)
    if limit == 5e-4:
        cams = np.concatenate([cams, pos[:1] + np.array([[0.0, 0.0, 0.05]], np.float32)])
    jf, tf = jrefine.appearance_filter(jh, cams, limit=limit), trefine.appearance_filter(th, cams, limit=limit)
    assert_hier_equal(tf, jf)
    ja, ta = jrefine.compute_anchors(jf, cams, limit=limit), trefine.compute_anchors(tf, cams, limit=limit)
    assert ta.dtype == ja.dtype and np.array_equal(ta, ja) and len(ta) > 0
    if limit == 0.05:
        assert tf.num_nodes < th.num_nodes


def _chunk_hiers():
    hs, centers, extents = [], [], []
    for k, off in enumerate([(-3.0, 0.0, 0.0), (3.0, 0.0, 0.0), (0.0, 4.0, 0.0)]):
        hs.append(jbuild._build_hierarchy_py(*toy_leaves(24 + 8 * k, seed=k, extent=1.5, offset=off)))
        centers.append(np.array(off))
        extents.append(np.array([2.0, 2.0, 6.0]))
    return hs, centers, extents


@pytest.mark.parametrize("filtered", [False, True])
def test_merge_hierarchies_bitwise_jax(filtered):
    hs, centers, extents = _chunk_hiers()
    kw = dict(centers=centers, extents=extents, slack=0.1) if filtered else {}
    jm = jmerge.merge_hierarchies(hs, **kw)
    tm = tmerge.merge_hierarchies([tio.Hierarchy(*h) for h in hs], **kw)
    assert_hier_equal(tm, jm)
    assert tm.num_points == sum(h.num_points for h in hs) + 1
    if filtered:
        assert (tm.alpha == 0).any()


def _write_ply(path, pos, rot, scale, alpha, shs):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_ply(path, gaussian_properties(pos, shs[:, 0], shs[:, 1:], np.log(alpha / (1 - alpha)), np.log(scale), rot))


@pytest.fixture(scope="module")
def camera_scene(tmp_path_factory):
    """A toy COLMAP scene (4 ring views, 32x32) whose cameras feed
    `create --cameras`."""
    root = tmp_path_factory.mktemp("cams")
    scene = tsyn.make_toy_gaussians(60, seed=2, device="cpu")
    cams = [tsyn.ring_camera(i, n_cams=4, radius=4.0, height=32, width=32, device="cpu") for i in range(4)]
    tsyn.write_synthetic_colmap_scene(str(root), scene, cams, RasterConfig(max_instances=1 << 12))
    return str(root)


@pytest.mark.parametrize("flags", [[], ["--no_align"], ["--cameras"], ["--cameras", "--filter_limit", "0.05"]],
                         ids=["plain", "no_align", "cameras", "cameras_filtered"])
def test_cli_create_writes_the_jax_files(tmp_path, camera_scene, flags):
    ply = str(tmp_path / "model" / "point_cloud.ply")
    _write_ply(ply, *toy_leaves(80, seed=11))
    flags = list(flags)
    if "--cameras" in flags:
        flags.insert(flags.index("--cameras") + 1, camera_scene)
    outs = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        out = tmp_path / name / "hierarchy.hier"
        out.parent.mkdir()
        main(["create", "--ply", ply, "--out", str(out)] + flags + extra)
        outs[name] = out
    assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    anchors = [p.parent / "anchors.bin" for p in (outs["jax"], outs["port"])]
    assert anchors[1].exists() == anchors[0].exists() == ("--cameras" in flags)
    if anchors[0].exists():
        assert anchors[1].read_bytes() == anchors[0].read_bytes()
        assert len(tio.read_anchors(str(anchors[1]))) > 0


def test_cli_merge_writes_the_jax_file(tmp_path):
    hs, centers, extents = _chunk_hiers()
    chunks = tmp_path / "chunks"
    for k, (h, c, e) in enumerate(zip(hs, centers, extents)):
        d = chunks / f"chunk_{k // 2}_{k % 2}"
        d.mkdir(parents=True)
        tio.write_hier(str(d / "hierarchy.hier"), tio.Hierarchy(*h))
        np.savetxt(d / "center.txt", c)
        np.savetxt(d / "extent.txt", e)
    (chunks / "chunk_9_9").mkdir()  # no hierarchy: skipped by both
    jcli.main(["merge", "--chunks", str(chunks), "--out", str(tmp_path / "jax.hier")])
    tcli.main(["merge", "--chunks", str(chunks), "--out", str(tmp_path / "port.hier")])
    assert (tmp_path / "port.hier").read_bytes() == (tmp_path / "jax.hier").read_bytes()
    assert tio.read_hier(str(tmp_path / "port.hier")).num_points == sum(h.num_points for h in hs) + 1
    with pytest.raises(SystemExit, match="no chunk hierarchies"):
        tcli.main(["merge", "--chunks", str(tmp_path / "nothing"), "--out", str(tmp_path / "x.hier")])
