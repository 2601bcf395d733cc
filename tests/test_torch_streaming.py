"""Port parity: out-of-core chunk streaming (hier/streaming.py) of
hidegs_tpu_torch against hidegs_tpu, on the CPU, on the 2x2 grid of chunk
hierarchies of tests/test_streaming.py, written by the JAX package's
builder and writer.

Residency, LRU loads and the cut's integer fields are exactly equal; the
interpolated arrays within 1e-6 (exp of the log scales, and the lerps);
the rendered view at the blend tolerance, atol 3e-4 / rtol 1e-3.
"""
import numpy as np
import pytest
import torch

from hidegs_tpu.data import synthetic as jsyn
from hidegs_tpu.hier.build import _build_hierarchy_py
from hidegs_tpu.hier.io import write_hier
from hidegs_tpu.hier.streaming import ChunkStreamer as JStreamer
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.hier.streaming import ChunkStreamer
from hidegs_tpu_torch.raster.api import RasterConfig

torch.set_num_threads(1)


def toy_chunk(n, seed, center):
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(-3.0, 3.0, (n, 3)) + center).astype(np.float32)
    scale = np.exp(rng.uniform(np.log(0.02), np.log(0.12), (n, 3))).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    alpha = rng.uniform(0.3, 0.95, n).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    return pos, rot, scale, alpha, shs


@pytest.fixture(scope="module")
def chunk_grid(tmp_path_factory):
    """2x2 grid of chunk hierarchies on disk."""
    root = tmp_path_factory.mktemp("chunks")
    for i in range(2):
        for j in range(2):
            center = np.array([i * 10.0 - 5.0, j * 10.0 - 5.0, 0.0])
            h = _build_hierarchy_py(*toy_chunk(24, i * 2 + j, center))
            d = root / f"chunk_{i}_{j}"
            d.mkdir()
            write_hier(str(d / "hierarchy.hier"), h)
            np.savetxt(d / "center.txt", center[None])
            np.savetxt(d / "extent.txt", np.array([[10.0, 10.0, 10.0]]))
    return root


def tcam_of(cam):
    leaves = [np.asarray(x) for x in (cam.R, cam.t, cam.fx, cam.fy, cam.cx, cam.cy)]
    return convert.camera_from_jax(*leaves, cam.height, cam.width, device="cpu")


def test_residency_and_lru_match_jax(chunk_grid):
    kw = dict(max_resident=2, active_radius_chunks=1.0)
    st, js = ChunkStreamer(str(chunk_grid), device="cpu", **kw), JStreamer(str(chunk_grid), **kw)
    assert [c[0] for c in st.chunks] == [c[0] for c in js.chunks] and len(st.chunks) == 4
    for vp in ([-5.0, -5.0, 0.0], [100.0, 100.0, 0.0], [0.0, 0.0, 0.0], [4.9, -5.0, 3.0]):
        assert st.active_chunks(np.array(vp)) == js.active_chunks(np.array(vp))
    assert len(st.active_chunks(np.array([-5.0, -5.0, 0.0]))) == 1
    for idx in [0, 1, 2, 3, 0, 0, 3]:
        h, jh = st.get(idx), js.get(idx)
        np.testing.assert_array_equal(h.nodes, jh.nodes)
        assert st.resident == js.resident
    assert len(st.resident) == 2
    assert st.loads == js.loads == 5  # chunk 0 was evicted and loaded again


@pytest.mark.parametrize("target_size", [1e-9, 0.05])
def test_gather_cut_and_render_view_match_jax(chunk_grid, target_size):
    jcam = jsyn.ring_camera(0, height=48, width=48, radius=12.0, target=(-5.0, 0.0, -5.0))
    tcam = tcam_of(jcam)
    st = ChunkStreamer(str(chunk_grid), active_radius_chunks=1.2, device="cpu")
    js = JStreamer(str(chunk_grid), active_radius_chunks=1.2)
    got = st.gather_cut(tcam, target_size, budget_per_chunk=64)
    want = js.gather_cut(jcam, target_size, budget_per_chunk=64)
    assert st.resident == js.resident and st.loads == js.loads
    for name, g, w in zip(["means3d", "scales", "quats", "opacities", "shs"], got, want):
        assert g.shape == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6, err_msg=name)
    out = st.render_view(tcam, target_size, config=RasterConfig(max_instances=1 << 13), budget_per_chunk=64)
    jout = js.render_view(jcam, target_size, config=JConfig(backend="jnp", max_instances=1 << 13),
                          budget_per_chunk=64)
    for key in ("render", "alpha", "invdepth", "T_final"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), atol=3e-4, rtol=1e-3, err_msg=key)
    img = out["render"].numpy()
    assert np.isfinite(img).all() and img.max() > 0.01  # streamed content rendered
