"""Port parity: preprocess, binning and the plain tile blend of
hidegs_tpu_torch against hidegs_tpu on the same inputs.

Tolerances and why:
  * preprocess floats: atol 1e-5 / rtol 1e-5, from transcendentals a few
    ulp apart between XLA and PyTorch; the integer radius may differ by 1
    on a stated share of rows (RADIUS_FLIP_SHARE).
  * binning: exactly equal — both run from the SAME preprocessed arrays
    (JAX's, converted), so only integer casts, comparisons and sorts differ.
  * blend planes: atol 3e-4 / rtol 1e-3 and `out_observe` exactly equal, the
    tolerance the JAX suite holds its Pallas kernel to (tests/test_pallas.py).
    The port sums log-transmittance per tile in float64 while the JAX paths
    sum in float32, so T near the 1e-4 cutoff may round across it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hidegs_tpu.data.synthetic import make_toy_gaussians as jtoy
from hidegs_tpu.data.synthetic import ring_camera as jring_camera
from hidegs_tpu.raster import binning as jbin
from hidegs_tpu.raster import preprocess as jpp
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu.raster.api import render as jrender
from hidegs_tpu.raster.blend_jnp import blend_tiles as jblend
from hidegs_tpu.raster.pallas_vjp import needed_blocks as jneeded_blocks
from hidegs_tpu_torch.convert import camera_from_jax
from hidegs_tpu_torch.raster import binning as tbin
from hidegs_tpu_torch.raster import blend_autograd, blend_plain, cuda_blend
from hidegs_tpu_torch.raster import preprocess as tpp
from hidegs_tpu_torch.raster.api import RasterConfig, render

torch.set_num_threads(1)

H, W = 64, 80
N_GAUSS = 250
BLEND_TOL = dict(atol=3e-4, rtol=1e-3)
PLANES = ["render", "invdepth", "alpha", "T_final", "normal", "distance"]
RADIUS_FLIP_SHARE = 0.01


def t(x):
    return torch.as_tensor(np.array(x))


def tcam_of(cam):
    leaves = [np.asarray(x) for x in (cam.R, cam.t, cam.fx, cam.fy, cam.cx, cam.cy)]
    return camera_from_jax(*leaves, cam.height, cam.width, cam.full_height, cam.full_width, device="cpu")


def pre_to_torch(pre):
    return tpp.PreprocessedGaussians(**{k: t(v) for k, v in pre._asdict().items()})


def binning_to_torch(tb):
    return tbin.TileBinning(**{k: t(v) for k, v in tb._asdict().items()})


@pytest.fixture(scope="module")
def scene():
    js = jtoy(N_GAUSS, seed=0)
    jc = jring_camera(0, height=H, width=W)
    return js, [t(x) for x in js], jc, tcam_of(jc)


def _preprocess_both(scene, tile, **kw):
    js, ts, jc, tc = scene
    ty, tx = jbin.tile_grid(H, W, tile)
    bounds = (tx * tile, ty * tile)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    jpre = jpp.preprocess_gaussians(*js, jc, screen_bounds=bounds, **jkw)
    tpre = tpp.preprocess_gaussians(*ts, tc, screen_bounds=bounds, **tkw)
    return jpre, tpre


def _assert_pre_close(tpre, jpre):
    np.testing.assert_array_equal(tpre.visible.numpy(), np.asarray(jpre.visible))
    dr = np.abs(tpre.radius.numpy() - np.asarray(jpre.radius))
    assert dr.max() <= 1 and (dr > 0).mean() <= RADIUS_FLIP_SHARE
    for k in ["mean2d", "conic", "depth", "inv_depth", "opacity", "rgb", "normal", "distance"]:
        np.testing.assert_allclose(
            getattr(tpre, k).numpy(), np.asarray(getattr(jpre, k)),
            atol=1e-5, rtol=1e-5, err_msg=k,
        )


@pytest.mark.parametrize("render_geo", [False, True])
def test_preprocess_matches_jax(scene, render_geo):
    offset = np.full((N_GAUSS, 2), 0.25, np.float32)
    jpre, tpre = _preprocess_both(scene, 16, render_geo=render_geo, mean2d_offset=offset,
                                  active_sh_degree=2)
    _assert_pre_close(tpre, jpre)


def test_preprocess_aabb_cull_and_exempt(scene):
    exempt = np.zeros(N_GAUSS, bool)
    exempt[::7] = True
    kw = dict(render_geo=True, boxmin=np.array([-1.5, -1.0, -1.2], np.float32),
              boxmax=np.array([1.0, 1.5, 1.4], np.float32), box_exempt=exempt)
    jpre, tpre = _preprocess_both(scene, 32, **kw)
    _assert_pre_close(tpre, jpre)
    # the cull bites and the exemption spares rows
    n_box = int(np.asarray(jpre.visible).sum())
    jfree, _ = _preprocess_both(scene, 32, render_geo=True)
    assert n_box < int(np.asarray(jfree.visible).sum())
    assert tpre.visible.numpy()[::7].sum() > 0


def test_compact_visible_matches_jax(scene):
    jpre, _ = _preprocess_both(scene, 16, render_geo=True)
    tpre = pre_to_torch(jpre)
    budget = int(np.asarray(jpre.visible).sum()) - 9  # overflows by 9
    jc, jv, jn, jo = jpp.compact_visible(jpre, budget)
    tcv, tv, tn, to = tpp.compact_visible(tpre, budget)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tn) == int(jn) and int(to) == int(jo) == 9
    for k, v in jc._asdict().items():
        np.testing.assert_array_equal(getattr(tcv, k).numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize(
    "tile,depth_bits",
    [(16, 0), (32, 0), (16, -1), (32, -1), (16, 7), (32, 7)],
)
def test_binning_exactly_equal(scene, tile, depth_bits):
    jpre, _ = _preprocess_both(scene, tile, render_geo=True)
    ty, tx = jbin.tile_grid(H, W, tile)
    max_inst = 1 << 12
    jtb = jbin.bin_gaussians(jpre, ty, tx, max_inst, tile, depth_bits=depth_bits)
    ttb = tbin.bin_gaussians(pre_to_torch(jpre), ty, tx, max_inst, tile, depth_bits=depth_bits)
    for k, v in jtb._asdict().items():
        np.testing.assert_array_equal(getattr(ttb, k).numpy(), np.asarray(v), err_msg=k)
    assert int(ttb.num_instances) > 0


def test_binning_overflow_exactly_equal(scene):
    jpre, _ = _preprocess_both(scene, 16, render_geo=False)
    ty, tx = jbin.tile_grid(H, W, 16)
    jtb = jbin.bin_gaussians(jpre, ty, tx, 128, 16)
    ttb = tbin.bin_gaussians(pre_to_torch(jpre), ty, tx, 128, 16)
    assert int(ttb.overflow) > 0
    for k, v in jtb._asdict().items():
        np.testing.assert_array_equal(getattr(ttb, k).numpy(), np.asarray(v), err_msg=k)


def _binned(scene, tile, depth_bits=0):
    jpre, _ = _preprocess_both(scene, tile, render_geo=True)
    ty, tx = jbin.tile_grid(H, W, tile)
    jtb = jbin.bin_gaussians(jpre, ty, tx, 1 << 12, tile, depth_bits=depth_bits)
    return jpre, jtb, ty, tx


def _assert_planes_close(tp, jp, keys=PLANES):
    for k in keys:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=k, **BLEND_TOL)
    np.testing.assert_array_equal(tp["out_observe"].numpy(), np.asarray(jp["out_observe"]))


@pytest.mark.parametrize("tile", [16, 32])
def test_plain_blend_matches_jnp(scene, tile, monkeypatch):
    jpre, jtb, ty, tx = _binned(scene, tile)
    jp = jblend(jpre, jtb, ty, tx, tile)
    tp = blend_plain.blend_tiles(pre_to_torch(jpre), binning_to_torch(jtb), ty, tx, tile)
    _assert_planes_close(tp, jp)
    # tile groups of a few instances give the same planes as one group
    monkeypatch.setattr(blend_plain, "GROUP_INSTANCES", 24)
    tg = blend_plain.blend_tiles(pre_to_torch(jpre), binning_to_torch(jtb), ty, tx, tile)
    for k in PLANES + ["out_observe"]:
        torch.testing.assert_close(tg[k], tp[k], atol=1e-6, rtol=1e-6)


def test_blend_wrapper_takes_plain_on_cpu(scene):
    jpre, jtb, ty, tx = _binned(scene, 16)
    pre, tb = pre_to_torch(jpre), binning_to_torch(jtb)
    before = (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES)
    a = blend_autograd.blend_tiles(pre, tb, ty, tx, 16)
    b = blend_plain.blend_tiles(pre, tb, ty, tx, 16)
    assert (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES) == before
    for k in PLANES + ["out_observe"]:
        assert torch.equal(a[k], b[k]), k


def test_plain_blend_matches_pallas_interpret(scene):
    """The Pallas kernel itself, run as tests/test_pallas.py runs it on the
    CPU, at the production tile (32) with render_geo on; once with an ample
    block budget and once with one too small (tiles past it render empty)."""
    js, ts, jc, tc = scene
    for max_blocks in (0, 2):
        with pltpu.force_tpu_interpret_mode():
            jo = jrender(*js, jc, render_geo=True, config=JConfig(
                backend="pallas", tile=32, max_instances=1 << 12, max_blocks=max_blocks))
        to = render(*ts, tc, render_geo=True, config=RasterConfig(
            backend="plain", tile=32, max_instances=1 << 12, max_blocks=max_blocks))
        keys = ["render", "invdepth", "alpha", "T_final", "rendered_normal", "rendered_distance"]
        _assert_planes_close(to, jo, keys)
        for k in ("needed_blocks", "block_overflow", "num_instances", "overflow"):
            assert int(to[k]) == int(jo[k]), k
        if max_blocks:
            assert int(to["block_overflow"]) > 0


def test_pair_counts_match_sequential_walk(scene):
    """The kernel bound's pair counts against a per-tile front-to-back walk
    in numpy: an instance is reached while some pixel of its tile still has
    T ≥ 1e-4, a reached pair is kept where α ≥ 1/255, and a kept pair is
    open where its own pixel still has T ≥ 1e-4."""
    tile = 16
    jpre, jtb, ty, tx = _binned(scene, tile)
    live, kept, open_ = blend_plain.pair_counts(pre_to_torch(jpre), binning_to_torch(jtb), tx, tile)
    m, c, op = (np.asarray(x, np.float64) for x in (jpre.mean2d, jpre.conic, jpre.opacity))
    starts, counts, gid = (np.asarray(x) for x in (jtb.tile_start, jtb.tile_count, jtb.gauss_id))
    lin = np.arange(tile * tile)
    want_live = want_kept = want_open = 0
    for tid in range(ty * tx):
        px = (tid % tx) * tile + lin % tile + 0.5
        py = (tid // tx) * tile + lin // tile + 0.5
        T = np.ones(tile * tile)
        for g in gid[starts[tid]:starts[tid] + counts[tid]]:
            if (T < 1e-4).all():
                break
            dx, dy = px - m[g, 0], py - m[g, 1]
            power = -0.5 * (c[g, 0] * dx * dx + c[g, 2] * dy * dy) - c[g, 1] * dx * dy
            a = np.minimum(0.99, op[g] * np.exp(np.minimum(power, 0.0)))
            keep = (power <= 0) & (a >= 1 / 255)
            want_live += tile * tile
            want_kept += int(keep.sum())
            want_open += int((keep & (T >= 1e-4)).sum())
            T = T * np.where(keep, 1 - a, 1.0)
    assert (live, kept, open_) == (want_live, want_kept, want_open)
    assert 0 < open_ <= kept < live


def test_needed_blocks_and_visited(scene):
    jpre, jtb, ty, tx = _binned(scene, 16)
    tb = binning_to_torch(jtb)
    assert int(blend_plain.needed_blocks(tb.tile_count)) == int(jneeded_blocks(jtb.tile_count))
    I = tb.gauss_id.shape[0]
    assert bool(blend_plain.visited_tiles(tb.tile_count, I, 0).all())
    vis = blend_plain.visited_tiles(tb.tile_count, I, 3).numpy()
    # the visited tiles are the prefix whose aligned first block is < 3
    padded = -(-tb.tile_count.numpy() // 128) * 128
    astart = np.cumsum(padded) - padded
    np.testing.assert_array_equal(vis, astart // 128 < 3)
