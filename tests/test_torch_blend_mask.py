"""The blend kernels' warp-block mask, on the CPU.

`blend_plain.block_masks` is the plain version of the mask the CUDA kernels
compute at staging time (csrc/blend_common.cuh): bit b of an instance's mask
says whether its α ≥ 1/255 level set can reach 8x4 block b of its tile, and
a warp skips the blocks whose bit is clear. The kernels are bitwise right
only if the mask is conservative, so these tests hold it to that on
`make_blend_boundary_scene`, whose level sets end on block corners and edges
(including thin, near-singular conics and opacities at 1/255 and near 1),
at tiles 16 and 32: every (instance, block) pair the mask clears must have no
pixel with power ≤ 0 and α ≥ 1/255 under the kernels' float32 formula. The
pair count behind the kernels' evaluated-pairs figure is held against a
brute-force numpy count, exactly. No JAX function computes the mask (the
JAX kernels evaluate every pixel of a tile), so nothing here runs JAX.
"""
import sys

import numpy as np
import pytest
import torch

from hidegs_tpu_torch.data.synthetic import BOUNDARY_FAMILIES, make_blend_boundary_scene
from hidegs_tpu_torch.raster import binning as tbin
from hidegs_tpu_torch.raster import blend_plain, cuda_blend

H, W = 64, 96


def _binned(tile, families=BOUNDARY_FAMILIES, max_blocks=0):
    pre = make_blend_boundary_scene(families, height=H, width=W, seed=7, device="cpu")
    ty, tx = tbin.tile_grid(H, W, tile)
    tb = tbin.bin_gaussians(pre, ty, tx, 1 << 16, tile)
    assert int(tb.overflow) == 0
    return pre, tb, tx, cuda_blend.visited_count(tb, max_blocks)


def _block_pixels(tile):
    """(blocks, 32) tile-local x and y of each block's pixels, lane order."""
    x0, y0 = blend_plain.block_origins(tile)
    lane = torch.arange(32)
    return x0[:, None] + lane % 8, y0[:, None] + lane // 8


@pytest.mark.parametrize("tile", [16, 32])
def test_blocks_cover_the_tile_once(tile):
    x, y = _block_pixels(tile)
    pix = (y * tile + x).flatten()
    assert torch.equal(torch.sort(pix).values, torch.arange(tile * tile))
    # warp w's blocks (bits w·PPT ... ) form one compact region
    ppt = tile * tile // 256
    for w in range(8):
        xs, ys = x[w * ppt:(w + 1) * ppt], y[w * ppt:(w + 1) * ppt]
        assert int(xs.max() - xs.min() + 1) * int(ys.max() - ys.min() + 1) == 32 * ppt


@pytest.mark.parametrize("family", BOUNDARY_FAMILIES)
@pytest.mark.parametrize("tile", [16, 32])
def test_mask_is_conservative(tile, family):
    pre, tb, tx, count = _binned(tile, (family,))
    masks = blend_plain.block_masks(pre, tb, tx, tile, count)
    n = int(count.sum())
    assert n > 0
    # the visited spans are the prefix of the sorted stream
    gid, tid, bits = tb.gauss_id[:n].long(), tb.tile_id[:n].long(), masks[:n]
    x, y = _block_pixels(tile)
    ox = ((tid % tx) * tile).to(torch.float32)[:, None, None]
    oy = (torch.div(tid, tx, rounding_mode="floor") * tile).to(torch.float32)[:, None, None]
    px = (x.to(torch.float32) + 0.5)[None] + ox
    py = (y.to(torch.float32) + 0.5)[None] + oy
    u, v = pre.mean2d[gid, 0][:, None, None], pre.mean2d[gid, 1][:, None, None]
    a, b, c = (pre.conic[gid, i][:, None, None] for i in range(3))
    op = pre.opacity[gid][:, None, None]
    # the kernels' formula, op for op in float32
    dx, dy = px - u, py - v
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=blend_plain.ALPHA_MAX)
    kept_px = (power <= 0.0) & (alpha >= blend_plain.ALPHA_MIN)
    nb = x.shape[0]
    on = ((bits[:, None] >> torch.arange(nb)[None]) & 1).bool()
    missed = kept_px & ~on[:, :, None]
    assert not bool(missed.any()), f"{int(missed.sum())} kept pixels in blocks the mask cleared"
    # not vacuous: the mask clears blocks, and keeps blocks with kept pixels
    assert int((~on).sum()) > 0 and bool((kept_px & on[:, :, None]).any())


def _numpy_block_pairs(pre, tb, tx, tile, count):
    """Brute force: per visited tile, walk its instances front to back in
    float32 with a float64 log-transmittance sum (as the plain blend does),
    find those reached before the tile went opaque, and add 32 pixels for
    each block whose box minimum of q passes the mask's test."""
    mean = pre.mean2d.numpy()
    conic = pre.conic.numpy()
    opac = pre.opacity.numpy()
    gid_all = tb.gauss_id.numpy()
    starts = tb.tile_start.numpy()
    x0, y0 = (o.numpy() for o in blend_plain.block_origins(tile))
    lin = np.arange(tile * tile)
    f32 = np.float32
    total = 0
    for t, n in enumerate(count.numpy()):
        if n == 0:
            continue
        g = gid_all[starts[t]:starts[t] + n]
        ox, oy = (t % tx) * tile, (t // tx) * tile
        u, v = mean[g, 0:1], mean[g, 1:2]
        a, b, c = conic[g, 0:1], conic[g, 1:2], conic[g, 2:3]
        op = opac[g, None]
        px = (lin % tile).astype(f32) + f32(0.5) + f32(ox)
        py = (lin // tile).astype(f32) + f32(0.5) + f32(oy)
        dx, dy = px[None] - u, py[None] - v
        power = f32(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = np.minimum(op * np.exp(np.minimum(power, f32(0))), f32(blend_plain.ALPHA_MAX))
        alpha = np.where((power <= 0) & (alpha >= f32(blend_plain.ALPHA_MIN)), alpha, f32(0))
        lt = np.log1p(-alpha).astype(np.float64)
        T_excl = np.exp((np.cumsum(lt, 0) - lt).astype(f32))
        reached = (T_excl >= f32(blend_plain.T_EPS)).any(axis=1)
        for j in np.flatnonzero(reached):
            for bx, by in zip(x0, y0):
                lo_x = (f32(bx + 0.5) + f32(ox)) - u[j, 0]
                hi_x = (f32(bx + 0.5) + f32(ox) + f32(7)) - u[j, 0]
                lo_y = (f32(by + 0.5) + f32(oy)) - v[j, 0]
                hi_y = (f32(by + 0.5) + f32(oy) + f32(3)) - v[j, 0]
                ca, cb, cc = a[j, 0], b[j, 0], c[j, 0]
                q = []
                for ex in (lo_x, hi_x):
                    e = min(max(-cb * ex / max(cc, f32(1e-12)), lo_y), hi_y)
                    q.append(f32(0.5) * (ca * ex * ex + cc * e * e) + cb * ex * e)
                for ey in (lo_y, hi_y):
                    e = min(max(-cb * ey / max(ca, f32(1e-12)), lo_x), hi_x)
                    q.append(f32(0.5) * (ca * e * e + cc * ey * ey) + cb * e * ey)
                q_min = f32(0) if (lo_x <= 0 <= hi_x and lo_y <= 0 <= hi_y) else min(q)
                mx, my = max(abs(lo_x), abs(hi_x)), max(abs(lo_y), abs(hi_y))
                size = f32(0.5) * (abs(ca) * mx * mx + abs(cc) * my * my) + abs(cb) * mx * my
                budget = (np.log(max(op[j, 0], f32(1e-12)) * f32(255)) + f32(blend_plain.MASK_MARGIN)
                          + f32(blend_plain.MASK_REL_MARGIN) * size)
                total += 32 * int(not q_min > budget)
    return total


@pytest.mark.parametrize("tile,max_blocks", [(16, 0), (32, 0), (16, 3), (32, 5)])
def test_block_pair_counts_match_numpy(tile, max_blocks):
    pre, tb, tx, count = _binned(tile, ("random", "corner", "thin"), max_blocks)
    got = blend_plain.block_pair_counts(pre, tb, tx, tile, count)
    assert got == _numpy_block_pairs(pre, tb, tx, tile, count)
    live = blend_plain.pair_counts(pre, tb, tx, tile, max_blocks)[0]
    assert 0 < got < live


def test_library_path_hashes_the_headers(tmp_path, monkeypatch):
    for src in cuda_blend.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(cuda_blend, "SOURCES", {name: tmp_path / p.name for name, p in cuda_blend.SOURCES.items()})
    before = {name: cuda_blend._lib_path(src) for name, src in cuda_blend.SOURCES.items()}
    assert before == {name: cuda_blend._lib_path(src) for name, src in cuda_blend.SOURCES.items()}
    header = tmp_path / "blend_common.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    after = {name: cuda_blend._lib_path(src) for name, src in cuda_blend.SOURCES.items()}
    assert all(after[name] != before[name] for name in cuda_blend.SOURCES)


def test_build_compiles_each_library_once(tmp_path, monkeypatch):
    """Two names for sources with the same text and headers (this checkout
    and a copy of it, as tools/blend_kernel_ab.py passes them) are one
    library: build() runs the compiler once for it and maps both names to
    it."""
    copy = tmp_path / "copy"
    copy.mkdir()
    for src in cuda_blend.CSRC.iterdir():
        (copy / src.name).write_bytes(src.read_bytes())
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"open({str(calls)!r}, 'a').write(sys.argv[-1] + '\\n')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n"
    )
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_blend, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_blend, "BUILD_DIR", tmp_path / "kernels")
    libs = cuda_blend.build({"this": cuda_blend.SOURCES["blend_bwd"], "copy": copy / "blend_bwd.cu"})
    assert libs["this"] == libs["copy"] and libs["this"].read_bytes() == b"lib"
    assert len(calls.read_text().splitlines()) == 1
    assert cuda_blend.build({"again": copy / "blend_bwd.cu"}) == {"again": libs["this"]}
    assert len(calls.read_text().splitlines()) == 1
