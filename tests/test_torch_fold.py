"""The gradient fold's layout and order, on the CPU.

The backward kernel writes the row of sorted instance k straight into
expansion slot slot_s[k] of a zero-filled buffer, and the fold kernel sums
each gaussian's contiguous span of that buffer in slot order. Here: that
placement gives the rows `blend_plain.expansion_rows` gives (on a real
binning, with and without a too-small block budget), the plain fold sums
spans in slot order with float32 adds (empty spans, a span cut at the
budget, the last gaussian), and the fold kernel's traversal (four lanes per
gaussian, eight gaussians per warp, one warp per group of eight) covers
every gaussian once and reads only the span bounds it needs. All exact.
"""
import numpy as np
import pytest
import torch

from hidegs_tpu_torch.data import synthetic as tsyn
from hidegs_tpu_torch.raster import binning as tbin
from hidegs_tpu_torch.raster import blend_plain
from hidegs_tpu_torch.raster import preprocess as tpp

torch.set_num_threads(1)


def _problem(tile, max_instances=1 << 13):
    scene = tsyn.make_toy_gaussians(160, seed=5, device="cpu")
    cam = tsyn.ring_camera(1, height=48, width=64, device="cpu")
    ty, tx = tbin.tile_grid(48, 64, tile)
    pre = tpp.preprocess_gaussians(*scene, cam, render_geo=True, screen_bounds=(tx * tile, ty * tile))
    return pre, tbin.bin_gaussians(pre, ty, tx, max_instances, tile), ty, tx


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("truncated", [False, True])
def test_rows_placed_by_slot_equal_expansion_rows(tile, truncated):
    """Rows written at slot_s[k] into a zero-filled buffer (the backward
    kernel's store) are expansion_rows' rows, and fold to the same
    gradients bitwise."""
    pre, tb, ty, tx = _problem(tile)
    I = tb.gauss_id.shape[0]
    assert torch.equal(torch.sort(tb.slot_s.long()).values, torch.arange(I))  # a permutation
    max_blocks = max(int(blend_plain.needed_blocks(tb.tile_count)) // 2, 1) if truncated else 0
    view = blend_plain.unpack_attrs(blend_plain.pack_gaussian_attrs(pre))
    tile_out, _ = blend_plain.blend_tile_out(view, tb, ty, tx, tile, max_blocks)
    g = torch.randn(tile_out.shape, generator=torch.Generator().manual_seed(tile))
    g_aug = blend_plain.augment_cotangents(tile_out, g)
    rows = blend_plain.blend_tiles_bwd(view, tb, g_aug, ty, tx, tile, max_blocks)
    placed = torch.zeros_like(rows)
    placed[tb.slot_s.long()] = rows
    want = blend_plain.expansion_rows(rows, tb.slot_s)
    assert torch.equal(placed, want)
    folded = blend_plain.fold_rows(placed, tb.g_start)
    assert torch.equal(folded, blend_plain.fold_rows(want, tb.g_start))
    assert float(folded.abs().max()) > 0


def _loop_fold(rows_exp, g_start):
    """The fold as a loop: each gaussian's span in slot order, float32 adds
    from 0."""
    rows = rows_exp.numpy()
    bounds = g_start.numpy()
    out = np.zeros((bounds.shape[0] - 1, rows.shape[1]), np.float32)
    for g in range(out.shape[0]):
        acc = np.zeros(rows.shape[1], np.float32)
        for j in range(bounds[g], bounds[g + 1]):
            acc = (acc + rows[j]).astype(np.float32)
        out[g] = acc
    return out


@pytest.mark.parametrize("case", ["empty_spans", "budget_cut", "last_gaussian", "long_spans"])
def test_plain_fold_sums_spans_in_slot_order(case):
    rng = np.random.default_rng(3)
    lengths = {
        "empty_spans": [0, 0, 3, 0, 1, 0, 0, 2, 0],
        "budget_cut": [2, 0, 5, 3, 0, 7, 4],  # runs past the budget below
        "last_gaussian": [1, 0, 0, 0, 0, 0, 0, 0, 0, 6],
        "long_spans": [17, 0, 9, 33, 1, 4, 0, 8],
    }[case]
    total = int(np.sum(lengths))
    I = total - 6 if case == "budget_cut" else total + 3  # rows past g_start[N] drop
    starts = np.concatenate([[0], np.cumsum(lengths)])
    g_start = torch.tensor(np.minimum(starts, I), dtype=torch.int32)
    # magnitudes that make the float32 sum order visible
    rows_exp = torch.tensor((rng.normal(size=(I, 16)) * 10.0 ** rng.integers(-4, 5, (I, 1))).astype(np.float32))
    got = blend_plain.fold_rows(rows_exp, g_start)
    want = _loop_fold(rows_exp, g_start)
    assert np.array_equal(got.numpy(), want)
    empty = np.diff(g_start.numpy()) == 0
    assert np.all(got.numpy()[empty] == 0.0)


def _kernel_traversal(num_gaussians, threads=256, lanes=4):
    """Which (gaussian, float4) each lane of hidegs_fold_rows's grid writes,
    and which g_start entries it reads, following csrc/blend_bwd.cu: the
    launch (one warp per group of 8 gaussians, in whole CTAs of 8 warps)
    and fold_rows_kernel (warp w takes gaussians 8w..8w+7, lanes 0..8 read
    their 9 bounds, warps past the last group return)."""
    per_warp, warps_per_cta = 32 // lanes, threads // 32
    groups = -(-num_gaussians // per_warp)
    warps = -(-groups // warps_per_cta) * warps_per_cta
    writes, reads = [], []
    for w in range(warps):
        g0 = w * per_warp
        if g0 >= num_gaussians:
            continue
        reads.extend(g0 + lane for lane in range(per_warp + 1) if g0 + lane <= num_gaussians)
        for lane in range(32):
            g = g0 + lane // lanes
            if g < num_gaussians:
                writes.append((g, lane % lanes))
    return writes, reads


@pytest.mark.parametrize("num_gaussians", [1, 8, 63, 65, 1000, 4099])
def test_fold_kernel_traversal_covers_each_gaussian_once(num_gaussians):
    writes, reads = _kernel_traversal(num_gaussians)
    assert sorted(writes) == [(g, q) for g in range(num_gaussians) for q in range(4)]
    assert set(reads) == set(range(num_gaussians + 1)) and max(reads) <= num_gaussians
