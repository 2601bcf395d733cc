"""The differentiable tile blend of the "blend" backend.

Port of the `blend_packed` custom VJP (hidegs_tpu/raster/pallas_vjp.py:249-284,
381-457) as a `torch.autograd.Function`: per-gaussian packed rows
(`blend_plain.pack_gaussian_attrs`) and the binning in, the (T, P, 16) tile
planes and per-gaussian observe counts out.

  * forward: the CUDA kernel on CUDA tensors (raster/cuda_blend.py), the
    plain blend on CPU tensors; the tile planes are saved for the backward;
  * backward: G_total = Σ_ch out·g (T_final masked) and T_final·g_T ride
    channels 10 and 11 of the cotangents, then the backward kernel (or its
    plain version, `blend_plain.blend_tiles_bwd`) gives one gradient row per
    sorted instance, and the rows are summed per gaussian in expansion order
    (each gaussian's instances are contiguous there): the fold kernel on
    CUDA, `blend_plain.fold_rows` on the CPU. No float atomics, so the
    gradient is bitwise reproducible.

On a CUDA tensor the kernels run or the call raises; nothing falls back.
"""
from __future__ import annotations

from typing import Dict

import torch

from hidegs_tpu_torch.raster import blend_plain, cuda_blend
from hidegs_tpu_torch.raster.binning import TILE, TileBinning
from hidegs_tpu_torch.raster.preprocess import PreprocessedGaussians


class BlendPacked(torch.autograd.Function):
    """(N, 16) packed rows → ((T, P, 16) tile planes, (N,) int32 observe)."""

    @staticmethod
    def forward(ctx, attrs, binning: TileBinning, tiles_y: int, tiles_x: int, tile: int, max_blocks: int):
        if attrs.device.type == "cpu":
            count = None
            tile_out, observe = blend_plain.blend_tile_out(
                blend_plain.unpack_attrs(attrs), binning, tiles_y, tiles_x, tile, max_blocks)
        else:
            count = cuda_blend.visited_count(binning, max_blocks)
            tile_out, observe = cuda_blend.blend_tile_out(attrs, binning, count, tiles_y, tiles_x, tile)
        ctx.save_for_backward(attrs, tile_out)
        ctx.binning = binning
        ctx.count = count
        ctx.args = (tiles_y, tiles_x, tile, max_blocks)
        ctx.mark_non_differentiable(observe)
        return tile_out, observe

    @staticmethod
    def backward(ctx, g_tiles, _g_observe):
        attrs, tile_out = ctx.saved_tensors
        binning = ctx.binning
        tiles_y, tiles_x, tile, max_blocks = ctx.args
        g_aug = blend_plain.augment_cotangents(tile_out, g_tiles.contiguous())
        if attrs.device.type == "cpu":
            rows = blend_plain.blend_tiles_bwd(
                blend_plain.unpack_attrs(attrs), binning, g_aug, tiles_y, tiles_x, tile, max_blocks)
            d_attrs = blend_plain.fold_rows(blend_plain.expansion_rows(rows, binning.slot_s), binning.g_start)
        else:
            d_attrs = cuda_blend.grad_attrs(attrs, binning, ctx.count, g_aug, tiles_x, tile)
        return d_attrs, None, None, None, None, None


def blend_tiles(
    pre: PreprocessedGaussians,
    binning: TileBinning,
    tiles_y: int,
    tiles_x: int,
    tile: int = TILE,
    max_blocks: int = 0,
) -> Dict[str, torch.Tensor]:
    """The "blend" backend: same inputs and output dict as
    `blend_plain.blend_tiles`, differentiable through `BlendPacked`."""
    attrs = blend_plain.pack_gaussian_attrs(pre)
    tile_out, observe = BlendPacked.apply(attrs, binning, tiles_y, tiles_x, tile, max_blocks)
    planes = blend_plain.tiles_to_planes(tile_out, tiles_y, tiles_x, tile)
    planes["out_observe"] = observe
    return planes
