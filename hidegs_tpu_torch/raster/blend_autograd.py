"""The differentiable tile blend of the "blend" backend.

Port of the `blend_packed` custom VJP (hidegs_tpu/raster/pallas_vjp.py:249-284,
381-457) as a `torch.autograd.Function`: per-gaussian packed rows
(`blend_plain.pack_gaussian_attrs`) and the binning in, the (T, P, 16) tile
planes and per-gaussian observe counts out.

  * forward: the CUDA kernel on CUDA tensors (raster/cuda_blend.py), which
    sums the observe counts per gaussian itself with integer atomics, the
    plain blend on CPU tensors, which folds per-instance counts with an
    integer index_add_; both are deterministic and equal. The tile planes
    are saved for the backward;
  * backward: G_total = Σ_ch out·g (T_final masked) and T_final·g_T ride
    channels 10 and 11 of the cotangents, then one gradient row per
    instance, summed per gaussian in expansion order (each gaussian's
    instances are contiguous there). On CUDA the backward kernel stores
    each row at its expansion slot and the fold kernel sums them; on the
    CPU `blend_plain.blend_tiles_bwd` gives the rows in sorted order,
    `expansion_rows` places them and `fold_rows` sums them. No float
    atomics, so the gradient is bitwise reproducible.

`bf16=True` blends the bf16 attribute stream (RasterConfig.bf16_stream):
the kernels take `blend_plain.bf16_rows` of the packed rows, the plain
versions their `bf16=True` mode; the gradient with respect to the float32
rows is the same layout in both modes.

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
    def forward(ctx, attrs, binning: TileBinning, tiles_y: int, tiles_x: int, tile: int, max_blocks: int,
                bf16: bool = False):
        if attrs.device.type == "cpu":
            count = None
            rows = attrs
            tile_out, observe = blend_plain.blend_tile_out(
                blend_plain.unpack_attrs(attrs), binning, tiles_y, tiles_x, tile, max_blocks, bf16)
        else:
            count = cuda_blend.visited_count(binning, max_blocks)
            rows = blend_plain.bf16_rows(attrs) if bf16 else attrs
            tile_out, observe = cuda_blend.blend_tile_out(rows, binning, count, tiles_y, tiles_x, tile)
        ctx.save_for_backward(rows, tile_out)
        ctx.binning = binning
        ctx.count = count
        ctx.args = (tiles_y, tiles_x, tile, max_blocks, bf16)
        ctx.mark_non_differentiable(observe)
        return tile_out, observe

    @staticmethod
    def backward(ctx, g_tiles, _g_observe):
        rows, tile_out = ctx.saved_tensors
        binning = ctx.binning
        tiles_y, tiles_x, tile, max_blocks, bf16 = ctx.args
        g_aug = blend_plain.augment_cotangents(tile_out, g_tiles.contiguous())
        if rows.device.type == "cpu":
            grad_rows = blend_plain.blend_tiles_bwd(
                blend_plain.unpack_attrs(rows), binning, g_aug, tiles_y, tiles_x, tile, max_blocks, bf16)
            d_attrs = blend_plain.fold_rows(blend_plain.expansion_rows(grad_rows, binning.slot_s),
                                            binning.g_start)
        else:
            d_attrs = cuda_blend.grad_attrs(rows, binning, ctx.count, g_aug, tiles_x, tile)
        return d_attrs, None, None, None, None, None, None


def blend_tiles(
    pre: PreprocessedGaussians,
    binning: TileBinning,
    tiles_y: int,
    tiles_x: int,
    tile: int = TILE,
    max_blocks: int = 0,
    bf16: bool = False,
) -> Dict[str, torch.Tensor]:
    """The "blend" backend: same inputs and output dict as
    `blend_plain.blend_tiles`, differentiable through `BlendPacked`."""
    attrs = blend_plain.pack_gaussian_attrs(pre)
    tile_out, observe = BlendPacked.apply(attrs, binning, tiles_y, tiles_x, tile, max_blocks, bf16)
    planes = blend_plain.tiles_to_planes(tile_out, tiles_y, tiles_x, tile)
    planes["out_observe"] = observe
    return planes
