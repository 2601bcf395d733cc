# Frozen copy of hidegs_tpu_torch/raster/blend_autograd.py:1-90 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""The differentiable tile blend of the "blend" backend.

Port of the `blend_packed` custom VJP (hidegs_tpu/raster/pallas_vjp.py:249-284,
381-457) as a `torch.autograd.Function`: per-gaussian packed rows
(`blend_plain.pack_gaussian_attrs`) and the binning in, the (T, P, 16) tile
planes and per-gaussian observe counts out.

  * forward: the CUDA kernel on CUDA tensors (raster/cuda_blend.py), the
    plain blend on CPU tensors; the tile planes are saved for the backward;
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

from gsbench.reference.raster import blend_plain
from gsbench.reference.raster.binning import TILE, TileBinning
from gsbench.reference.raster.preprocess import PreprocessedGaussians


class BlendPacked(torch.autograd.Function):
    """(N, 16) packed rows → ((T, P, 16) tile planes, (N,) int32 observe)."""

    @staticmethod
    def forward(ctx, attrs, binning: TileBinning, tiles_y: int, tiles_x: int, tile: int, max_blocks: int,
                bf16: bool = False):
        # frozen copy: the plain blend on every device (the kernels' branch removed)
        count = None
        rows = attrs
        tile_out, observe = blend_plain.blend_tile_out(
            blend_plain.unpack_attrs(attrs), binning, tiles_y, tiles_x, tile, max_blocks, bf16)
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
        # frozen copy: the plain backward and fold on every device
        grad_rows = blend_plain.blend_tiles_bwd(
            blend_plain.unpack_attrs(rows), binning, g_aug, tiles_y, tiles_x, tile, max_blocks, bf16)
        d_attrs = blend_plain.fold_rows(blend_plain.expansion_rows(grad_rows, binning.slot_s),
                                        binning.g_start)
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
