# Frozen copy of hidegs_tpu_torch/raster/blend_plain.py:1-561 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Segmented instance-parallel tile blend in plain PyTorch.

Port of hidegs_tpu/raster/blend_jnp.py: the exact closed form of the
reference's per-tile front-to-back loop over the (tile, depth)-sorted
instance list,

    T_excl_i = exp( Σ_{j<i, same tile} log(1-α_j) )
    w_i      = T_excl_i · α_i · [T_incl_i ≥ 1e-4]
    out[tile] = Σ_{i in tile} w_i · channels_i

It is the CPU path of the "blend" backend, the "plain" backend, and the
version the CUDA kernels (raster/cuda_blend.py) are held against. Its memory is
O(instances · tile pixels), so it walks the stream in groups of whole tiles
of at most GROUP_INSTANCES instances. The per-tile log-transmittance sums
run in float64 (one cumsum over the group minus each tile's head), so they
carry no cancellation error from the earlier tiles of the group.

`blend_tiles_bwd` is the backward of the same closed form (the
counterpart of hidegs_tpu/raster/pallas_vjp.py:_passB_kernel): per sorted
instance, the gradient of the tile planes with respect to its packed row.
`fold_rows` sums those rows per gaussian.

Also here: the packed per-gaussian row and the 16-channel per-tile plane
layout shared with the kernels, and the 128-instance block budget
(`max_blocks`) of the JAX Pallas path.

`bf16=True` is the bf16 attribute stream (RasterConfig.bf16_stream; JAX's
pallas_blend.expand_to_instances(bf16=True)): each instance's attributes
rounded to bfloat16, mean2d first re-based to the origin of the instance's
tile, and the pixels placed at tile-local centres; the arithmetic stays
float32, and the rounding's gradient is the identity. `bf16_rows` is the
kernels' input in that mode, `instance_attrs` what they read from it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from gsbench.reference.raster.binning import TILE, TileBinning
from gsbench.reference.raster.preprocess import PreprocessedGaussians

T_EPS = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
# Per-tile output planes (T, P, OUT_CH): [0:3] rgb [3] invdepth [4:7] normal
# [7] distance [8] acc_alpha [9] T_final [10:16] pad.
OUT_CH = 16
# Packed per-gaussian row (N, ATTR), the kernels' input and the layout of the
# gradient rows: [0:2] mean2d [2:5] conic [5] opacity [6:9] rgb [9] invdepth
# [10:13] normal [13] distance [14:16] pad.
ATTR = 16
GRAD_COLS = 14  # columns of a gradient row that carry values
# Instances per budget block: `max_blocks` counts 128-instance blocks, each
# tile's span padded to a multiple of CHUNK, as in the JAX Pallas path.
CHUNK = 128
# Instances per tile group of the plain blend: its (instances, tile pixels)
# intermediates stay at 16 Mi elements at tile 32.
GROUP_INSTANCES = 1 << 14


def needed_blocks(tile_count: torch.Tensor) -> torch.Tensor:
    """Blocks the binning needs (for block_overflow / re-budgeting)."""
    return torch.sum(torch.div(tile_count + CHUNK - 1, CHUNK, rounding_mode="floor")).to(torch.int32)


def visited_tiles(tile_count: torch.Tensor, num_instances: int, max_blocks: int) -> torch.Tensor:
    """(T,) bool: a tile is blended iff its CHUNK-aligned first block lies
    inside the block budget; 0 = the worst case (every tile visited)."""
    T = tile_count.shape[0]
    worst = (num_instances + T * CHUNK) // CHUNK
    num_blocks = min(max_blocks, worst) if max_blocks else worst
    padded = torch.div(tile_count + CHUNK - 1, CHUNK, rounding_mode="floor") * CHUNK
    astart = torch.cumsum(padded, 0) - padded
    return torch.div(astart, CHUNK, rounding_mode="floor") < num_blocks


def finalize_tile_planes(tile_out: torch.Tensor, tile_count: torch.Tensor, visited=None):
    """Reset empty tiles, and tiles beyond the block budget, to the
    background defaults (everything 0, T_final 1)."""
    col = torch.arange(OUT_CH, device=tile_out.device)
    default = (col == 9).to(torch.float32)
    empty = tile_count == 0
    if visited is not None:
        empty = empty | ~visited
    return torch.where(empty[:, None, None], default[None, None, :], tile_out)


def tiles_to_planes(tile_out: torch.Tensor, tiles_y: int, tiles_x: int, tile: int):
    """(T, P, OUT_CH) → dict of image planes on the padded canvas."""
    img = (
        tile_out.reshape(tiles_y, tiles_x, tile, tile, OUT_CH)
        .permute(4, 0, 2, 1, 3)
        .reshape(OUT_CH, tiles_y * tile, tiles_x * tile)
    )
    return {
        "render": img[0:3],
        "invdepth": img[3],
        "normal": img[4:7],
        "distance": img[7],
        "alpha": img[8],
        "T_final": img[9],
    }


def _tile_groups(binning: TileBinning, count: torch.Tensor):
    """Consecutive tile ranges [t0, t1) with at most GROUP_INSTANCES
    instances each (a larger tile forms a group of its own). Yields (t0, t1,
    gid, tid, head, s0): the group's gaussian and absolute tile ids, the
    group-local index of each instance's tile head, and the sorted position
    of the group's first instance."""
    counts = count.tolist()
    starts = binning.tile_start.tolist()
    t, T = 0, len(counts)
    while t < T:
        t1, n = t + 1, counts[t]
        while t1 < T and n + counts[t1] <= GROUP_INSTANCES:
            n += counts[t1]
            t1 += 1
        if n > 0:
            s0 = starts[t]
            tid = binning.tile_id[s0:s0 + n].long()
            yield t, t1, binning.gauss_id[s0:s0 + n].long(), tid, binning.tile_start[tid].long() - s0, s0
        t = t1


def visited_and_count(binning: TileBinning, max_blocks: int):
    """(T,) visited mask and (T,) int32 span lengths with the unvisited
    tiles' set to 0."""
    visited = visited_tiles(binning.tile_count, binning.gauss_id.shape[0], max_blocks)
    return visited, torch.where(visited, binning.tile_count, torch.zeros_like(binning.tile_count))


class GroupAlpha(NamedTuple):
    """Per-(instance, pixel) quantities of one tile group, each (n, P)."""

    dx: torch.Tensor
    dy: torch.Tensor
    power: torch.Tensor
    alpha_raw: torch.Tensor  # op·exp(min(power, 0)), before the 0.99 clamp
    alpha: torch.Tensor  # clamped, zero where not kept
    keep: torch.Tensor
    lt64: torch.Tensor  # log(1-α) in float64
    T_excl: torch.Tensor
    T_incl: torch.Tensor


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even, as XLA's convert), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_attrs(pre) -> PackedGaussians:
    """The blend's fields of `pre` as the bf16 stream carries them: every
    channel but mean2d rounded to bfloat16 (mean2d is rounded per instance,
    after `_instance_mean` re-bases it to its tile)."""
    return PackedGaussians(pre.mean2d, round_bf16(pre.conic), round_bf16(pre.opacity), round_bf16(pre.rgb),
                           round_bf16(pre.inv_depth), round_bf16(pre.normal), round_bf16(pre.distance))


def _instance_mean(pre, gid, tid, tiles_x: int, tile: int, rel: bool):
    """Each instance's mean2d and the pixel origin of its tile, (n, 2) and
    (n,), (n,). With `rel` (the bf16 stream) the mean is re-based to the
    tile origin and rounded to bfloat16, and the origin is 0: the pixels sit
    at tile-local centres."""
    ox = ((tid % tiles_x) * tile).to(torch.float32)
    oy = (torch.div(tid, tiles_x, rounding_mode="floor") * tile).to(torch.float32)
    mean2d = pre.mean2d[gid]
    if rel:
        mean2d = round_bf16(mean2d - torch.stack([ox, oy], dim=1))
        ox = oy = torch.zeros_like(ox)
    return mean2d, ox, oy


def _group_alpha(pre, gid, tid, head, tiles_x: int, tile: int, rel: bool = False) -> GroupAlpha:
    """α of each instance at each pixel of its tile, its keep mask,
    log(1-α) in float64, and the transmittance before and after it."""
    P = tile * tile
    dev = gid.device
    lin = torch.arange(P, device=dev)
    lx = (lin % tile).to(torch.float32) + 0.5
    ly = torch.div(lin, tile, rounding_mode="floor").to(torch.float32) + 0.5
    mean2d, ox, oy = _instance_mean(pre, gid, tid, tiles_x, tile, rel)
    px = lx[None, :] + ox[:, None]
    py = ly[None, :] + oy[:, None]

    conic = pre.conic[gid]
    opacity = pre.opacity[gid]
    dx = px - mean2d[:, 0:1]
    dy = py - mean2d[:, 1:2]
    power = (
        -0.5 * (conic[:, 0:1] * dx * dx + conic[:, 2:3] * dy * dy)
        - conic[:, 1:2] * dx * dy
    )
    alpha_raw = opacity[:, None] * torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))

    log_t = torch.log1p(-alpha)
    lt64 = log_t.to(torch.float64)
    cs = torch.cumsum(lt64, 0)
    cs_excl = cs - lt64
    base = cs_excl[head]
    T_excl = torch.exp((cs_excl - base).to(torch.float32))
    T_incl = torch.exp((cs - base).to(torch.float32))
    return GroupAlpha(dx, dy, power, alpha_raw, alpha, keep, lt64, T_excl, T_incl)


def _blend_group(pre, gid, tid, head, tiles_x: int, tile: int, n_tiles: int, t0: int, rel: bool = False):
    """Blend one group's instances. Returns ((n_tiles, P, OUT_CH) planes,
    (n,) int32 observe counts)."""
    dev = gid.device
    P = tile * tile
    ga = _group_alpha(pre, gid, tid, head, tiles_x, tile, rel)
    alpha, lt64, T_excl = ga.alpha, ga.lt64, ga.T_excl
    w = T_excl * alpha * (ga.T_incl >= T_EPS)

    local = tid - t0
    chans = [
        pre.rgb[gid, 0], pre.rgb[gid, 1], pre.rgb[gid, 2], pre.inv_depth[gid],
        pre.normal[gid, 0], pre.normal[gid, 1], pre.normal[gid, 2], pre.distance[gid],
    ]
    planes = [
        torch.zeros((n_tiles, P), dtype=torch.float32, device=dev).index_add_(0, local, w * ch[:, None])
        for ch in chans
    ]
    planes.append(torch.zeros((n_tiles, P), dtype=torch.float32, device=dev).index_add_(0, local, w))
    total_log = torch.zeros((n_tiles, P), dtype=torch.float64, device=dev).index_add_(0, local, lt64)
    planes.append(torch.exp(total_log.to(torch.float32)))
    pad = torch.zeros((n_tiles, P, OUT_CH - len(planes)), dtype=torch.float32, device=dev)
    out = torch.cat([torch.stack(planes, dim=-1), pad], dim=-1)

    # observability counter (the reference's forward.cu:579-582): pixels the
    # instance contributed to while the pixel was still fresh (T > 0.5)
    observe = torch.sum((w > 0) & (T_excl > 0.5), dim=1).to(torch.int32)
    return out, observe


def blend_tile_out(
    pre,
    binning: TileBinning,
    tiles_y: int,
    tiles_x: int,
    tile: int = TILE,
    max_blocks: int = 0,
    bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (T, P, OUT_CH) tile planes, with empty and unvisited tiles at
    the background defaults, and the (N,) int32 per-gaussian observe
    counts. `pre` is a PreprocessedGaussians or the `unpack_attrs` view of
    a packed matrix; `bf16` blends the bf16 stream."""
    if bf16:
        pre = bf16_attrs(pre)
    N = pre.mean2d.shape[0]
    T = tiles_y * tiles_x
    P = tile * tile
    dev = pre.mean2d.device
    visited, count = visited_and_count(binning, max_blocks)
    tile_out = torch.zeros((T, P, OUT_CH), dtype=torch.float32, device=dev)
    observe = torch.zeros((N,), dtype=torch.int32, device=dev)
    for t0, t1, gid, tid, head, _ in _tile_groups(binning, count):
        out, obs = _blend_group(pre, gid, tid, head, tiles_x, tile, t1 - t0, t0, bf16)
        tile_out[t0:t1] = out
        observe.index_add_(0, gid, obs)
    return finalize_tile_planes(tile_out, count, visited), observe


def blend_tiles(
    pre: PreprocessedGaussians,
    binning: TileBinning,
    tiles_y: int,
    tiles_x: int,
    tile: int = TILE,
    max_blocks: int = 0,
    bf16: bool = False,
) -> Dict[str, torch.Tensor]:
    """Blend all channels. Returns the planes of `tiles_to_planes` on the
    padded canvas (callers crop to (H, W)) and the (N,) int32 `out_observe`.

    `max_blocks` > 0 leaves tiles past the 128-instance block budget at the
    background defaults; `bf16` blends the bf16 stream.
    """
    tile_out, observe = blend_tile_out(pre, binning, tiles_y, tiles_x, tile, max_blocks, bf16)
    planes = tiles_to_planes(tile_out, tiles_y, tiles_x, tile)
    planes["out_observe"] = observe
    return planes


class PackedGaussians(NamedTuple):
    """Column views of a packed (N, ATTR) matrix, named as the fields of
    PreprocessedGaussians that the blend reads."""

    mean2d: torch.Tensor
    conic: torch.Tensor
    opacity: torch.Tensor
    rgb: torch.Tensor
    inv_depth: torch.Tensor
    normal: torch.Tensor
    distance: torch.Tensor


def pack_gaussian_attrs(pre: PreprocessedGaussians) -> torch.Tensor:
    """(N, ATTR) float32 rows in the kernels' layout (see ATTR)."""
    N = pre.mean2d.shape[0]
    pad = torch.zeros((N, ATTR - GRAD_COLS), dtype=torch.float32, device=pre.mean2d.device)
    return torch.cat(
        [pre.mean2d, pre.conic, pre.opacity[:, None], pre.rgb, pre.inv_depth[:, None],
         pre.normal, pre.distance[:, None], pad],
        dim=1,
    ).to(torch.float32).contiguous()


def unpack_attrs(attrs: torch.Tensor) -> PackedGaussians:
    return PackedGaussians(attrs[:, 0:2], attrs[:, 2:5], attrs[:, 5], attrs[:, 6:9],
                           attrs[:, 9], attrs[:, 10:13], attrs[:, 13])


def bf16_rows(attrs: torch.Tensor) -> torch.Tensor:
    """(N, ATTR) float32 packed rows → the kernels' (N, 16) bfloat16 rows of
    the bf16 stream (csrc/blend_common.cuh): columns 0:4 hold the float32
    mean2d's bytes, columns 4:16 the other 12 channels rounded to bfloat16."""
    mean = attrs[:, 0:2].contiguous().view(torch.bfloat16)
    return torch.cat([mean, attrs[:, 2:GRAD_COLS].to(torch.bfloat16)], dim=1).contiguous()


def instance_attrs(rows: torch.Tensor, binning: TileBinning, tiles_x: int, tile: int) -> torch.Tensor:
    """What the kernels read for each sorted instance from `bf16_rows`:
    (I, ATTR) float32 in the packed layout, mean2d re-based to the
    instance's tile and rounded to bfloat16, every other channel widened
    (csrc/blend_common.cuh: load_row). Instances past the total (gauss_id N)
    read a zero row in the last tile, as JAX's stream does."""
    ext = torch.cat([rows, torch.zeros((1, rows.shape[1]), dtype=rows.dtype, device=rows.device)])
    g = binning.gauss_id.long()
    mean = ext[:, 0:4].contiguous().view(torch.float32)[g]
    tid = binning.tile_id.clamp(max=binning.tile_start.shape[0] - 1)
    ox = ((tid % tiles_x) * tile).to(torch.float32)
    oy = (torch.div(tid, tiles_x, rounding_mode="floor") * tile).to(torch.float32)
    rel = round_bf16(mean - torch.stack([ox, oy], dim=1))
    pad = torch.zeros((g.shape[0], ATTR - GRAD_COLS), dtype=torch.float32, device=rows.device)
    return torch.cat([rel, ext[g, 4:].to(torch.float32), pad], dim=1)


def augment_cotangents(tile_out: torch.Tensor, g_tiles: torch.Tensor) -> torch.Tensor:
    """(T, P, OUT_CH) cotangents of the tile planes → the backward's input:
    ch10 = G_total = Σ_ch out·g over every channel but T_final (ch9), ch11 =
    T_final·g_T (hidegs_tpu/raster/pallas_vjp.py:430-439)."""
    col = torch.arange(OUT_CH, device=g_tiles.device)
    g_ch = torch.where(col == 9, torch.zeros_like(g_tiles), g_tiles)
    G_total = torch.sum(tile_out * g_ch, dim=-1, keepdim=True)
    S_base = tile_out[..., 9:10] * g_tiles[..., 9:10]
    return torch.cat([g_tiles[..., :10], G_total, S_base, g_tiles[..., 12:]], dim=-1).contiguous()


def blend_tiles_bwd(
    pre,
    binning: TileBinning,
    g_aug: torch.Tensor,
    tiles_y: int,
    tiles_x: int,
    tile: int = TILE,
    max_blocks: int = 0,
    bf16: bool = False,
) -> torch.Tensor:
    """Gradient rows of the blend, one per sorted instance: (I, ATTR) in the
    packed layout, zero for instances outside the visited spans; `bf16`
    differentiates the blend of the bf16 stream.

    The closed form of hidegs_tpu/raster/pallas_vjp.py:9-20 and :102-171,
    front to back, with `g_aug` from `augment_cotangents`:

        chg    = Σ_ch g_ch·channels_ch        (rgb, invdepth, normal, distance, 1)
        S      = G_total − Σ_{j ≤ i} w_j·chg_j + T_final·g_T
        dα     = T_excl·[T_incl ≥ 1e-4]·chg − S/(1−α)
        dpower = dα·α where kept and α_raw < 0.99

    then d_mean2d, d_conic and d_opacity from dpower, and the channel
    gradients Σ_p g_ch·w. A pixel stops contributing once T_excl < 1e-4, as
    in the forward kernel. The `[T_incl ≥ 1e-4]` factor is the derivative of
    w; the Pallas kernel leaves it out (ROADMAP C3). Prefix sums run in
    float64 per tile group, as the forward's transmittance does."""
    if bf16:
        pre = bf16_attrs(pre)
    I = binning.gauss_id.shape[0]
    dev = g_aug.device
    rows = torch.zeros((I, ATTR), dtype=torch.float32, device=dev)
    _, count = visited_and_count(binning, max_blocks)
    for _, _, gid, tid, head, s0 in _tile_groups(binning, count):
        ga = _group_alpha(pre, gid, tid, head, tiles_x, tile, bf16)
        mask = (ga.T_incl >= T_EPS).to(torch.float32)
        w = ga.T_excl * ga.alpha * mask
        g = [g_aug[:, :, c][tid] for c in range(12)]
        chans = [
            pre.rgb[gid, 0], pre.rgb[gid, 1], pre.rgb[gid, 2], pre.inv_depth[gid],
            pre.normal[gid, 0], pre.normal[gid, 1], pre.normal[gid, 2], pre.distance[gid],
        ]
        chg = g[0] * chans[0][:, None]
        for c in range(1, 8):
            chg = chg + g[c] * chans[c][:, None]
        chg = chg + g[8]
        contrib = (w * chg).to(torch.float64)
        cs = torch.cumsum(contrib, 0)
        prefix = (cs - (cs - contrib)[head]).to(torch.float32)
        S = (g[10] - prefix) + g[11]
        d_alpha = ga.T_excl * mask * chg - S / (1.0 - ga.alpha)
        live = ga.keep & (ga.alpha_raw < ALPHA_MAX) & (ga.T_excl >= T_EPS)
        zero = torch.zeros_like(d_alpha)
        d_power = torch.where(live, d_alpha * ga.alpha, zero)
        d_op = torch.where(live, d_alpha * torch.exp(torch.clamp(ga.power, max=0.0)), zero)
        conic = pre.conic[gid]
        ca, cb, cc = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
        dx, dy = ga.dx, ga.dy
        cols = [
            d_power * (ca * dx + cb * dy),
            d_power * (cc * dy + cb * dx),
            -0.5 * dx * dx * d_power,
            -(dx * dy) * d_power,
            -0.5 * dy * dy * d_power,
            d_op,
        ] + [g[c] * w for c in range(8)]
        rows[s0:s0 + gid.shape[0], :GRAD_COLS] = torch.stack([x.sum(dim=1) for x in cols], dim=1)
    return rows


def expansion_rows(rows: torch.Tensor, slot_s: torch.Tensor) -> torch.Tensor:
    """Sorted-instance rows → expansion order, where each gaussian's
    instances are contiguous. `slot_s` is a permutation, so every
    destination is written once."""
    out = torch.empty_like(rows)
    out[slot_s.long()] = rows
    return out


def fold_rows(rows_exp: torch.Tensor, g_start: torch.Tensor) -> torch.Tensor:
    """(I, ATTR) expansion-order rows → (N, ATTR) per-gaussian sums: row g
    sums the span [g_start[g], g_start[g+1]) in slot order (the rows past
    g_start[N] drop). The plain version of the fold kernel, in the rows'
    dtype."""
    bounds = torch.cat([g_start.long(), torch.full((1,), rows_exp.shape[0], device=g_start.device)])
    return torch.segment_reduce(rows_exp, "sum", lengths=torch.diff(bounds))[:-1]


def pair_counts(
    pre: PreprocessedGaussians,
    binning: TileBinning,
    tiles_x: int,
    tile: int = TILE,
    max_blocks: int = 0,
    bf16: bool = False,
) -> Tuple[int, int, int]:
    """The (pixel, instance) pairs of a blend of this binning, for a
    kernel's lower bound: `live` pairs (instances reached before their
    tile went opaque, times the tile's pixels); of those, `kept` pairs
    with α ≥ 1/255; and of those, the `open` pairs whose pixel still had
    T ≥ 1e-4 before the instance, the pairs whose α a blend must use."""
    if bf16:
        pre = bf16_attrs(pre)
    dev = pre.mean2d.device
    live = torch.zeros((), dtype=torch.int64, device=dev)
    kept = torch.zeros((), dtype=torch.int64, device=dev)
    open_ = torch.zeros((), dtype=torch.int64, device=dev)
    _, count = visited_and_count(binning, max_blocks)
    for _, _, gid, tid, head, _ in _tile_groups(binning, count):
        ga = _group_alpha(pre, gid, tid, head, tiles_x, tile, bf16)
        reached = torch.any(ga.T_excl >= T_EPS, dim=1)
        live += reached.sum() * (tile * tile)
        kept += (ga.keep & reached[:, None]).sum()
        open_ += (ga.keep & (ga.T_excl >= T_EPS)).sum()
    return int(live), int(kept), int(open_)


# The kernels' warp-block mask (csrc/blend_common.cuh). A tile's pixels fall
# into 8x4 blocks, one pixel per lane of a warp; bit b of an instance's mask
# says whether its α ≥ 1/255 level set can reach block b. The test is the
# binning's exact cull (binning._tile_min_quadratic) on the box of the
# block's pixel centres, q_min ≤ ln(op·255) + MASK_MARGIN, widened by
# MASK_REL_MARGIN x the size of the quadratic's terms over the box: the box
# minimum rounds in another order than the kernels' `power`, and with a
# thin, near-singular conic those terms are large and cancel.
BLOCK_W, BLOCK_H = 8, 4
MASK_MARGIN = 1e-3
MASK_REL_MARGIN = 1e-6


def block_origins(tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-local pixel offsets (x0, y0) of each 8x4 block, in bit order. At
    tile 16 warp w owns block w; at tile 32 warp w owns blocks 4w..4w+3, a
    16x8 region."""
    b = torch.arange(tile * tile // (BLOCK_W * BLOCK_H))
    if tile == 16:
        return (b % 2) * 8, torch.div(b, 2, rounding_mode="floor") * 4
    w, k = torch.div(b, 4, rounding_mode="floor"), b % 4
    return ((w % 2) * 16 + (k % 2) * 8,
            torch.div(w, 2, rounding_mode="floor") * 8 + torch.div(k, 2, rounding_mode="floor") * 4)


def block_keep(pre, gid, tid, tiles_x: int, tile: int, rel: bool = False) -> torch.Tensor:
    """(n, blocks) bool: the mask predicate for instances (gid, tid), op for
    op as the kernels compute it in float32 (`rel`: of the bf16 stream,
    with `pre` from bf16_attrs)."""
    dev = gid.device
    x0, y0 = (o.to(dev) for o in block_origins(tile))
    mean2d, ox, oy = _instance_mean(pre, gid, tid, tiles_x, tile, rel)
    px_lo = (x0[None, :].to(torch.float32) + 0.5) + ox[:, None]
    py_lo = (y0[None, :].to(torch.float32) + 0.5) + oy[:, None]
    u, v = mean2d[:, 0:1], mean2d[:, 1:2]
    ca, cb, cc = pre.conic[gid, 0:1], pre.conic[gid, 1:2], pre.conic[gid, 2:3]
    lo_x, hi_x = px_lo - u, (px_lo + (BLOCK_W - 1)) - u
    lo_y, hi_y = py_lo - v, (py_lo + (BLOCK_H - 1)) - v

    def edge_x(ex):  # dx = ex, dy free in [lo_y, hi_y]
        dy = torch.minimum(torch.maximum(-cb * ex / torch.clamp(cc, min=1e-12), lo_y), hi_y)
        return 0.5 * (ca * ex * ex + cc * dy * dy) + cb * ex * dy

    def edge_y(ey):  # dy = ey, dx free in [lo_x, hi_x]
        dx = torch.minimum(torch.maximum(-cb * ey / torch.clamp(ca, min=1e-12), lo_x), hi_x)
        return 0.5 * (ca * dx * dx + cc * ey * ey) + cb * dx * ey

    q_min = torch.minimum(torch.minimum(edge_x(lo_x), edge_x(hi_x)), torch.minimum(edge_y(lo_y), edge_y(hi_y)))
    inside = (lo_x <= 0) & (hi_x >= 0) & (lo_y <= 0) & (hi_y >= 0)
    q_min = torch.where(inside, torch.zeros_like(q_min), q_min)
    mx = torch.maximum(lo_x.abs(), hi_x.abs())
    my = torch.maximum(lo_y.abs(), hi_y.abs())
    size = 0.5 * (ca.abs() * mx * mx + cc.abs() * my * my) + cb.abs() * mx * my
    budget = (torch.log(torch.clamp(pre.opacity[gid], min=1e-12) * 255.0)[:, None] + MASK_MARGIN
              + MASK_REL_MARGIN * size)
    return ~(q_min > budget)  # NaN keeps the block


def block_masks(pre, binning: TileBinning, tiles_x: int, tile: int, count: torch.Tensor,
                bf16: bool = False) -> torch.Tensor:
    """(I,) int64 per sorted instance: bit b set iff the instance's α ≥
    1/255 level set can reach 8x4 block b of its tile (`block_origins`);
    0 outside the visited spans. `count` is `cuda_blend.visited_count`.
    For tests and counting: the kernels compute the same masks themselves."""
    if bf16:
        pre = bf16_attrs(pre)
    masks = torch.zeros((binning.gauss_id.shape[0],), dtype=torch.int64, device=binning.gauss_id.device)
    for _, _, gid, tid, _, s0 in _tile_groups(binning, count):
        keep = block_keep(pre, gid, tid, tiles_x, tile, bf16).to(torch.int64)
        bits = torch.ones((keep.shape[1],), dtype=torch.int64, device=keep.device) << torch.arange(
            keep.shape[1], device=keep.device)
        masks[s0:s0 + gid.shape[0]] = (keep * bits).sum(dim=1)
    return masks


def block_pair_counts(pre, binning: TileBinning, tiles_x: int, tile: int, count: torch.Tensor,
                      bf16: bool = False) -> int:
    """The (pixel, instance) pairs the kernels evaluate: for every instance
    reached before its tile went opaque (as in `pair_counts`), the pixels of
    the blocks its mask keeps. Warps whose pixels are all done skip further
    instances, so the kernels evaluate at most this many."""
    if bf16:
        pre = bf16_attrs(pre)
    total = 0
    for _, _, gid, tid, head, _ in _tile_groups(binning, count):
        ga = _group_alpha(pre, gid, tid, head, tiles_x, tile, bf16)
        reached = torch.any(ga.T_excl >= T_EPS, dim=1)
        keep = block_keep(pre, gid, tid, tiles_x, tile, bf16)
        total += int((keep & reached[:, None]).sum()) * BLOCK_W * BLOCK_H
    return total
