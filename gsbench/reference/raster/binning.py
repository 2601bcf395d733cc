# Frozen copy of hidegs_tpu_torch/raster/binning.py:1-195 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Tile binning: gaussian → (tile, depth)-sorted instance lists.

Port of hidegs_tpu/raster/binning.py. Every gaussian expands into one
instance per tile of its (tight, opacity-aware) rectangle inside a fixed
`max_instances` buffer; instances whose splat stays below the blend's 1/255
cutoff over their whole tile are culled; the rest are sorted by (tile,
depth) with ties kept in expansion order. Overflow past the budget is
dropped deterministically and reported. The output arrays equal the JAX
package's exactly, given the same preprocessed inputs.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from gsbench.reference.raster.preprocess import PreprocessedGaussians

TILE = 16  # pixels per tile side (the reference's BLOCK_X/BLOCK_Y)
ALPHA_MIN = 1.0 / 255.0  # blend contribution cutoff


@dataclass
class TileBinning:
    gauss_id: torch.Tensor  # (I,) int32 instance → gaussian index (N = invalid)
    tile_id: torch.Tensor  # (I,) int32 instance → tile (num_tiles = invalid)
    tile_start: torch.Tensor  # (num_tiles,) int32 start offset into instance list
    tile_count: torch.Tensor  # (num_tiles,) int32 instances per tile
    num_instances: torch.Tensor  # () int32 total wanted instances (pre-truncation)
    overflow: torch.Tensor  # () int32 instances dropped by the static budget
    slot_s: torch.Tensor  # (I,) int32 sorted position → expansion slot
    owner: torch.Tensor  # (I,) int32 expansion slot → gaussian (N past the total)
    g_start: torch.Tensor  # (N+1,) int32 first expansion slot per gaussian, clamped


def tile_grid(height: int, width: int, tile: int = TILE):
    return ((height + tile - 1) // tile, (width + tile - 1) // tile)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """float → int32 by truncation toward zero (XLA's convert semantics)."""
    return x.to(torch.int32)


def compute_tight_rects(mean2d, conic, opacity, radius, tiles_y: int, tiles_x: int, tile: int = TILE):
    """Per-axis, opacity-aware tile rectangle: the axis-aligned extent of the
    level set q ≤ ln(op·255) (beyond it α < 1/255 and every blend path drops
    the contribution), never wider than the reference's radius circle."""
    ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
    det = torch.clamp(ca * cc - cb * cb, min=1e-12)
    # +1e-3 slack mirrors the exact cull's roundoff margin
    B = torch.log(torch.clamp(opacity, min=1e-12) * (1.0 / ALPHA_MIN)) + 1e-3
    live = (radius > 0) & (B > 0)
    B = torch.clamp(B, min=0.0)
    rx = torch.sqrt(2.0 * B * cc / det)
    ry = torch.sqrt(2.0 * B * ca / det)
    r = radius.to(torch.float32)
    rx = torch.minimum(rx, r)
    ry = torch.minimum(ry, r)
    x0 = torch.clamp(_i32((mean2d[:, 0] - rx) / tile), 0, tiles_x)
    y0 = torch.clamp(_i32((mean2d[:, 1] - ry) / tile), 0, tiles_y)
    x1 = torch.clamp(_i32(torch.ceil((mean2d[:, 0] + rx) / tile)), 0, tiles_x)
    y1 = torch.clamp(_i32(torch.ceil((mean2d[:, 1] + ry) / tile)), 0, tiles_y)
    zero = torch.zeros_like(x0)
    x0 = torch.where(live, x0, zero)
    y0 = torch.where(live, y0, zero)
    x1 = torch.where(live, torch.maximum(x1, x0), zero)
    y1 = torch.where(live, torch.maximum(y1, y0), zero)
    return x0, y0, x1, y1


def _tile_min_quadratic(lo_x, hi_x, lo_y, hi_y, ca, cb, cc):
    """Exact min of q(d) = ½(ca·dx² + cc·dy²) + cb·dx·dy over the box
    [lo_x,hi_x]×[lo_y,hi_y]: 0 when the splat center lies inside, else the
    least of the four edge minima (closed form along the free axis)."""

    def edge_x(ex):  # edge at dx = ex, dy free in [lo_y, hi_y]
        dy = torch.minimum(torch.maximum(-cb * ex / torch.clamp(cc, min=1e-12), lo_y), hi_y)
        return 0.5 * (ca * ex * ex + cc * dy * dy) + cb * ex * dy

    def edge_y(ey):  # edge at dy = ey, dx free in [lo_x, hi_x]
        dx = torch.minimum(torch.maximum(-cb * ey / torch.clamp(ca, min=1e-12), lo_x), hi_x)
        return 0.5 * (ca * dx * dx + cc * ey * ey) + cb * dx * ey

    q_edge = torch.minimum(
        torch.minimum(edge_x(lo_x), edge_x(hi_x)),
        torch.minimum(edge_y(lo_y), edge_y(hi_y)),
    )
    inside = (lo_x <= 0) & (0 <= hi_x) & (lo_y <= 0) & (0 <= hi_y)
    return torch.where(inside, torch.zeros_like(q_edge), q_edge)


def _stable_sort_perm(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def bin_gaussians(
    pre: PreprocessedGaussians,
    tiles_y: int,
    tiles_x: int,
    max_instances: int,
    tile: int = TILE,
    depth_bits: int = 0,
) -> TileBinning:
    """Expand, cull and sort. `depth_bits`: 0 = exact lexicographic (tile,
    depth) sort; > 0 = one int32 key [tile | quantized depth]; -1 = the
    widest quantization that fits. Runs without a host sync."""
    N = pre.mean2d.shape[0]
    dev = pre.mean2d.device
    num_tiles = tiles_y * tiles_x
    if depth_bits < 0:
        depth_bits = max(31 - int(num_tiles + 1).bit_length(), 0)
    depth_bits = min(depth_bits, 23)
    x0, y0, x1, y1 = compute_tight_rects(
        pre.mean2d, pre.conic, pre.opacity, pre.radius, tiles_y, tiles_x, tile
    )
    w = x1 - x0
    h = y1 - y0
    touched = torch.where(pre.visible, w * h, torch.zeros_like(w))

    ends = torch.cumsum(touched, 0, dtype=torch.int32)  # inclusive
    starts = ends - touched  # exclusive
    total = ends[-1] if N > 0 else torch.zeros((), dtype=torch.int32, device=dev)

    # Expansion: slot j < total belongs to the one gaussian with
    # start ≤ j < start + touched, the first whose inclusive end passes j
    # (zero-touched gaussians own no slot). Slots past the total clamp to
    # row N - 1 and are masked below.
    slots = torch.arange(max_instances, dtype=torch.int32, device=dev)
    g = torch.clamp(torch.searchsorted(ends, slots, right=True, out_int32=True), max=max(N - 1, 0))
    gl = g.long()
    valid = slots < total

    g_start = starts[gl]
    local = slots - g_start
    gw = torch.clamp(w, min=1)[gl]
    tx = x0[gl] + local % gw
    ty = y0[gl] + torch.div(local, gw, rounding_mode="floor")

    # exact tile-intersection cull: bound the pixel-center max of α by its
    # continuous max over the tile box; keep iff op·exp(−q_min) ≥ 1/255
    u, v = pre.mean2d[gl, 0], pre.mean2d[gl, 1]
    ca, cb, cc = pre.conic[gl, 0], pre.conic[gl, 1], pre.conic[gl, 2]
    op = pre.opacity[gl]
    lo_x = tx.to(torch.float32) * tile + 0.5 - u
    lo_y = ty.to(torch.float32) * tile + 0.5 - v
    hi_x = lo_x + (tile - 1)
    hi_y = lo_y + (tile - 1)
    q_min = _tile_min_quadratic(lo_x, hi_x, lo_y, hi_y, ca, cb, cc)
    q_budget = torch.log(torch.clamp(op, min=1e-12) / ALPHA_MIN)
    valid = valid & (q_min <= q_budget + 1e-3)

    tid = ty * tiles_x + tx
    tid = torch.where(valid, tid, num_tiles)
    gid = torch.where(valid, g, N)
    owner = torch.where(slots < total, g, N).to(torch.int32)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    depth = torch.where(valid, pre.depth[gl], inf)

    if depth_bits:
        # single-key sort: [tile | quantized depth] in an int32
        assert (num_tiles + 1) << depth_bits <= (1 << 31), "key overflow"
        dmin = torch.min(torch.where(valid, depth, inf))
        dmax = torch.max(torch.where(valid, depth, -inf))
        dq_max = (1 << depth_bits) - 1
        # torch.div: `int / tensor` would round twice (reciprocal, multiply)
        scale = torch.div(dq_max, torch.clamp(dmax - dmin, min=1e-12))
        dq = _i32(torch.clamp((depth - dmin) * scale, 0, dq_max))
        dq = torch.where(valid, dq, dq_max)
        key = (tid << depth_bits) | dq
        perm = _stable_sort_perm(key)
        tid_s = key[perm] >> depth_bits
    else:
        # lexicographic (tile, depth), ties in slot order: a stable sort by
        # depth, then a stable sort by tile
        p1 = _stable_sort_perm(depth)
        p2 = _stable_sort_perm(tid[p1])
        perm = p1[p2]
        tid_s = tid[perm]

    tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    tile_start = torch.searchsorted(tid_s, tile_ids, side="left").to(torch.int32)
    tile_end = torch.searchsorted(tid_s, tile_ids, side="right").to(torch.int32)
    total32 = total.to(torch.int32).reshape(())
    return TileBinning(
        gauss_id=gid[perm].to(torch.int32),
        tile_id=tid_s.to(torch.int32),
        tile_start=tile_start,
        tile_count=tile_end - tile_start,
        num_instances=total32,
        overflow=torch.clamp(total32 - max_instances, min=0),
        slot_s=perm.to(torch.int32),
        owner=owner,
        g_start=torch.clamp(torch.cat([starts, total32.reshape(1)]), 0, max_instances).to(torch.int32),
    )
