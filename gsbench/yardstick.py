"""The benchmark's yardstick: the H100's published peaks and the least time
a kernel or a train step could take on the work that its inputs need.

Frozen copies, at commit 63641d3, of chip_smoke.py:366-394 (the peaks and
the blends' operation counts), :630-657 (`blend_bound`), :871-881
(`pre_bound` and the preprocess operation counts) and the byte counts of
:846 (forward blend), :2179 (backward blend), :963 and :1073 (preprocess
forward and backward). Counts are taken from the reference's binning and
pair counts (gsbench/reference), never from the program's buffers.
"""
from __future__ import annotations

from typing import Dict

# H100 SXM (NVIDIA data sheet, 700 W): HBM3 bandwidth, FP32 outside the
# tensor cores (the port keeps TF32 off), the special-function units
# (16 results per clock per SM x 132 SMs x 1.98 GHz)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
SFU_OPS_S = 16 * 132 * 1.98e9
# forward blend, per (pixel, instance) pair whose alpha it tests and per
# pair whose alpha >= 1/255 it uses (counted from csrc/blend_fwd.cu)
OPS_PER_LIVE_PAIR = 16
OPS_PER_KEPT_PAIR = 23
SFU_PER_KEPT_PAIR = 2
# backward blend (csrc/blend_bwd.cu)
BWD_OPS_PER_LIVE_PAIR = 15
BWD_OPS_PER_KEPT_PAIR = 75
BWD_SFU_PER_KEPT_PAIR = 3
# one box test of an instance against an 8x4 pixel block
OPS_PER_BOX_TEST = 84
SFU_PER_BOXED_INSTANCE = 3
BLOCK_PIXELS = 8 * 4
# preprocess, per row (SH degree 3, render_geo), rounded up
OPS_PER_PRE_FWD_ROW = 450
OPS_PER_PRE_BWD_ROW = 1100
# float operations of one Adam update of one parameter element (moments,
# bias corrections, square root, division, the step and the visibility
# mask), and the parameter elements of a row: xyz 3, SH 48, scaling 3,
# rotation 4, opacity 1
ADAM_OPS_PER_ELEMENT = 12
ROW_ELEMENTS = 59


def blend_bound(bytes_moved: float, counts, tile: int, ops_live: int, ops_kept: int, sfu_kept: int) -> Dict:
    """The least ms of a blend kernel: the larger of its bytes over the
    memory rate and the operations these inputs need over the peak rates.
    `counts` is the reference's pair_counts (live, kept, open): per open
    pair the alpha test and its use, and one box test per (reached
    instance, 8x4 block)."""
    live, _kept, open_ = counts
    P = tile * tile
    reached = live // P
    boxes = reached * (P // BLOCK_PIXELS)
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    ops = open_ * (ops_live + ops_kept) + boxes * OPS_PER_BOX_TEST
    t_ops = ops / FP32_FLOP_S * 1e3
    t_sfu = (open_ * (1 + sfu_kept) + reached * SFU_PER_BOXED_INSTANCE) / SFU_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops, t_sfu), "ops": ops, "bytes": bytes_moved,
            "sfu": open_ * (1 + sfu_kept) + reached * SFU_PER_BOXED_INSTANCE}


def fwd_blend_bytes(post_cull: int, unique_rows: int, n_tiles: int, tile: int) -> int:
    """Instance ids, spans, the rows read once, the tile planes written,
    the observe counts."""
    P = tile * tile
    return post_cull * 4 + 2 * n_tiles * 4 + unique_rows * 64 + n_tiles * P * 64 + post_cull * 4


def bwd_blend_bytes(post_cull: int, unique_rows: int, n_tiles: int, tile: int, instances: int) -> int:
    """The rows, the cotangents, the spans, the gather ids, the expansion
    slots and the rows written."""
    P = tile * tile
    return post_cull * 4 + 2 * n_tiles * 4 + unique_rows * 64 + n_tiles * P * 48 + instances * 4 + instances * 64


def pre_fwd(rows: int, sh_coeffs: int = 16) -> Dict:
    return {"ops": rows * OPS_PER_PRE_FWD_ROW, "bytes": rows * (11 + 3 * sh_coeffs) * 4 + rows * 15 * 4 + rows * 5}


def pre_bwd(rows: int, sh_coeffs: int = 16, ct_floats: int = 15, out_floats: int = 11 + 48) -> Dict:
    width = 3 * sh_coeffs
    return {"ops": rows * OPS_PER_PRE_BWD_ROW,
            "bytes": rows * (11 + width) * 4 + rows + rows * ct_floats * 4 + rows * out_floats * 4}


def conv_ops(channels: int, height: int, width: int, taps: int) -> int:
    """Multiply-adds of a `taps`-tap filter over a (channels, H, W) image:
    two operations a tap a pixel."""
    return 2 * channels * height * width * taps


def loss_stack_ops(height: int, width: int) -> Dict:
    """The loss stack's convolutions, forward and backward (backward taken
    as twice the forward): SSIM's 11x11 Gaussian on the five moment maps of
    three channels, separable (22 taps); the frequency term's Sobel pair
    and Laplacian (3x3, 9 taps each) on both images at three pyramid
    levels (a level has a quarter of the pixels of the one before); the
    high-frequency mask's Sobel pair and Laplacian on the target; the
    single-view term's normal from depth (a 3x3 difference, 9 taps)."""
    px = height * width
    ssim = conv_ops(15, height, width, 22)
    levels = sum(px / 4 ** k for k in range(3))
    freq = 2 * 3 * 3 * 2 * 9 * levels  # images x filters x channels x (2 ops x 9 taps) x pixels
    mask = 3 * 3 * 2 * 9 * px
    normal = conv_ops(3, height, width, 9)
    fwd = ssim + freq + mask + normal
    # the maps read and written once forward, and again backward
    return {"ops": 3 * fwd, "bytes": 3 * (15 + 6 + 6 + 3) * px * 4}


def multi_view_ops(samples: int, patch_half: int) -> Dict:
    """The multi-view term's patches: per sample and patch pixel a
    homography (3x3 product, 15 ops), a bilinear read (4 taps, 12 ops) and
    the NCC sums (10 ops); backward twice the forward."""
    k = (2 * patch_half + 1) ** 2
    fwd = samples * k * (15 + 12 + 10)
    return {"ops": 3 * fwd, "bytes": 3 * samples * k * 4 * 4}


def adam(rows: int) -> Dict:
    """Masked Adam over the row budget: parameter, gradient and two moments
    read, parameter and moments written."""
    return {"ops": rows * ROW_ELEMENTS * ADAM_OPS_PER_ELEMENT, "bytes": rows * ROW_ELEMENTS * 7 * 4}


def bound_ms(work: Dict) -> float:
    return max(work["bytes"] / HBM_BYTES_S, work["ops"] / FP32_FLOP_S, work.get("sfu", 0) / SFU_OPS_S) * 1e3
