"""The post-opt step's counted work, beside gsbench/yardstick.py: what a
step of `hidegs_tpu_torch.train.hier_trainer` must move and compute, from
the cut and the reference's preprocess and binning, never from the
program's buffers.

The counts are the least the step needs, not what the program's layout
moves: the padding slots of the cut's budget, the parent gathers of slots
that do not interpolate (t = 1: the parent's share is 0) and the backward
of slots the preprocess culls (their gradient is 0) are left out, so a
program that skips them reads nearer its bound and never past it. A step
over P hierarchy rows: the attribute matrix packed from the parameters
(P x 59); the interpolation's gathers, the child row of each valid slot
and the parent row of each that interpolates, and its lerps; the render's
preprocess of the valid slots forward and of the kept ones backward; both
blends (gsbench/yardstick.py:blend_bound); the loss (D-SSIM and L1); the
gathers' backward (the kept slots' gradient rows accumulated onto the rows
they index); the matrix's backward; and the masked Adam over all P rows
(it runs dense, under a mask).
"""
from __future__ import annotations

from typing import Dict

import torch

from gsbench import yardstick as ys

ROW_FLOATS = ys.ROW_ELEMENTS  # means 3, scales 3, quats 4, opacity 1, SH 48
INDEX_BYTES = 8  # the gathers' int64 indices
# per slot: the lerps of 59 floats (3 ops each), the rotation's dot and
# sign (8), the LOD opacity correction (a power, 6)
INTERP_OPS_PER_SLOT = 3 * ROW_FLOATS + 14
# per row: exp of the scales, the quaternion's normalisation, |x| opacity
PACK_OPS_PER_ROW = 3 + 12 + 1


def pack(rows: int) -> Dict:
    """The activated arrays packed into the (P, 59) matrix, and its backward
    split back: each reads and writes the matrix once."""
    return {"ops": rows * PACK_OPS_PER_ROW, "bytes": 2 * 2 * rows * ROW_FLOATS * 4}


def interp_fwd(child_slots: int, parent_slots: int) -> Dict:
    """The gathers of `child_slots` child rows and `parent_slots` parent
    rows (indices and rows read), and the lerped arrays of the child slots
    written."""
    return {"ops": child_slots * INTERP_OPS_PER_SLOT,
            "bytes": (child_slots + parent_slots) * (ROW_FLOATS * 4 + INDEX_BYTES) + child_slots * ROW_FLOATS * 4}


def interp_bwd(child_slots: int, parent_slots: int, unique_child_rows: int, unique_parent_rows: int) -> Dict:
    """The gathers' backward, the least the two sorted accumulations move:
    each reads its slots' gradient rows, their sorted indices and their
    positions, and writes each row it indexes once. The lerps' backward is
    counted as their forward."""
    rows = unique_child_rows + unique_parent_rows
    return {"ops": child_slots * INTERP_OPS_PER_SLOT,
            "bytes": (child_slots + parent_slots) * (ROW_FLOATS * 4 + 2 * INDEX_BYTES) + rows * ROW_FLOATS * 4}


def dssim_l1(height: int, width: int) -> Dict:
    """SSIM's separable 11x11 Gaussian on the five moment maps of three
    channels, forward and backward (twice the forward), and the L1."""
    px = height * width
    fwd = ys.conv_ops(15, height, width, 22) + 2 * 3 * px
    return {"ops": 3 * fwd, "bytes": 3 * (15 + 6) * px * 4}


def step_work(rows: int, slots: Dict, height: int, width: int, blend_fwd: Dict, blend_bwd: Dict) -> Dict:
    """The step's counted operations and bytes, and the least ms they take
    on the H100 (the larger of ops over the FP32 peak and bytes over the
    memory rate). `slots` holds the counts of `slot_counts`."""
    work = [pack(rows), interp_fwd(slots["valid"], slots["valid_interp"]), ys.pre_fwd(slots["valid"]), blend_fwd,
            dssim_l1(height, width), blend_bwd, ys.pre_bwd(slots["kept"]), backward(slots), ys.adam(rows)]
    ops, nbytes = sum(w["ops"] for w in work), sum(w["bytes"] for w in work)
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(ops / ys.FP32_FLOP_S, nbytes / ys.HBM_BYTES_S) * 1e3}


def backward(slots: Dict) -> Dict:
    """interp_bwd of the kept slots and the rows they index."""
    return interp_bwd(slots["kept"], slots["kept_interp"], slots["child_rows"], slots["parent_rows"])


def slot_counts(render_indices, parent_indices, ts, valid, kept) -> Dict:
    """The counts the step needs of a cut of B slots (torch tensors of B):
    the valid slots and those of them that interpolate (t < 1), the slots
    the preprocess keeps (`kept`, within the valid ones) and those that
    interpolate, and the rows the kept slots' gathers index: the distinct
    child rows, and the distinct parent rows of the kept slots that
    interpolate."""
    kept = kept & valid
    interp = ts < 1
    return {"valid": int(valid.sum()), "valid_interp": int((valid & interp).sum()), "kept": int(kept.sum()),
            "kept_interp": int((kept & interp).sum()),
            "child_rows": int(torch.unique(render_indices[kept]).numel()),
            "parent_rows": int(torch.unique(parent_indices[kept & interp]).numel())}
