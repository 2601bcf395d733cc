"""Hierarchy cut selection and smooth LOD interpolation weights.

Port of hidegs_tpu/hier/lod.py, the reference's GPU traversal
(gaussianhierarchy/runtime_switching.cu): `markNodesForSize` (:403-431),
`putRenderIndicesIndexed` (:55-79 pattern) and `computeTsIndexed`
(:433-478), all elementwise over the flattened node arrays, expanded into a
fixed `budget` of slots.

Node granularity: box.min.w / distance(viewpoint, box), ∞ when the viewpoint
is inside the box (computeSizeGPU, runtime_switching.cu:135-143).

The JAX version packs each node's row into an int32 bitcast table so that
one row gather serves every per-slot field, and finds each slot's owner
with a unique-index scatter and a cummax. Both are TPU workarounds. Here
the per-node fields are plain columns, and a slot's owner is the first
node whose cumulative count passes the slot (`torch.searchsorted`), which
has no duplicate destinations even when the cut overflows its budget. The
output contract is the JAX package's: every HierCut field, with the same
sentinels in the padding slots.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from hidegs_tpu_torch.hier.io import (
    COUNT_CHILDREN,
    COUNT_LEAFS,
    COUNT_MERGED,
    DEPTH,
    PARENT,
    START,
)
from hidegs_tpu_torch.train.losses import maximum

BIG = 3.4e38  # the size of a node whose box holds the viewpoint (float32)

Target = Union[float, torch.Tensor]


def tau_to_target_size(tau_px: float, fx: float) -> float:
    """Pixel granularity τ → the angular size unit `node_size` compares
    against (the h3dgs render_hierarchy.py convention:
    threshold = 2·(τ+0.5)·tan(fovx/2)/(W/2) = (2τ+1)/fx). τ=0 still maps to
    1/fx, about one pixel; callers that want the literal full-leaf cut pass
    target_size=0."""
    return (2.0 * float(tau_px) + 1.0) / float(fx)


def _target(target_size: Target, like: torch.Tensor) -> torch.Tensor:
    """The target size as a float32 scalar tensor on `like`'s device, built
    without a host-to-device copy."""
    if isinstance(target_size, torch.Tensor):
        return target_size.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(target_size), dtype=torch.float32, device=like.device)


def _box_size(box7: torch.Tensor, viewpoint: torch.Tensor) -> torch.Tensor:
    """(.., 7) [mn mx granularity] rows → projected granularity
    (computeSizeGPU, runtime_switching.cu:135-143)."""
    mn, mx, gran = box7[..., 0:3], box7[..., 3:6], box7[..., 6]
    vp = viewpoint.to(box7.dtype)
    d = torch.minimum(torch.maximum(vp, mn), mx) - vp
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
    inside = torch.all((vp >= mn) & (vp <= mx), dim=-1)
    return torch.where(inside, torch.full_like(gran, BIG), gran / torch.clamp(dist, min=1e-12))


def _flat_boxes(boxes: torch.Tensor) -> torch.Tensor:
    return torch.cat([boxes[:, 0, :3], boxes[:, 1, :3], boxes[:, 0, 3:4]], dim=-1)


def node_size(boxes: torch.Tensor, viewpoint: torch.Tensor) -> torch.Tensor:
    """(N, 2, 4) boxes + (3,) viewpoint → (N,) projected granularity."""
    return _box_size(_flat_boxes(boxes), viewpoint)


class PackedHier(NamedTuple):
    """Per-node columns of one hierarchy, built once (`pack_hierarchy`) and
    read by every cut: each node's box and its parent's, so that the count
    pass is elementwise, and the fields the slots of a cut gather."""

    leafs: torch.Tensor  # (N,) int32 count_leafs
    merged: torch.Tensor  # (N,) int32 count_merged, 0 at depth 0
    obox: torch.Tensor  # (N, 7) f32 own box: mn(3) mx(3) granularity
    pbox: torch.Tensor  # (N, 7) f32 the parent's box (its own at the root)
    par_has: torch.Tensor  # (N,) bool
    start: torch.Tensor  # (N,) int32 first gaussian
    par_start: torch.Tensor  # (N,) int32 the parent's first gaussian
    par_kids: torch.Tensor  # (N,) int32 the parent's child count, 1 at the root


def pack_hierarchy(nodes: torch.Tensor, boxes: torch.Tensor) -> PackedHier:
    """(N, 7) int32 nodes and (N, 2, 4) float32 boxes → PackedHier, on
    their device."""
    parent = nodes[:, PARENT].long()
    has_parent = parent >= 0
    parent_cl = torch.clamp(parent, min=0)
    flat = _flat_boxes(boxes).to(torch.float32)
    one = torch.ones_like(nodes[:, COUNT_CHILDREN])
    return PackedHier(
        leafs=nodes[:, COUNT_LEAFS].to(torch.int32),
        merged=torch.where(nodes[:, DEPTH] != 0, nodes[:, COUNT_MERGED], 0).to(torch.int32),
        obox=flat.contiguous(),
        pbox=flat[parent_cl].contiguous(),
        par_has=has_parent,
        start=nodes[:, START].to(torch.int32),
        par_start=nodes[parent_cl, START].to(torch.int32),
        par_kids=torch.where(has_parent, nodes[parent_cl, COUNT_CHILDREN], one).to(torch.int32),
    )


def _packed_counts(ph: PackedHier, target: torch.Tensor, viewpoint: torch.Tensor) -> torch.Tensor:
    """markNodesForSize (runtime_switching.cu:410-424): gaussians each node
    emits for this cut, (N,) int32."""
    size = _box_size(ph.obox, viewpoint)
    parent_size = torch.where(ph.par_has, _box_size(ph.pbox, viewpoint), torch.full_like(size, BIG))
    zero = torch.zeros_like(ph.leafs)
    return torch.where(
        size >= target,
        ph.leafs,
        torch.where(ph.par_has & (parent_size >= target), ph.leafs + ph.merged, zero),
    )


def cut_size_packed(ph: PackedHier, target_size: Target, viewpoint: torch.Tensor) -> torch.Tensor:
    """() int64: the gaussians the cut at `target_size` selects, without a
    budget-sized buffer (one N-node pass; stays on the device)."""
    return torch.sum(_packed_counts(ph, _target(target_size, ph.obox), viewpoint))


def cut_size(nodes: torch.Tensor, boxes: torch.Tensor, target_size: Target, viewpoint: torch.Tensor):
    """cut_size_packed of pack_hierarchy(nodes, boxes): lets callers fit the
    expansion budget to the τ-dependent cut, so coarse cuts get small
    streams (VERDICT r3 item 3)."""
    return cut_size_packed(pack_hierarchy(nodes, boxes), target_size, viewpoint)


class HierCut(NamedTuple):
    """Fixed-budget selection of gaussians to render for one viewpoint."""

    render_indices: torch.Tensor  # (B,) int32 gaussian index (P = invalid)
    parent_indices: torch.Tensor  # (B,) int32 parent's first gaussian (or self)
    node_of: torch.Tensor  # (B,) int32 owning node (N = invalid)
    ts: torch.Tensor  # (B,) float32 interpolation weight (1 = invalid)
    kids: torch.Tensor  # (B,) int32 parent child count (1 = invalid)
    valid: torch.Tensor  # (B,) bool
    num_selected: torch.Tensor  # () int32 total wanted (pre-truncation)


def expand_packed(
    ph: PackedHier,
    target_size: Target,
    viewpoint: torch.Tensor,  # (3,)
    budget: int,
    num_points: int = 0,
) -> HierCut:
    """Select the LOD cut (markNodesForSize) and compute the interpolation
    weights (computeTsIndexed) for the first `budget` gaussians of the cut,
    in node order. Slots past the cut's total are padding. Runs on the
    device of `ph`, with no host read."""
    N = ph.leafs.shape[0]
    dev = ph.obox.device
    target = _target(target_size, ph.obox)
    count = _packed_counts(ph, target, viewpoint)
    ends = torch.cumsum(count, 0, dtype=torch.int32)
    starts = ends - count
    total = ends[-1]
    slots = torch.arange(budget, dtype=torch.int32, device=dev)
    # the owner of slot s: the first node whose range ends past s
    node = torch.searchsorted(ends, slots, right=True)
    node_c = torch.clamp(node, max=N - 1)
    valid = slots < total
    local = slots - starts[node_c]

    par_has = ph.par_has[node_c]
    gauss = ph.start[node_c] + local
    par_gauss = torch.where(par_has, ph.par_start[node_c], gauss)
    kids = torch.where(par_has, ph.par_kids[node_c], torch.ones_like(gauss))

    # computeTsIndexed (runtime_switching.cu:433-478)
    nsize = _box_size(ph.obox[node_c], viewpoint)
    psize = torch.where(par_has, _box_size(ph.pbox[node_c], viewpoint), torch.full_like(nsize, BIG))
    start_v = torch.maximum(0.5 * psize, nsize)
    diff = psize - start_v
    tdiff = torch.clamp(target - start_v, min=0.0)
    one = torch.ones_like(nsize)
    t_smooth = torch.where(diff <= 0, one, torch.clamp(1.0 - tdiff / torch.clamp(diff, min=1e-20), min=0.0))
    ts = torch.where(~par_has | (psize > 2.0 * target), one, t_smooth)

    if num_points:
        p_sentinel = torch.full((), num_points, dtype=torch.int32, device=dev)
    else:
        p_sentinel = torch.max(ph.start) + 1
    return HierCut(
        render_indices=torch.where(valid, gauss, p_sentinel).to(torch.int32),
        parent_indices=torch.where(valid, par_gauss, p_sentinel).to(torch.int32),
        node_of=torch.where(valid, node.to(torch.int32), torch.full_like(slots, N)),
        ts=torch.where(valid, ts, one),
        kids=torch.where(valid, kids, torch.ones_like(kids)).to(torch.int32),
        valid=valid,
        num_selected=total.to(torch.int32),
    )


def expand_to_size(
    nodes: torch.Tensor,  # (N, 7) int32
    boxes: torch.Tensor,  # (N, 2, 4) f32
    target_size: Target,
    viewpoint: torch.Tensor,  # (3,)
    budget: int,
    num_points: int = 0,
) -> HierCut:
    """Pack, then expand. Callers that cut one hierarchy many times
    (AdaptiveHierRenderer) pack once and call `expand_packed`."""
    return expand_packed(pack_hierarchy(nodes, boxes), target_size, viewpoint, budget=budget,
                         num_points=num_points)


def expand_to_target(nodes_np, target: int):
    """CPU breadth-first expansion to ≈target leaf count
    (traversal.cpp:expandToTarget / markTargetNodes, runtime_switching.cu:32-52):
    a node is selected if its depth > target or its parent's depth > target."""
    depth = nodes_np[:, DEPTH]
    parent = nodes_np[:, PARENT]
    has_parent = parent >= 0
    pdepth = np.where(has_parent, depth[np.maximum(parent, 0)], -1)
    count = np.where(
        depth > target,
        nodes_np[:, COUNT_LEAFS],
        np.where(
            has_parent & (pdepth > target),
            nodes_np[:, COUNT_LEAFS] + np.where(depth != 0, nodes_np[:, COUNT_MERGED], 0),
            0,
        ),
    )
    out = []
    for n in np.where(count > 0)[0]:
        s = nodes_np[n, START]
        out.extend(range(s, s + count[n]))
    return np.array(out, dtype=np.int32)


def hierarchy_opacity_correction(alpha: torch.Tensor, ts: torch.Tensor, kids: torch.Tensor) -> torch.Tensor:
    """Smooth LOD alpha correction (forward.cu:547-556):
    α ← t·α + (1−t)·(1 − (1−α)^(1/kids)). Differentiable in α and t, with
    jnp.maximum's gradient at the clamps' ties."""
    inv_kids = torch.reciprocal(maximum(kids.to(torch.float32), 1.0))
    merged = 1.0 - torch.pow(maximum(1.0 - alpha, 1e-8), inv_kids)
    return ts * alpha + (1.0 - ts) * merged
