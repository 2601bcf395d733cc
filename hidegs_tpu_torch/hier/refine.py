"""Hierarchy refinement passes run after the kd-tree/cluster-merge build:

The port's own copy of hidegs_tpu/hier/refine.py (numpy only).

- :func:`align_rotations` — RotationAligner::align equivalent
  (rotation_aligner.cpp:59-115): re-express every gaussian's (rotation,
  scale) in the axis ordering/signs that best matches its parent node's
  merged gaussian, so that the LOD child↔parent quaternion interpolation
  (interp.py) blends matching axes instead of arbitrary eigendecomposition
  orderings. The represented covariance is unchanged.
- :func:`appearance_filter` — AppearanceFilter::filter equivalent
  (appearance_filter.cpp:265-358): collapse subtrees finer than any training
  camera can ever resolve, walking the granularity limit up by
  `layer_multiplier` per pass like the reference.
- :func:`compute_anchors` — AppearanceFilter::writeAnchors equivalent
  (appearance_filter.cpp:361-436): indices of gaussians at/below the
  finest-limit render cut over all cameras. The reference training loads
  them in create_from_hier (scene/gaussian_model.py:366-374); our post-opt
  freezes them (hier_trainer.post_optimize(anchors=...)).

Everything here is offline host-side tooling, so plain numpy (vectorized per
tree level, no per-node Python loops on the hot paths).
"""
from __future__ import annotations

import itertools

import numpy as np

from hidegs_tpu_torch.hier.io import Hierarchy

# node field indices (io.py NODE layout)
DEPTH, PARENT, START, N_LEAF, N_MERGED, START_CH, N_CH = range(7)


def _quat_to_rotmat_np(q: np.ndarray) -> np.ndarray:
    """(N, 4) wxyz quats → (N, 3, 3). Normalizes first."""
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    ).reshape(-1, 3, 3)


def _rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """(N, 3, 3) → (N, 4) wxyz. Shepperd's method, branch-free via argmax."""
    m00, m11, m22 = R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]
    tr = m00 + m11 + m22
    # four candidate 4*q_i^2 values
    qw2 = 1 + tr
    qx2 = 1 + m00 - m11 - m22
    qy2 = 1 - m00 + m11 - m22
    qz2 = 1 - m00 - m11 + m22
    cand = np.stack([qw2, qx2, qy2, qz2], axis=-1)
    best = np.argmax(cand, axis=-1)
    q = np.zeros((len(R), 4), np.float64)
    s = 2.0 * np.sqrt(np.maximum(cand[np.arange(len(R)), best], 1e-12))
    for b in range(4):
        m = best == b
        if not m.any():
            continue
        Rm, sm = R[m], s[m]
        if b == 0:
            q[m] = np.stack(
                [0.25 * sm,
                 (Rm[:, 2, 1] - Rm[:, 1, 2]) / sm,
                 (Rm[:, 0, 2] - Rm[:, 2, 0]) / sm,
                 (Rm[:, 1, 0] - Rm[:, 0, 1]) / sm], axis=-1)
        elif b == 1:
            q[m] = np.stack(
                [(Rm[:, 2, 1] - Rm[:, 1, 2]) / sm,
                 0.25 * sm,
                 (Rm[:, 0, 1] + Rm[:, 1, 0]) / sm,
                 (Rm[:, 0, 2] + Rm[:, 2, 0]) / sm], axis=-1)
        elif b == 2:
            q[m] = np.stack(
                [(Rm[:, 0, 2] - Rm[:, 2, 0]) / sm,
                 (Rm[:, 0, 1] + Rm[:, 1, 0]) / sm,
                 0.25 * sm,
                 (Rm[:, 1, 2] + Rm[:, 2, 1]) / sm], axis=-1)
        else:
            q[m] = np.stack(
                [(Rm[:, 1, 0] - Rm[:, 0, 1]) / sm,
                 (Rm[:, 0, 2] + Rm[:, 2, 0]) / sm,
                 (Rm[:, 1, 2] + Rm[:, 2, 1]) / sm,
                 0.25 * sm], axis=-1)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return q.astype(np.float32)


def _proper_signed_perms():
    """The 24 proper rotations of the axis frame: (perm, signs) pairs with
    parity(perm) * prod(signs) = +1 (the det>0 filter at
    rotation_aligner.cpp:86-87)."""
    out = []
    for perm in itertools.permutations(range(3)):
        parity = 1
        p = list(perm)
        for i in range(3):
            for j in range(i + 1, 3):
                if p[i] > p[j]:
                    parity = -parity
        for bits in range(8):
            signs = np.array([1 - 2 * ((bits >> k) & 1) for k in range(3)], np.float32)
            if parity * int(np.prod(signs)) > 0:
                out.append((np.array(perm), signs))
    return out


_PERMS = _proper_signed_perms()  # 24 candidates


def _align_batch(rot: np.ndarray, scale: np.ndarray, ref_rot: np.ndarray):
    """Align each (rot[i], scale[i]) to ref_rot[i] over the 24 signed axis
    permutations, maximizing frobenius(R_candidate, R_ref)
    (rotation_aligner.cpp:59-106 matchExhaustive, vectorized)."""
    K = len(rot)
    Rm = _quat_to_rotmat_np(rot)  # (K,3,3), columns are axes
    Rr = _quat_to_rotmat_np(ref_rot)
    scores = np.empty((K, len(_PERMS)), np.float32)
    for c, (perm, signs) in enumerate(_PERMS):
        Rt = Rm[:, :, perm] * signs[None, None, :]
        scores[:, c] = np.einsum("kij,kij->k", Rt, Rr)
    best = np.argmax(scores, axis=-1)
    new_rot = np.empty_like(rot)
    new_scale = np.empty_like(scale)
    for c, (perm, signs) in enumerate(_PERMS):
        m = best == c
        if not m.any():
            continue
        Rt = Rm[m][:, :, perm] * signs[None, None, :]
        new_rot[m] = _rotmat_to_quat_np(Rt.astype(np.float64))
        new_scale[m] = scale[m][:, perm]
    return new_rot, new_scale


def _merged_index(nodes: np.ndarray) -> np.ndarray:
    """Per-node index of its (first) merged gaussian, -1 if none."""
    idx = nodes[:, START] + nodes[:, N_LEAF]
    return np.where(nodes[:, N_MERGED] > 0, idx, -1)


def align_rotations(h: Hierarchy) -> Hierarchy:
    """Top-down: every gaussian of node `n` is aligned to the merged gaussian
    of parent(n) (rotation_aligner.cpp:112-115 topDownAlign). Nodes are
    processed by decreasing height so the parent's merged gaussian is already
    aligned when its children look at it. Works for linear or log scales —
    the alignment only permutes scale axes, which commutes with exp."""
    nodes = h.nodes
    rot = h.rot.copy()
    scale = h.scale.copy()
    merged_of = _merged_index(nodes)
    parent = nodes[:, PARENT]
    counts = nodes[:, N_LEAF] + nodes[:, N_MERGED]

    heights = nodes[:, DEPTH]
    for d in range(int(heights.max()), -1, -1):
        nids = np.flatnonzero(heights == d)
        nids = nids[parent[nids] >= 0]
        if len(nids) == 0:
            continue
        ref_m = merged_of[parent[nids]]
        nids = nids[ref_m >= 0]
        if len(nids) == 0:
            continue
        # gather all gaussians of these nodes with their refs
        gi, ri = [], []
        for nid in nids:
            s, c = nodes[nid, START], counts[nid]
            if c == 0:
                continue
            gi.append(np.arange(s, s + c))
            ri.append(np.full(c, merged_of[parent[nid]]))
        if not gi:
            continue
        gi = np.concatenate(gi)
        ri = np.concatenate(ri)
        new_rot, new_scale = _align_batch(rot[gi], scale[gi], rot[ri])
        rot[gi] = new_rot
        scale[gi] = new_scale
    return h._replace(rot=rot, scale=scale)


def _node_sizes(boxes: np.ndarray, cam_positions: np.ndarray) -> np.ndarray:
    """(C, N) projected granularity of each node box from each camera:
    minn.w / dist(box, cam), inf when the camera is inside the box
    (runtime_switching.cu:118-143 pointboxdist/computeSize)."""
    mn = boxes[None, :, 0, :3]  # (1,N,3)
    mx = boxes[None, :, 1, :3]
    cp = cam_positions[:, None, :]  # (C,1,3)
    closest = np.clip(cp, mn, mx)
    dist = np.linalg.norm(cp - closest, axis=-1)  # (C,N)
    gran = boxes[None, :, 0, 3]
    with np.errstate(divide="ignore"):
        size = np.where(dist > 0, gran / np.maximum(dist, 1e-20), np.inf)
    return size


def _seen_mask(nodes: np.ndarray, boxes: np.ndarray, cam_positions: np.ndarray,
               limit: float) -> np.ndarray:
    """seen[n] = node n is selected by the expand-to-size cut for SOME camera
    at `limit` (runtime_switching.cu:402-431 markNodesForSize): its own size
    ≥ limit, or it is the switch point (own size < limit ≤ parent size)."""
    size = _node_sizes(boxes, cam_positions)  # (C,N)
    parent = nodes[:, PARENT]
    has_p = parent >= 0
    psize = np.where(has_p[None, :], size[:, np.maximum(parent, 0)], np.inf)
    sel = (size >= limit) | (has_p[None, :] & (psize >= limit) & (size < limit))
    return sel.any(axis=0)


def _bottom_cut(nodes: np.ndarray, seen: np.ndarray) -> np.ndarray:
    """bottom[n] = n is on the lower boundary of the seen set
    (appearance_filter.cpp:138-171 bottomRec): covered(n) = all children
    covered, else seen(n); bottom = seen nodes not covered by children.
    Computed bottom-up by height level (no recursion)."""
    N = len(nodes)
    nch = nodes[:, N_CH]
    covered = np.zeros(N, bool)
    allcov = np.zeros(N, bool)
    heights = nodes[:, DEPTH]
    for d in range(0, int(heights.max()) + 1):
        for nid in np.flatnonzero(heights == d):
            if nch[nid] > 0:
                s = nodes[nid, START_CH]
                allcov[nid] = covered[s : s + nch[nid]].all()
            covered[nid] = allcov[nid] or seen[nid]
    return seen & ~allcov


def _descendant_mask(nodes: np.ndarray, roots: np.ndarray, strict: bool) -> np.ndarray:
    """Mask of nodes at (strict=False) or strictly below (strict=True) any
    node in `roots`, via one top-down sweep."""
    below = np.zeros(len(nodes), bool)
    parent = nodes[:, PARENT]
    heights = nodes[:, DEPTH]
    onroot = np.zeros(len(nodes), bool)
    onroot[roots] = True
    for d in range(int(heights.max()), -1, -1):
        nids = np.flatnonzero(heights == d)
        pa = parent[nids]
        inherit = np.where(pa >= 0, below[np.maximum(pa, 0)] | onroot[np.maximum(pa, 0)], False)
        below[nids] = inherit
    return below if strict else (below | onroot)


def compute_anchors(h: Hierarchy, cam_positions: np.ndarray,
                    limit: float = 5e-4) -> np.ndarray:
    """Gaussian indices of nodes at/below the union-over-cameras render cut at
    `limit` (appearance_filter.cpp:361-436 writeAnchors): these render at full
    detail from every training viewpoint, so post-opt should not disturb them.
    Returns sorted int32 indices."""
    nodes = np.asarray(h.nodes)
    seen = _seen_mask(nodes, np.asarray(h.boxes), np.asarray(cam_positions, np.float32), limit)
    bottom = _bottom_cut(nodes, seen)
    atbelow = _descendant_mask(nodes, np.flatnonzero(bottom), strict=False)
    idx = []
    for n in np.flatnonzero(atbelow):
        s = nodes[n, START]
        c = nodes[n, N_LEAF] + nodes[n, N_MERGED]
        if c > 0:
            idx.append(np.arange(s, s + c))
    if not idx:
        return np.zeros(0, np.int32)
    return np.unique(np.concatenate(idx)).astype(np.int32)


def appearance_filter(h: Hierarchy, cam_positions: np.ndarray,
                      limit: float = 5e-4, layer_multiplier: float = 2.0) -> Hierarchy:
    """Collapse subtrees no training camera can resolve
    (appearance_filter.cpp:265-358): at successively doubled limits, mark the
    bottom render cut; internal nodes strictly below a cut that are never
    themselves marked (and aren't leaves) are dropped, their leaf descendants
    re-linked to the nearest kept ancestor. Rebuilds the node/gaussian arrays
    compacted."""
    nodes = np.asarray(h.nodes).copy()
    boxes = np.asarray(h.boxes)
    cams = np.asarray(cam_positions, np.float32)
    N = len(nodes)
    marked = np.zeros(N, bool)
    dropped = np.zeros(N, bool)
    is_leaf_node = nodes[:, N_CH] == 0
    L = limit
    while L <= 1.0:
        # cuts are evaluated on the original tree (the reference re-walks the
        # partially collapsed tree; the difference only affects nodes already
        # slated to drop)
        seen = _seen_mask(nodes, boxes, cams, L)
        bottom = _bottom_cut(nodes, seen) & ~dropped
        # collapseUnused runs BEFORE this round's bottom is marked
        # (appearance_filter.cpp:343-348): internal descendants of the cut
        # not marked by a previous (finer) round are removed; leaves are
        # re-linked to the cut node (recCollapse keeps marked/depth-0
        # children, appearance_filter.cpp:197-215)
        below = _descendant_mask(nodes, np.flatnonzero(bottom), strict=True)
        dropped |= below & ~marked & ~is_leaf_node
        marked |= bottom
        L *= layer_multiplier

    keep = ~dropped
    keep[0] = True

    # new parent: nearest kept ancestor
    parent = nodes[:, PARENT]
    new_parent = parent.copy()
    heights = nodes[:, DEPTH]
    for d in range(int(heights.max()), -1, -1):
        for nid in np.flatnonzero((heights == d) & keep):
            p = parent[nid]
            while p >= 0 and not keep[p]:
                p = parent[p]
            new_parent[nid] = p

    # rebuild children lists grouped under new parents, DFS order like the
    # original writer (children of a node contiguous)
    kept = np.flatnonzero(keep)
    children: dict[int, list[int]] = {int(n): [] for n in kept}
    for nid in kept:
        p = int(new_parent[nid])
        if p >= 0:
            children[p].append(int(nid))

    old2new: dict[int, int] = {}
    out_nodes, out_boxes = [], []
    out_g: list[int] = []  # old gaussian indices in new order

    # assign ids in BFS order so each node's children land contiguous
    order: list[tuple[int, int]] = []  # (old_id, new_parent_id)
    from collections import deque

    q = deque([0])
    old2new[0] = 0
    order.append((0, -1))
    while q:
        nid = q.popleft()
        for c in children[nid]:
            old2new[c] = len(order)
            order.append((c, old2new[nid]))
            q.append(c)

    Nn = len(order)
    new_nodes = np.zeros((Nn, 7), np.int32)
    new_boxes = np.zeros((Nn, 2, 4), np.float32)
    # children were appended in BFS directly after parents; compute ranges
    ch_start = np.full(Nn, 0, np.int32)
    ch_count = np.zeros(Nn, np.int32)
    for new_id, (old_id, par_new) in enumerate(order):
        if par_new >= 0:
            if ch_count[par_new] == 0:
                ch_start[par_new] = new_id
            ch_count[par_new] += 1

    counts = nodes[:, N_LEAF] + nodes[:, N_MERGED]
    for new_id, (old_id, par_new) in enumerate(order):
        s, c = nodes[old_id, START], counts[old_id]
        new_nodes[new_id, DEPTH] = nodes[old_id, DEPTH]
        new_nodes[new_id, PARENT] = par_new
        new_nodes[new_id, START] = len(out_g)
        out_g.extend(range(int(s), int(s + c)))
        new_nodes[new_id, N_LEAF] = nodes[old_id, N_LEAF]
        new_nodes[new_id, N_MERGED] = nodes[old_id, N_MERGED]
        new_nodes[new_id, START_CH] = ch_start[new_id] if ch_count[new_id] else new_id + 1
        new_nodes[new_id, N_CH] = ch_count[new_id]
        new_boxes[new_id] = boxes[old_id]

    # recompute heights for the collapsed tree (leaves may now hang higher)
    par = new_nodes[:, PARENT]
    hgt = np.zeros(Nn, np.int32)
    for new_id in range(Nn - 1, -1, -1):
        p = par[new_id]
        if p >= 0:
            hgt[p] = max(hgt[p], hgt[new_id] + 1)
    new_nodes[:, DEPTH] = hgt

    gi = np.asarray(out_g, np.int64)
    return Hierarchy(
        pos=h.pos[gi], rot=h.rot[gi], scale=h.scale[gi],
        alpha=h.alpha[gi], shs=h.shs[gi],
        nodes=new_nodes, boxes=new_boxes,
    )
