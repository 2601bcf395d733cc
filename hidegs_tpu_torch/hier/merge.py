"""Hierarchy merger: stitch per-chunk hierarchies into one global `.hier`.

The port's own copy of hidegs_tpu/hier/merge.py (numpy only): the merged
file is byte-for-byte the JAX package's.

Equivalent of GaussianHierarchyMerger mode 2 (mainHierarchyMerger.cpp:44-139
+ hierarchy_explicit_loader.cpp): load each chunk's optimized hierarchy, drop
subtrees whose centers fall outside their own chunk cell (cross-chunk
duplicates from the far-camera padding), re-base node/gaussian indices, and
attach the chunk roots under a fresh global root whose merged primitive is
the weighted cluster-merge of the chunk roots (same math as the builder).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from hidegs_tpu_torch.hier.io import (
    COUNT_CHILDREN,
    COUNT_LEAFS,
    DEPTH,
    PARENT,
    START,
    START_CHILDREN,
    Hierarchy,
)


def _ellipse_surface(s):
    return s[..., 0] * s[..., 1] + s[..., 0] * s[..., 2] + s[..., 1] * s[..., 2]


def filter_chunk_simple(
    h: Hierarchy, center: np.ndarray, extent: np.ndarray, slack: float = 0.5
) -> Hierarchy:
    """Duplicate-suppression without restructuring: gaussians whose positions
    fall outside the chunk cell (+slack) get opacity 0 (render-culled). The
    tree topology is preserved, which keeps indices valid and matches the
    merger's goal (discard primitives by distance to chunk center,
    mainHierarchyMerger.cpp:96-120) with a simpler mechanism.

    Only the X/Y axes are tested: chunking is a ground-plan grid (the
    reference grids the camera bbox in XY, make_chunk.py:33-130) and the
    recorded chunk center rides at CAMERA altitude — an r3 largescene run
    culled 100% of gaussians (all-black LOD eval at every tau) because the
    z test compared ground content at z∈[-10,10] against a z=16±1 cell."""
    half = (0.5 + slack) * np.asarray(extent)[:2]
    lo = np.asarray(center)[:2] - half
    hi = np.asarray(center)[:2] + half
    inside = ((h.pos[:, :2] >= lo) & (h.pos[:, :2] <= hi)).all(axis=1)
    alpha = np.where(inside, h.alpha, 0.0).astype(np.float32)
    return h._replace(alpha=alpha)


def merge_hierarchies(
    chunks: Sequence[Hierarchy],
    centers: Optional[Sequence[np.ndarray]] = None,
    extents: Optional[Sequence[np.ndarray]] = None,
    slack: float = 0.5,
) -> Hierarchy:
    """Stitch chunk hierarchies under a new global root."""
    if centers is not None and extents is not None:
        chunks = [
            filter_chunk_simple(h, c, e, slack)
            for h, c, e in zip(chunks, centers, extents)
        ]

    pos = np.concatenate([h.pos for h in chunks])
    rot = np.concatenate([h.rot for h in chunks])
    scale = np.concatenate([h.scale for h in chunks])
    alpha = np.concatenate([h.alpha for h in chunks])
    shs = np.concatenate([h.shs for h in chunks])

    # new root occupies node 0 and owns one merged gaussian appended at the
    # end of the gaussian arrays
    nodes_out = [None]  # placeholder for root
    boxes_out = [None]
    g_offset = 0
    n_offset = 1
    root_children = []
    chunk_root_gauss = []
    for h in chunks:
        n = h.nodes.copy()
        n[:, START] += g_offset
        has_kids = n[:, COUNT_CHILDREN] > 0
        n[:, START_CHILDREN] = np.where(
            n[:, START_CHILDREN] >= 0, n[:, START_CHILDREN] + n_offset, n[:, START_CHILDREN]
        )
        n[:, PARENT] = np.where(n[:, PARENT] >= 0, n[:, PARENT] + n_offset, n[:, PARENT])
        n[0, PARENT] = 0  # chunk root's parent = global root
        root_children.append(n_offset)
        # chunk root's own (merged) gaussian for the global root's cluster merge
        chunk_root_gauss.append(h.nodes[0, START] + g_offset + h.nodes[0, COUNT_LEAFS])
        nodes_out.extend(list(n))
        boxes_out.extend(list(h.boxes))
        g_offset += h.num_points
        n_offset += h.num_nodes

    # union bounds + root merged primitive (weighted merge of chunk roots)
    mins = np.min(np.stack([h.boxes[0, 0, :3] for h in chunks]), axis=0)
    maxs = np.max(np.stack([h.boxes[0, 1, :3] for h in chunks]), axis=0)
    gran = float((maxs - mins).max())

    idxs = [min(i, g_offset - 1) for i in chunk_root_gauss]
    w = alpha[idxs] * _ellipse_surface(np.exp(scale[idxs]))
    w = w / max(w.sum(), 1e-12)
    root_pos = (w[:, None] * pos[idxs]).sum(0)
    root_shs = (w[:, None, None] * shs[idxs]).sum(0)
    root_scale = np.log(np.maximum((w[:, None] * np.exp(scale[idxs])).sum(0), 1e-12))
    root_alpha = np.float32(min(alpha[idxs].max(initial=0.0), 1.0))
    root_rot = rot[idxs[0]]

    pos = np.concatenate([pos, root_pos[None]])
    rot = np.concatenate([rot, root_rot[None]])
    scale = np.concatenate([scale, root_scale[None]])
    alpha = np.concatenate([alpha, np.array([root_alpha], np.float32)])
    shs = np.concatenate([shs, root_shs[None]])

    max_depth = max(int(h.nodes[0, DEPTH]) for h in chunks) + 1
    # The global root's children (the chunk roots) are NOT contiguous in the
    # stitched node array, so start_children is left at -1. That is fine for
    # the device LOD path: expand_to_size/computeTs only walk PARENT pointers
    # (chunk roots point at node 0), and `kids` reads the root's
    # count_children, which is correct below. Only the CPU expand_to_target
    # walks downward; hier/lod.py's version consults the parent array instead.
    root_node = np.array(
        [max_depth, -1, g_offset, 0, 1, -1, len(chunks)], np.int32
    )
    root_box = np.zeros((2, 4), np.float32)
    root_box[0, :3] = mins
    root_box[1, :3] = maxs
    root_box[0, 3] = root_box[1, 3] = gran

    nodes_out[0] = root_node
    boxes_out[0] = root_box
    nodes = np.stack(nodes_out).astype(np.int32)
    boxes = np.stack(boxes_out).astype(np.float32)

    return Hierarchy(pos, rot, scale, alpha, shs, nodes, boxes)
