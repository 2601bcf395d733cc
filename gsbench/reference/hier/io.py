# Frozen copy of hidegs_tpu_torch/hier/io.py:1-148 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""`.hier` binary hierarchy format IO.

The port's own copy of hidegs_tpu/hier/io.py (numpy only): a file written
by either package reads the same in the other.

Byte-compatible with the reference writer/loader
(gaussianhierarchy/hierarchy_loader.cpp:16-60, hierarchy_writer.cpp:14-118,
types.h:50-66):

    int32 P
    float pos[P*3]; float rot[P*4]; float scale[P*3]; float alpha[P];
    float shs[P*48]
    int32 N
    Node[N]: int32 {depth, parent, start, count_leafs, count_merged,
                    start_children, count_children}
    Box[N]:  float {min.xyzw, max.xyzw}   (min.w carries the node granularity)

A negative P in the header marks the half-precision compressed variant
(HalfNode, types.h:61-66) — read is supported, write always emits float.

Gaussian attribute conventions (writer.cpp:36-55): `scale` is the LOG scale
(the creator writes g.scale.array().log()); `alpha` is the ACTIVATED opacity
in [0,1] (the reference's create_from_hier switches the opacity activation to
|x|, scene/gaussian_model.py:358-431); shs are [dc(3), rest(45)] per point.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

NODE_FIELDS = 7


class Hierarchy(NamedTuple):
    pos: np.ndarray  # (P, 3) f32
    rot: np.ndarray  # (P, 4) f32
    scale: np.ndarray  # (P, 3) f32 LOG scale
    alpha: np.ndarray  # (P,) f32 activated opacity
    shs: np.ndarray  # (P, 16, 3) f32
    nodes: np.ndarray  # (N, 7) i32 [depth,parent,start,count_leafs,count_merged,start_children,count_children]
    boxes: np.ndarray  # (N, 2, 4) f32 [min.xyzw, max.xyzw]

    @property
    def num_points(self) -> int:
        return len(self.pos)

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)


def write_hier(path: str, h: Hierarchy, compressed: bool = False) -> None:
    P = len(h.pos)
    N = len(h.nodes)
    with open(path, "wb") as f:
        if compressed:
            # half-precision variant (hierarchy_writer.cpp:58-118)
            np.int32(-P).tofile(f)
            h.pos.astype("<f4").tofile(f)
            h.rot.astype("<f2").tofile(f)
            h.scale.astype("<f2").tofile(f)
            h.alpha.astype("<f2").tofile(f)
            h.shs.reshape(P, 48).astype("<f2").tofile(f)
            np.int32(N).tofile(f)
            raw = np.zeros(N, np.dtype("<i4,<i4,<i4,<4i2"))
            raw["f0"] = h.nodes[:, PARENT]
            raw["f1"] = h.nodes[:, START]
            raw["f2"] = h.nodes[:, START_CHILDREN]
            raw["f3"][:, 0] = h.nodes[:, DEPTH]
            raw["f3"][:, 1] = h.nodes[:, COUNT_CHILDREN]
            raw["f3"][:, 2] = h.nodes[:, COUNT_LEAFS]
            raw["f3"][:, 3] = h.nodes[:, COUNT_MERGED]
            raw.tofile(f)
            h.boxes.reshape(N, 8).astype("<f2").tofile(f)
            return
        np.int32(P).tofile(f)
        h.pos.astype("<f4").tofile(f)
        h.rot.astype("<f4").tofile(f)
        h.scale.astype("<f4").tofile(f)
        h.alpha.astype("<f4").tofile(f)
        # shs stored as dc(3) + rest(45) flat per point
        h.shs.reshape(P, 48).astype("<f4").tofile(f)
        np.int32(N).tofile(f)
        h.nodes.astype("<i4").tofile(f)
        h.boxes.reshape(N, 8).astype("<f4").tofile(f)


def read_hier(path: str) -> Hierarchy:
    with open(path, "rb") as f:
        P = int(np.fromfile(f, "<i4", 1)[0])
        if P < 0:
            return _read_hier_compressed(f, -P)
        pos = np.fromfile(f, "<f4", P * 3).reshape(P, 3)
        rot = np.fromfile(f, "<f4", P * 4).reshape(P, 4)
        scale = np.fromfile(f, "<f4", P * 3).reshape(P, 3)
        alpha = np.fromfile(f, "<f4", P)
        shs = np.fromfile(f, "<f4", P * 48).reshape(P, 16, 3)
        N = int(np.fromfile(f, "<i4", 1)[0])
        nodes = np.fromfile(f, "<i4", N * NODE_FIELDS).reshape(N, NODE_FIELDS)
        boxes = np.fromfile(f, "<f4", N * 8).reshape(N, 2, 4)
    return Hierarchy(pos, rot, scale, alpha, shs, nodes, boxes)


def _read_hier_compressed(f, P: int) -> Hierarchy:
    """Half-precision variant (hierarchy_loader.cpp:66-128, HalfNode/HalfBox2
    types.h:61-66): pos stays f32; rot/scale/alpha/shs are f16; nodes pack
    depth/count_children/count_leafs/count_merged into int16 dccc[4]."""
    pos = np.fromfile(f, "<f4", P * 3).reshape(P, 3)
    rot = np.fromfile(f, "<f2", P * 4).reshape(P, 4).astype(np.float32)
    scale = np.fromfile(f, "<f2", P * 3).reshape(P, 3).astype(np.float32)
    alpha = np.fromfile(f, "<f2", P).astype(np.float32)
    shs = np.fromfile(f, "<f2", P * 48).reshape(P, 16, 3).astype(np.float32)
    N = int(np.fromfile(f, "<i4", 1)[0])
    # HalfNode: int parent, start, start_children; short dccc[4]
    raw = np.fromfile(f, np.dtype("<i4,<i4,<i4,<4i2"), N)
    nodes = np.zeros((N, NODE_FIELDS), np.int32)
    nodes[:, PARENT] = raw["f0"]
    nodes[:, START] = raw["f1"]
    nodes[:, START_CHILDREN] = raw["f2"]
    dccc = raw["f3"].astype(np.int32)
    nodes[:, DEPTH] = dccc[:, 0]
    nodes[:, COUNT_CHILDREN] = dccc[:, 1]
    nodes[:, COUNT_LEAFS] = dccc[:, 2]
    nodes[:, COUNT_MERGED] = dccc[:, 3]
    boxes = np.fromfile(f, "<f2", N * 8).reshape(N, 2, 4).astype(np.float32)
    return Hierarchy(pos, rot, scale, alpha, shs, nodes, boxes)


# node field indices
DEPTH, PARENT, START, COUNT_LEAFS, COUNT_MERGED, START_CHILDREN, COUNT_CHILDREN = range(7)


def write_anchors(path: str, indices: np.ndarray) -> None:
    """anchors.bin: int32 count then int32 gaussian indices, little-endian
    (appearance_filter.cpp:417-436 writeAnchors; read back by the reference
    trainer at scene/gaussian_model.py:366-371)."""
    idx = np.asarray(indices, dtype="<i4")
    with open(path, "wb") as f:
        np.int32(len(idx)).astype("<i4").tofile(f)
        idx.tofile(f)


def read_anchors(path: str) -> np.ndarray:
    """Read anchors.bin → (K,) int32 gaussian indices."""
    with open(path, "rb") as f:
        n = int(np.fromfile(f, "<i4", 1)[0])
        return np.fromfile(f, "<i4", n)
