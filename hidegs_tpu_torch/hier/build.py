"""The hierarchy builder: a ctypes binding to the native C++ builder,
and a NumPy fallback with the same semantics (the oracle of the tests).

Port of hidegs_tpu/hier/build.py. The native source is the port's own copy,
hier/native/hier_builder.cpp (the JAX package's, unchanged), compiled by
`g++` with the JAX package's flags at first use into build/hier/ (which git
ignores), never next to the source. The library's name hashes the source
and the flags; it is written under a temporary name and moved into place,
so processes that build at once never load a half-written library.

Equivalent of GaussianHierarchyCreator (mainHierarchyCreator.cpp:38-163;
the algorithm's citations are in native/hier_builder.cpp).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from hidegs_tpu_torch.core.transforms import build_covariance_3d, rotmat_to_quat
from hidegs_tpu_torch.hier.io import Hierarchy

SRC = Path(__file__).resolve().parent / "native" / "hier_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hier"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


class _HierResult(ctypes.Structure):
    _fields_ = [
        ("num_points", ctypes.c_int),
        ("num_nodes", ctypes.c_int),
        ("pos", ctypes.POINTER(ctypes.c_float)),
        ("rot", ctypes.POINTER(ctypes.c_float)),
        ("log_scale", ctypes.POINTER(ctypes.c_float)),
        ("alpha", ctypes.POINTER(ctypes.c_float)),
        ("shs", ctypes.POINTER(ctypes.c_float)),
        ("nodes", ctypes.POINTER(ctypes.c_int)),
        ("boxes", ctypes.POINTER(ctypes.c_float)),
    ]


def lib_path() -> Path:
    """The builder library of this source and these flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhier_builder_{h.hexdigest()[:16]}.so"


def compile_native() -> Path:
    """Compile the builder into build/hier/ unless it is there; returns the
    library path. Raises when g++ is missing or fails."""
    lib = lib_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("the hierarchy builder needs g++, which was not found") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed ({e.returncode}):\n{' '.join(cmd)}\n{e.stderr}") from e
    os.replace(tmp, lib)
    return lib


def load_native():
    """The loaded builder library (compiled on first use). Raises when it
    cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(compile_native()))
    lib.build_hierarchy.restype = ctypes.POINTER(_HierResult)
    lib.build_hierarchy.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_float)] * 5
    lib.free_hierarchy.argtypes = [ctypes.POINTER(_HierResult)]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the native builder builds and loads here (reports why not)."""
    try:
        load_native()
        return True
    except (RuntimeError, OSError) as e:
        print(f"hier_builder native build failed: {e}", file=sys.stderr)
        return False


def build_hierarchy(
    pos: np.ndarray,  # (P, 3)
    rot: np.ndarray,  # (P, 4) wxyz
    scale: np.ndarray,  # (P, 3) LINEAR activated scale
    alpha: np.ndarray,  # (P,) activated opacity
    shs: np.ndarray,  # (P, 16, 3)
    use_native: Optional[bool] = None,
) -> Hierarchy:
    """kd-tree + cluster-merge hierarchy from trained leaf gaussians (numpy
    arrays on the host). `use_native=True` raises when the native builder
    cannot be built or loaded; None uses it when it can, as the JAX package
    does; False takes the NumPy fallback."""
    P = len(pos)
    if use_native is None:
        use_native = native_available()
    if not use_native:
        return build_hierarchy_py(pos, rot, scale, alpha, shs)
    lib = load_native()
    arrs = [np.ascontiguousarray(a, np.float32) for a in (pos, rot, scale, alpha, np.reshape(shs, (P, 48)))]
    for name, a, shape in zip(("pos", "rot", "scale", "alpha"), arrs, ((P, 3), (P, 4), (P, 3), (P,))):
        if a.shape != shape:
            raise ValueError(f"build_hierarchy: {name} has shape {a.shape}, expected {shape}")
    ptrs = [a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in arrs]
    res = lib.build_hierarchy(P, *ptrs)
    if not res:
        raise RuntimeError("build_hierarchy returned null (no valid gaussians?)")
    r = res.contents
    n_p, n_n = r.num_points, r.num_nodes
    try:
        return Hierarchy(
            pos=np.ctypeslib.as_array(r.pos, (n_p, 3)).copy(),
            rot=np.ctypeslib.as_array(r.rot, (n_p, 4)).copy(),
            scale=np.ctypeslib.as_array(r.log_scale, (n_p, 3)).copy(),
            alpha=np.ctypeslib.as_array(r.alpha, (n_p,)).copy(),
            shs=np.ctypeslib.as_array(r.shs, (n_p, 48)).reshape(n_p, 16, 3).copy(),
            nodes=np.ctypeslib.as_array(r.nodes, (n_n, 7)).copy(),
            boxes=np.ctypeslib.as_array(r.boxes, (n_n, 8)).reshape(n_n, 2, 4).copy(),
        )
    finally:
        lib.free_hierarchy(res)


# ------------------------------------------------------------ numpy fallback


def _ellipse_surface(s):
    return s[..., 0] * s[..., 1] + s[..., 0] * s[..., 2] + s[..., 1] * s[..., 2]


def build_hierarchy_py(pos, rot, scale, alpha, shs) -> Hierarchy:
    """The NumPy builder (JAX's _build_hierarchy_py), with the port's
    float32 covariance and rotation-to-quaternion on the CPU."""
    pos = np.asarray(pos, np.float32)
    rot = np.asarray(rot, np.float32)
    scale = np.asarray(scale, np.float32)
    alpha = np.asarray(alpha, np.float32)
    shs = np.asarray(shs, np.float32).reshape(len(pos), 48)

    finite = np.isfinite(pos).all(1) & np.isfinite(scale).all(1) & np.isfinite(alpha)
    keep = np.where(finite)[0]
    pos, rot, scale, alpha, shs = pos[keep], rot[keep], scale[keep], alpha[keep], shs[keep]
    cov = build_covariance_3d(torch.from_numpy(scale), torch.from_numpy(rot)).numpy()

    class TN:
        __slots__ = ("depth", "bounds", "leaf", "merged", "children")

        def __init__(self):
            self.depth = 0
            self.bounds = np.zeros((2, 4), np.float32)
            self.leaf = []
            self.merged = None
            self.children = []

    def rec_kdtree(idx):
        node = TN()
        r = 3.0 * scale[idx].max(axis=1, keepdims=True)
        mn = (pos[idx] - r).min(axis=0)
        mx = (pos[idx] + r).max(axis=0)
        node.bounds[0, :3] = mn
        node.bounds[1, :3] = mx
        if len(idx) == 1:
            node.leaf = [idx[0]]
            return node
        axis = int(np.argmax(mx - mn))
        order = np.argsort(pos[idx, axis], kind="stable")
        idx = idx[order]
        piv = len(idx) // 2
        node.children = [rec_kdtree(idx[:piv]), rec_kdtree(idx[piv:])]
        node.depth = max(c.depth for c in node.children) + 1
        return node

    def merge_rec(node):
        to_merge = []
        for c in node.children:
            merge_rec(c)
            if c.merged is not None:
                to_merge.append(c.merged)
            for li in c.leaf:
                to_merge.append((pos[li], rot[li], scale[li], alpha[li], shs[li], cov[li]))
        gran = float((node.bounds[1, :3] - node.bounds[0, :3]).max())
        node.bounds[0, 3] = node.bounds[1, 3] = gran
        if node.depth == 0:
            return
        ws = np.array([g[3] * _ellipse_surface(g[2]) for g in to_merge])
        wsum = ws.sum()
        w = ws / max(wsum, 1e-20)
        mpos = sum(wi * g[0] for wi, g in zip(w, to_merge))
        mshs = sum(wi * g[4] for wi, g in zip(w, to_merge))
        C = np.zeros((3, 3))
        for wi, g in zip(w, to_merge):
            d = (g[0] - mpos)[:, None]
            C += wi * (g[5] + d @ d.T)
        C += np.diag(np.maximum(np.diag(C) * 1e-4, np.finfo(np.float32).eps))
        evals, evecs = np.linalg.eigh(C)
        if np.dot(np.cross(evecs[:, 0], evecs[:, 1]), evecs[:, 2]) < 0:
            evecs[:, 2] *= -1
        mscale = np.sqrt(np.abs(evals)).astype(np.float32)
        mquat = rotmat_to_quat(torch.from_numpy(evecs[None].astype(np.float32))).numpy()[0]
        mop = min(float(wsum / max(_ellipse_surface(mscale), 1e-20)), 1.0)
        mcov = evecs @ np.diag(evals) @ evecs.T
        node.merged = (
            mpos.astype(np.float32),
            mquat.astype(np.float32),
            mscale,
            np.float32(mop),
            mshs.astype(np.float32),
            mcov.astype(np.float32),
        )

    def flatten(root):
        out_g = []
        nodes = [np.zeros(7, np.int32)]
        boxes = [np.zeros((2, 4), np.float32)]
        nodes[0][1] = -1

        def pop_rec(tn, nid):
            boxes[nid] = tn.bounds
            nodes[nid][2] = len(out_g)  # start
            for li in tn.leaf:
                out_g.append((pos[li], rot[li], scale[li], alpha[li], shs[li]))
            nodes[nid][3] = len(tn.leaf)
            if tn.merged is not None:
                g = tn.merged
                out_g.append((g[0], g[1], g[2], g[3], g[4]))
                nodes[nid][4] = 1
            sc = len(nodes)
            # the reference sets start_children = the next index even for
            # leaves (writer.cpp:58); count_children = 0 leaves it unused
            nodes[nid][5] = sc
            for _ in tn.children:
                n = np.zeros(7, np.int32)
                n[1] = nid
                nodes.append(n)
                boxes.append(np.zeros((2, 4), np.float32))
            nodes[nid][6] = len(tn.children)
            nodes[nid][0] = tn.depth
            for i, c in enumerate(tn.children):
                pop_rec(c, sc + i)

        pop_rec(root, 0)
        return out_g, np.stack(nodes), np.stack(boxes)

    root = rec_kdtree(np.arange(len(pos)))
    merge_rec(root)
    gs, nodes, boxes = flatten(root)
    return Hierarchy(
        pos=np.stack([g[0] for g in gs]),
        rot=np.stack([g[1] for g in gs]),
        scale=np.log(np.maximum(np.stack([g[2] for g in gs]), 1e-20)),
        alpha=np.array([g[3] for g in gs], np.float32),
        shs=np.stack([g[4] for g in gs]).reshape(-1, 16, 3),
        nodes=nodes,
        boxes=boxes,
    )
