"""The LOD hierarchy of a served model, built at set-up by the benchmark's
frozen copy of the native builder (gsbench/scenes/hier_builder.cpp).

The ctypes binding is a frozen copy of hidegs_tpu_torch/hier/build.py:37-143
(`_HierResult`, `compile_native`, `load_native`, `build_hierarchy`) at
commit 63641d3. The library is compiled with g++ and the program's flags
into gsbench/.cache/hier/ under a name that hashes the source and the
flags, written under a temporary name and moved into place. The result is
returned as plain arrays; the driver hands them to the program as the
`Hierarchy` of hidegs_tpu_torch/hier/io.py."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict

import numpy as np

SRC = Path(__file__).resolve().parent / "hier_builder.cpp"
CACHE = Path(__file__).resolve().parents[1] / ".cache" / "hier"
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
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return CACHE / f"libhier_builder_{h.hexdigest()[:16]}.so"


def compile_native() -> Path:
    lib = lib_path()
    if lib.exists():
        return lib
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)], check=True, capture_output=True, text=True,
                   timeout=300)
    os.replace(tmp, lib)
    return lib


def load_native():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(compile_native()))
        lib.build_hierarchy.restype = ctypes.POINTER(_HierResult)
        lib.build_hierarchy.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_float)] * 5
        lib.free_hierarchy.argtypes = [ctypes.POINTER(_HierResult)]
        _lib = lib
    return _lib


def build_hierarchy(pos: np.ndarray, rot: np.ndarray, scale: np.ndarray, alpha: np.ndarray,
                    shs: np.ndarray) -> Dict[str, np.ndarray]:
    """kd-tree and cluster-merge hierarchy of leaf gaussians (host arrays:
    positions, wxyz quaternions, linear scales, opacities, (P, 16, 3) SH):
    a dict of the `Hierarchy` fields (scales as logs)."""
    P = len(pos)
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
        return dict(
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
