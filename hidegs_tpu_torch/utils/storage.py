"""Large-model storage + scaffold loading.

The port's own copy of hidegs_tpu/utils/storage.py (numpy and utils/ply
only), with `save_model_dir` taking a port GaussianState. Files written by
either package read the same in the other. Parity targets:
  * save_pt / packed point_cloud.bin for >8M-point models
    (scene/gaussian_model.py:487-520; switch threshold scene/__init__.py:159)
    — here one packed little-endian binary with a small header + an .npz
    twin, plus pc_info.txt (skybox count, scene/__init__.py:162).
  * scaffold loading (gaussian_model.py:235-274): take a neighboring chunk's
    trained model, keep points in the XY Chebyshev annulus
    0.5·extent < max(|dx|,|dy|) < 1.5·extent around this chunk's center
    (plus its skybox), to stabilize chunk borders. Scaffold points train
    nothing: they are protected from densify/prune and opacity reset.
"""
from __future__ import annotations

import os
import struct
from typing import Dict

import numpy as np

MAGIC = b"HGTP"  # hidegs-tpu packed
VERSION = 1


def save_packed(path: str, arrays: Dict[str, np.ndarray]):
    """Packed binary: [magic][version][n_arrays] then per array
    [name_len][name][dtype_len][dtype][ndim][dims...][raw bytes]."""
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<ii", VERSION, len(arrays)))
        for name, a in arrays.items():
            a = np.ascontiguousarray(a)
            nb = name.encode()
            dt = a.dtype.str.encode()
            f.write(struct.pack("<i", len(nb)))
            f.write(nb)
            f.write(struct.pack("<i", len(dt)))
            f.write(dt)
            f.write(struct.pack("<i", a.ndim))
            f.write(struct.pack(f"<{a.ndim}q", *a.shape))
            f.write(a.tobytes())


def load_packed(path: str) -> Dict[str, np.ndarray]:
    out = {}
    with open(path, "rb") as f:
        assert f.read(4) == MAGIC, "bad magic"
        version, n = struct.unpack("<ii", f.read(8))
        for _ in range(n):
            (ln,) = struct.unpack("<i", f.read(4))
            name = f.read(ln).decode()
            (ld,) = struct.unpack("<i", f.read(4))
            dt = np.dtype(f.read(ld).decode())
            (nd,) = struct.unpack("<i", f.read(4))
            shape = struct.unpack(f"<{nd}q", f.read(8 * nd))
            count = int(np.prod(shape)) if shape else 1
            out[name] = np.frombuffer(f.read(count * dt.itemsize), dtype=dt).reshape(shape).copy()
    return out


def save_model_dir(
    directory: str, state, skybox_count: int = 0, packed_threshold: int = 8_000_000
):
    """Save a GaussianState: ply below the threshold, packed bin + npz above
    (mirrors the ply↔pt/bin switch); always writes pc_info.txt."""
    os.makedirs(directory, exist_ok=True)
    alive = state.alive.cpu().numpy()
    params = {f: getattr(state.params, f).detach().cpu().numpy()
              for f in ("xyz", "sh_dc", "sh_rest", "opacity", "scaling", "rotation")}
    if int(alive.sum()) <= packed_threshold:
        from hidegs_tpu_torch.utils.ply import save_gaussian_ply

        save_gaussian_ply(os.path.join(directory, "point_cloud.ply"), params, alive=alive)
    else:
        save_packed(os.path.join(directory, "point_cloud.bin"), {k: v[alive] for k, v in params.items()})
    with open(os.path.join(directory, "pc_info.txt"), "w") as f:
        f.write(f"{skybox_count}\n")


def load_scaffold(
    scaffold_dir: str, center: np.ndarray, extent: np.ndarray
) -> Dict[str, np.ndarray]:
    """Load a trained neighbor model and select the border annulus
    (gaussian_model.py:258-274). Returns raw parameter arrays."""
    from hidegs_tpu_torch.utils.ply import load_gaussian_arrays

    ply_path = os.path.join(scaffold_dir, "point_cloud.ply")
    bin_path = os.path.join(scaffold_dir, "point_cloud.bin")
    if os.path.exists(ply_path):
        d = load_gaussian_arrays(ply_path)
    else:
        d = load_packed(bin_path)
    skybox = 0
    info = os.path.join(scaffold_dir, "pc_info.txt")
    if os.path.exists(info):
        with open(info) as f:
            skybox = int(f.readline().strip() or 0)

    xyz = d["xyz"]
    dist = np.abs(xyz - np.asarray(center)[None])
    cheb = np.maximum(dist[:, 0], dist[:, 1])
    sel = (cheb > 0.5 * extent[0]) & (cheb < 1.5 * extent[0])
    if skybox:
        # keep the scaffold's skybox rows — THIS codebase stores the skybox
        # at the buffer TAIL (trainer appends it; interp takes the last rows),
        # unlike the reference's head convention
        sel[-skybox:] = True
    return {k: v[sel] for k, v in d.items()}
