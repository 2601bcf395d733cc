"""Out-of-core chunk streaming for UAV-scale scenes.

Port of hidegs_tpu/hier/streaming.py, the counterpart of the reference's
runtime maintenance layer (gaussianhierarchy/runtime_maintenance.cu,
`Maintenance::reorder/compress`, with which the SIBR viewer streams very
large scenes): only the chunks near the viewpoint are resident; as the
camera moves, chunk hierarchies are loaded from disk into an LRU cache and
distant ones are evicted.

Each active chunk selects its own cut over its own node arrays (no global
index rebasing), the interpolated gaussians are concatenated, and one
`render` call draws the frame. A resident chunk keeps its arrays on the
streamer's device beside the host copy, so a frame moves no hierarchy
between host and device.
"""
from __future__ import annotations

import glob
import os
from collections import OrderedDict
from typing import List, Tuple

import numpy as np
import torch

from hidegs_tpu_torch.device import DeviceLike, resolve_device
from hidegs_tpu_torch.hier.interp import hierarchy_tensors, interpolate_cut
from hidegs_tpu_torch.hier.io import Hierarchy, read_hier
from hidegs_tpu_torch.hier.lod import expand_to_size
from hidegs_tpu_torch.raster.api import RasterConfig, render


class ChunkStreamer:
    """LRU-cached access to per-chunk hierarchies on disk."""

    def __init__(
        self,
        chunks_dir: str,
        hier_name: str = "hierarchy.hier",
        max_resident: int = 9,
        active_radius_chunks: float = 1.5,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.hier_name = hier_name
        self.max_resident = max_resident
        self.active_radius_chunks = active_radius_chunks
        self.chunks: List[Tuple[str, np.ndarray, np.ndarray]] = []  # (dir, center, extent)
        for d in sorted(glob.glob(os.path.join(chunks_dir, "chunk_*"))):
            if not os.path.exists(os.path.join(d, hier_name)):
                continue
            center = np.loadtxt(os.path.join(d, "center.txt")).reshape(-1)[:3]
            extent = np.loadtxt(os.path.join(d, "extent.txt")).reshape(-1)[:3]
            self.chunks.append((d, center, extent))
        if not self.chunks:
            raise FileNotFoundError(f"no chunk hierarchies under {chunks_dir}")
        # chunk → (host hierarchy, its arrays on the device)
        self._cache: "OrderedDict[int, Tuple[Hierarchy, tuple]]" = OrderedDict()
        self.loads = 0  # disk loads performed

    def active_chunks(self, viewpoint: np.ndarray) -> List[int]:
        """Chunks whose cell (scaled by active_radius_chunks) contains the
        XY-projected viewpoint, the streaming viewer's residency rule."""
        vp = np.asarray(viewpoint)[:2]
        out = []
        for i, (_, center, extent) in enumerate(self.chunks):
            half = 0.5 * self.active_radius_chunks * extent[:2]
            if np.all(np.abs(vp - center[:2]) <= half):
                out.append(i)
        if not out:  # nothing nearby (viewpoint outside the grid): nearest chunk
            d = [np.linalg.norm(vp - c[:2]) for _, c, _ in self.chunks]
            out = [int(np.argmin(d))]
        return out

    def _entry(self, idx: int):
        if idx in self._cache:
            self._cache.move_to_end(idx)
            return self._cache[idx]
        h = read_hier(os.path.join(self.chunks[idx][0], self.hier_name))
        self._cache[idx] = (h, hierarchy_tensors(h, self.device))
        self.loads += 1
        while len(self._cache) > self.max_resident:
            self._cache.popitem(last=False)  # evict the least recently used
        return self._cache[idx]

    def get(self, idx: int) -> Hierarchy:
        """Chunk `idx`'s hierarchy, loaded from disk if it is not resident."""
        return self._entry(idx)[0]

    @property
    def resident(self) -> List[int]:
        return list(self._cache.keys())

    def gather_cut(self, cam, target_size: float, budget_per_chunk: int = 1 << 15):
        """Per-chunk LOD cuts for `cam`, interpolated and concatenated:
        (means3d, scales, quats, opacities, shs) ready for render(); padding
        slots carry opacity 0. Reads the camera centre to the host once."""
        vp = cam.camera_center.to(self.device)
        parts = []
        for ci in self.active_chunks(vp.cpu().numpy()):
            h = self.get(ci)
            nodes, boxes, pos, scales, rot, alpha, shs = self._cache[ci][1]
            cut = expand_to_size(nodes, boxes, target_size, vp, budget=budget_per_chunk,
                                 num_points=h.num_points)
            parts.append(interpolate_cut(cut, pos, scales, rot, alpha, shs))
        return tuple(torch.cat([getattr(p, f) for p in parts]) for f in parts[0]._fields)

    def render_view(self, cam, target_size: float, config=None, budget_per_chunk: int = 1 << 15):
        arrays = self.gather_cut(cam, target_size, budget_per_chunk)
        return render(*arrays, cam, config=config or RasterConfig())
