# Frozen copy of hidegs_tpu_torch/model/knn.py:1-64 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Morton-order approximate 3-NN mean distance, for initial scales.

Port of hidegs_tpu/model/knn.py (the counterpart of simple-knn's distCUDA2):
Morton-sort the points and search a ±`window` neighbourhood in sorted
order. It only seeds initial scales, so an approximation is fine.

PyTorch has no full uint32 arithmetic, so the bit spreading runs in int64
with the same masks. Every mask fits in 32 bits, so the int64 products
masked back give exactly the wrapped uint32 results.
"""
from __future__ import annotations

import torch


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of each int over 30 bits (every 3rd position)."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """(N, 3) float points → (N,) int32 Morton codes on a 1024³ grid."""
    lo = points.amin(dim=0)
    hi = points.amax(dim=0)
    q = (points - lo) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(q * 1023.0, 0, 1023).to(torch.int64)
    code = (_expand_bits_10(q[:, 0]) << 2) | (_expand_bits_10(q[:, 1]) << 1) | _expand_bits_10(q[:, 2])
    return code.to(torch.int32)


def mean_knn_sq_dist(points: torch.Tensor, window: int = 16, k: int = 3) -> torch.Tensor:
    """Per-point mean squared distance to its ~k nearest neighbours, searched
    within ±window positions in Morton order; (N,). Makes no host sync."""
    n = points.shape[0]
    dev = points.device
    order = torch.argsort(morton_codes(points), stable=True)
    sorted_pts = points[order]
    ar = torch.arange(n, device=dev)
    cands = []
    for d in range(1, window + 1):
        for sign in (-1, 1):
            idx = ar + sign * d
            valid = (idx >= 0) & (idx < n)
            diff = sorted_pts - sorted_pts[torch.clamp(idx, 0, n - 1)]
            d2 = torch.sum(diff * diff, dim=-1)
            cands.append(d2.masked_fill(~valid, float("inf")))
    d2 = torch.sort(torch.stack(cands, dim=-1), dim=-1).values[:, :k]
    finite = torch.isfinite(d2)
    mean_d2 = torch.sum(torch.where(finite, d2, torch.zeros_like(d2)), dim=-1) / torch.clamp(
        finite.sum(dim=-1), min=1)
    out = torch.zeros((n,), dtype=points.dtype, device=dev)
    out[order] = mean_d2
    return out


def initial_scales(points: torch.Tensor, window: int = 16) -> torch.Tensor:
    """sqrt(mean 3-NN squared distance), clamped: the reference's initial
    isotropic scale."""
    return torch.sqrt(torch.clamp(mean_knn_sq_dist(points, window=window), min=1e-7))
