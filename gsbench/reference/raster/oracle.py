# Frozen copy of hidegs_tpu_torch/raster/oracle.py:1-91 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Dense O(N·pixels) reference rasterizer — the oracle for the blend paths.

Port of hidegs_tpu/raster/oracle.py: the compositing rules of the
reference's tile kernel (α clamp 0.99, α cut 1/255, transmittance stop
1e-4) without tiling or culling. Every Gaussian is evaluated at every pixel,
globally depth-sorted, and composited front to back by the closed form
    T_i = exp(cumsum_excl(log(1 - α)))_i ,  w_i = T_i · α_i · [T_incl_i ≥ ε].
For small scenes only.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from gsbench.reference.core.camera_math import CameraParams
from gsbench.reference.core.ewa import gaussian_alpha
from gsbench.reference.core.geometry import plane_depth_from_blend
from gsbench.reference.raster.preprocess import PreprocessedGaussians

T_EPS = 1e-4


def render_oracle(
    pre: PreprocessedGaussians,
    cam: CameraParams,
    background: Optional[torch.Tensor] = None,
    render_geo: bool = False,
) -> Dict[str, torch.Tensor]:
    """Render all channels densely; returns the reference output dict."""
    H, W = cam.height, cam.width
    N = pre.mean2d.shape[0]
    dev = pre.mean2d.device
    if background is None:
        background = torch.zeros(3, dtype=torch.float32, device=dev)

    # global front-to-back order; invisible gaussians last
    inf = torch.tensor(float("inf"), dtype=pre.depth.dtype, device=dev)
    order = torch.argsort(torch.where(pre.visible, pre.depth, inf), stable=True)
    mean2d = pre.mean2d[order]
    conic = pre.conic[order]
    opacity = pre.opacity[order]
    rgb = pre.rgb[order]
    inv_depth = pre.inv_depth[order]
    normal = pre.normal[order]
    distance = pre.distance[order]
    visible = pre.visible[order]

    v, u = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    pix = torch.stack([u, v], dim=-1).reshape(-1, 2)  # (P, 2)

    alpha = gaussian_alpha(mean2d[:, None, :], conic[:, None, :], opacity[:, None], pix[None, :, :])
    alpha = torch.where(visible[:, None], alpha, torch.zeros_like(alpha))

    log_t = torch.log1p(-alpha)
    cum_incl = torch.cumsum(log_t, dim=0)
    T_incl = torch.exp(cum_incl)
    T_excl = torch.exp(cum_incl - log_t)
    w = T_excl * alpha * (T_incl >= T_EPS)  # (N, P)

    color = torch.einsum("np,nc->pc", w, rgb)
    acc_alpha = w.sum(dim=0)
    invd = torch.einsum("np,n->p", w, inv_depth)
    T_final = T_incl[-1] if N > 0 else torch.ones_like(acc_alpha)

    out = {}
    out["render"] = color.T.reshape(3, H, W) + T_final.reshape(1, H, W) * background[:, None, None]
    out["alpha"] = acc_alpha.reshape(H, W)
    out["invdepth"] = invd.reshape(H, W)
    out["T_final"] = T_final.reshape(H, W)
    # per-Gaussian observability: contributed pixels while T > 0.5
    observe_sorted = ((w > 0) & (T_excl > 0.5)).sum(dim=1).to(torch.int32)
    observe = torch.zeros(N, dtype=torch.int32, device=dev)
    observe[order] = observe_sorted
    out["out_observe"] = observe

    if render_geo:
        nrm = torch.einsum("np,nc->pc", w, normal)
        dist = torch.einsum("np,n->p", w, distance)
        all_map = torch.cat(
            [nrm.T.reshape(3, H, W), acc_alpha.reshape(1, H, W), dist.reshape(1, H, W)], dim=0
        )
        out["rendered_normal"] = all_map[:3]
        out["rendered_distance"] = all_map[4]
        out["all_map"] = all_map
        out["plane_depth"] = plane_depth_from_blend(all_map[4], all_map[:3].permute(1, 2, 0), cam)
    return out
