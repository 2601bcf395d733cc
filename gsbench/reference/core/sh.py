# Frozen copy of hidegs_tpu_torch/core/sh.py:1-113 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Real spherical harmonics evaluation for view-dependent color.

Port of hidegs_tpu/core/sh.py: the reference's SH basis (PlenOctree
constants), degrees 0-3. Coefficients are (N, K, 3) with K = (deg+1)^2 ≤ 16
(index 0 is DC), or flat (N, 3K) laid out [k0_r, k0_g, k0_b, k1_r, ...].
Bands above the active degree are masked, so buffers stay at K = 16 while the
degree ramps up.
"""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

MAX_SH_DEGREE = 3
NUM_SH_COEFFS = (MAX_SH_DEGREE + 1) ** 2  # 16


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def _sh_basis_components(dirs: torch.Tensor):
    """The 16 degree-0..3 basis values at unit dirs (..., 3), as a list of (...,)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return [
        C0 * torch.ones_like(x),
        -C1 * y,
        C1 * z,
        -C1 * x,
        C2[0] * xy,
        C2[1] * yz,
        C2[2] * (2.0 * zz - xx - yy),
        C2[3] * xz,
        C2[4] * (xx - yy),
        C3[0] * y * (3.0 * xx - yy),
        C3[1] * xy * z,
        C3[2] * y * (4.0 * zz - xx - yy),
        C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        C3[4] * x * (4.0 * zz - xx - yy),
        C3[5] * z * (xx - yy),
        C3[6] * x * (xx - 3.0 * yy),
    ]


def sh_basis(dirs: torch.Tensor) -> torch.Tensor:
    """All 16 basis functions at unit dirs (..., 3) → (..., 16)."""
    return torch.stack(_sh_basis_components(dirs), dim=-1)


def degree_mask(active_degree, total_coeffs: int = NUM_SH_COEFFS, device=None) -> torch.Tensor:
    """(K,) 0/1 float mask keeping bands ≤ active_degree (an int or a tensor)."""
    if isinstance(active_degree, torch.Tensor):
        device = active_degree.device
    idx = torch.arange(total_coeffs, device=device)
    band = torch.floor(torch.sqrt(idx.to(torch.float32))).to(torch.int32)
    return (band <= active_degree).to(torch.float32)


def eval_sh(active_degree, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH → RGB before the +0.5 shift and clamp.

    sh: (..., K, 3), or flat (..., 3K); dirs: (..., 3), normalized here.
    """
    dirs = dirs * torch.rsqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-24)
    if sh.ndim == dirs.ndim:
        # flat (..., 3K): one (..., 3) row of coefficients per k, summed in
        # k order
        K = sh.shape[-1] // 3
        cols = sh.reshape(sh.shape[:-1] + (K, 3)).unbind(-2)
        basis = _sh_basis_components(dirs)
        mask = degree_mask(active_degree, K, device=sh.device)
        acc = (basis[0] * mask[0])[..., None] * cols[0]
        for k in range(1, K):
            acc = acc + (basis[k] * mask[k])[..., None] * cols[k]
        return acc
    K = sh.shape[-2]
    basis = sh_basis(dirs)[..., :K]
    mask = degree_mask(active_degree, K, device=sh.device)
    return torch.einsum("...k,...kc->...c", basis * mask, sh)


def sh_to_rgb(active_degree, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Eval, +0.5 shift, clamp at 0 (the reference's forward.cu:135-137)."""
    return torch.clamp(eval_sh(active_degree, sh, dirs) + 0.5, min=0.0)


def rgb_to_sh_dc(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] → DC coefficient (the reference's RGB2SH)."""
    return (rgb - 0.5) / C0


def sh_dc_to_rgb(dc: torch.Tensor) -> torch.Tensor:
    return dc * C0 + 0.5
