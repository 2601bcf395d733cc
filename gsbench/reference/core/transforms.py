# Frozen copy of hidegs_tpu_torch/core/transforms.py:1-112 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Rotation / scaling / covariance math for 3D Gaussians.

Port of hidegs_tpu/core/transforms.py: batched tensor ops over any leading
shape.
"""
from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    # eps inside the sqrt keeps the gradient finite at the zero vector
    return v * torch.rsqrt(torch.sum(v * v, dim=dim, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (w, x, y, z) → (..., 3, 3) rotations; normalizes."""
    q = normalize(q, dim=-1)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations → (..., 4) (w, x, y, z) quaternions.

    Branch-free Shepperd's method: all four candidates, selected by the
    largest denominator.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _stack(a, b, c, d):
        return torch.stack([a, b, c, d], dim=-1)

    s0 = torch.sqrt(torch.clamp(tr + 1.0, min=1e-12)) * 2.0
    q0 = _stack(0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0)
    s1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 2.0
    q1 = _stack((m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1)
    s2 = torch.sqrt(torch.clamp(1.0 + m11 - m00 - m22, min=1e-12)) * 2.0
    q2 = _stack((m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2)
    s3 = torch.sqrt(torch.clamp(1.0 + m22 - m00 - m11, min=1e-12)) * 2.0
    q3 = _stack((m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3)

    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q_rest = torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3))
    q = torch.where((tr > 0.0)[..., None], q0, q_rest)
    return normalize(q, dim=-1)


def build_scaling_rotation(scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """M = R(q) @ diag(s), (..., 3, 3)."""
    return quat_to_rotmat(quat) * scale[..., None, :]


def build_covariance_3d(scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Σ = M Mᵀ with M = R diag(s), (..., 3, 3)."""
    M = build_scaling_rotation(scale, quat)
    return torch.einsum("...ij,...kj->...ik", M, M)


def covariance_to_symm6(cov: torch.Tensor) -> torch.Tensor:
    """Symmetric (..., 3, 3) → (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )


def symm6_to_covariance(s: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`covariance_to_symm6`."""
    xx, xy, xz, yy, yz, zz = (s[..., i] for i in range(6))
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def smallest_axis(scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Unit direction of each Gaussian's smallest principal axis, (..., 3):
    the argmin column of R(q)."""
    R = quat_to_rotmat(quat)
    idx = torch.argmin(scale, dim=-1)
    sel = (torch.arange(3, device=scale.device) == idx[..., None]).to(R.dtype)
    return torch.einsum("...ij,...j->...i", R, sel)
