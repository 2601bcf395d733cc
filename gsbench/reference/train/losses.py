# Frozen copy of hidegs_tpu_torch/train/losses.py:1-161 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Photometric losses and metrics.

Port of hidegs_tpu/train/losses.py: L1, L2, PSNR, windowed SSIM (σ = 1.5,
11x11, depthwise convolutions with padding 5), D-SSIM + L1, the image-
gradient edge weight, 3x3 dilation / erosion and LNCC. Images are
channel-first (C, H, W) float32.

The convolutions run in full float32: the package turns TF32 off
(hidegs_tpu_torch/__init__.py), the counterpart of the JAX package's
Precision.HIGHEST here; with TF32 the moment differences of SSIM lose
the digits its variance estimates need.

Clamps use `clip` (torch.maximum / torch.minimum against tensors) wherever
the JAX code clips a value that can sit exactly on the bound: at a tie
those give each side half the gradient, as jnp.clip, jnp.maximum and
jnp.minimum do, while torch.clamp gives all of it to the input. Likewise
`abs_` gives the gradient +1 at 0, as jnp.abs does (torch.abs gives 0):
a rendered background pixel and its ground truth are both exactly 0.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.maximum(x, c): half the gradient to each side at a tie."""
    return torch.maximum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.minimum(x, c): half the gradient to each side at a tie."""
    return torch.minimum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi), with its gradient."""
    return minimum(maximum(x, lo), hi)


def abs_(x: torch.Tensor) -> torch.Tensor:
    """jnp.abs(x), with its gradient: +1 at 0, like every x ≥ 0."""
    return torch.where(x >= 0, x, -x)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(abs_(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def psnr(pred: torch.Tensor, gt: torch.Tensor, mask=None) -> torch.Tensor:
    """PSNR in dB; optional (H, W) mask."""
    err = (pred - gt) ** 2
    if mask is None:
        mse = torch.mean(err)
    else:
        if mask.ndim == err.ndim - 1:
            mask = mask[None]
        mask = torch.broadcast_to(mask, err.shape)
        mse = torch.sum(err * mask) / maximum(torch.sum(mask), 1e-8)
    return 20.0 * torch.log10(1.0 / torch.sqrt(maximum(mse, 1e-12)))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window(size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The window on `device`, copied there once: a copy per call would
    make the host wait for the device in every train step."""
    return torch.as_tensor(_gaussian_window(size, sigma), device=device)


def _depthwise_conv2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """(C, H, W) image ⊛ (kh, kw) kernel per channel, zero-padded SAME."""
    C = img.shape[0]
    kh, kw = kernel.shape
    weight = kernel.expand(C, 1, kh, kw)
    return F.conv2d(img[None], weight, padding=(kh // 2, kw // 2), groups=C)[0]


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """Mean SSIM with a gaussian window."""
    win = _window(window_size, sigma, img1.device)
    mu1 = _depthwise_conv2d(img1, win)
    mu2 = _depthwise_conv2d(img2, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # moment-difference variances clamped to ≥ 0: cancellation can leave
    # them slightly negative, and a negative denominator unbounds the ratio
    sigma1_sq = maximum(_depthwise_conv2d(img1 * img1, win) - mu1_sq, 0.0)
    sigma2_sq = maximum(_depthwise_conv2d(img2 * img2, win) - mu2_sq, 0.0)
    sigma12 = _depthwise_conv2d(img1 * img2, win) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return clip(torch.mean(ssim_map), -1.0, 1.0)


def dssim_l1(pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2) -> torch.Tensor:
    """The reference photometric objective (1-λ)·L1 + λ·(1-SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (1.0 - ssim(pred, gt))


def image_gradient_weight(gt: torch.Tensor) -> torch.Tensor:
    """Edge-aware weight map in [0, 1]: 1 - normalized image gradient
    magnitude. gt: (3, H, W) → (H, W)."""
    gray = torch.mean(gt, dim=0)
    dx = torch.abs(gray[:, 2:] - gray[:, :-2])[1:-1, :]
    dy = torch.abs(gray[2:, :] - gray[:-2, :])[:, 1:-1]
    grad = torch.maximum(dx, dy)
    gmin, gmax = torch.min(grad), torch.max(grad)
    grad = (grad - gmin) / maximum(gmax - gmin, 1e-8)
    out = torch.ones_like(gray)
    out[1:-1, 1:-1] = 1.0 - grad
    return out


def dilate(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """3x3 max filter (binary dilation). mask: (H, W)."""
    m = mask
    for _ in range(iterations):
        m = F.max_pool2d(m[None, None], 3, stride=1, padding=1)[0, 0]
    return m


def erode(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """3x3 min filter (binary erosion). mask: (H, W)."""
    m = mask
    for _ in range(iterations):
        m = -F.max_pool2d(-m[None, None], 3, stride=1, padding=1)[0, 0]
    return m


def lncc(ref_patches: torch.Tensor, src_patches: torch.Tensor, ncc_threshold: float = 0.9):
    """Local normalized cross-correlation over the last (patch) dim.
    Returns (loss = 1 - NCC in [0, 2], mask = loss < threshold)."""
    mean_r = torch.mean(ref_patches, dim=-1, keepdim=True)
    mean_s = torch.mean(src_patches, dim=-1, keepdim=True)
    var_r = torch.mean(ref_patches**2, dim=-1, keepdim=True) - mean_r**2
    var_s = torch.mean(src_patches**2, dim=-1, keepdim=True) - mean_s**2
    cov = torch.mean(ref_patches * src_patches, dim=-1, keepdim=True) - mean_r * mean_s
    denom = torch.sqrt(maximum(var_r * var_s, 1e-10))
    ncc = clip(cov / denom, -1.0, 1.0)[..., 0]
    loss = 1.0 - ncc
    return loss, loss < ncc_threshold
