# Frozen copy of hidegs_tpu_torch/train/frequency.py:1-214 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Multi-scale frequency-spatial regularization and high-frequency-aware
scale regularization, HiDeGS's own loss terms.

Port of hidegs_tpu/train/frequency.py (the reference's
scripts/frequency_regularization.py:1047-1676):

  * avg-pool pyramid, 3 levels weighted [0.1, 0.05, 0.025];
  * per level 0.7·spatial + 0.3·fft, where spatial = clip(0.7·Sobel MSE +
    0.3·Laplacian MSE, 0, 1) and fft = clip(0.6·log-magnitude MSE +
    0.2·wrapped phase + 0.2·band-energy MSE over 4 radial annuli, 0, 10);
    level loss in [0, 0.1], total in [0, 0.1];
  * high-frequency mask of the ground truth (Sobel, Laplacian and an FFT
    high-pass, min-max normalized, threshold 0.2);
  * scale regularization of visible gaussians whose max scale > 0.01,
    gated on the mask having any pixel;
  * total = clip(λ_freq·freq + λ_scale·scale, 0, 1), zero during warm-up.
    The warm-up gate is a `where`, so the terms run on every step;
  * `save_debug_panel`, the 2x2 panel the trainer dumps, written with
    utils/png.py (the JAX package writes it through Pillow).

3x3 convolutions use padding 1 (zero-padded SAME) in full float32.
Clamps and |x| go through losses.clip / maximum / abs_ (the JAX
gradients at ties and at 0). The max scale is torch.amax, which, like jnp.max, splits the
gradient between tied entries (isotropic initial scales tie).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gsbench.reference.train.losses import abs_, clip, maximum

KERNELS = {
    "sobel_x": np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32),
    "sobel_y": np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32),
    "laplacian": np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], np.float32),
}


@functools.lru_cache(maxsize=None)
def _kernel(name: str, device: torch.device) -> torch.Tensor:
    """(1, 1, 3, 3) kernel on `device`, copied there once (a copy per call
    would make the host wait for the device in every train step)."""
    return torch.as_tensor(KERNELS[name], device=device)[None, None]


def _conv2d_same(img2d: torch.Tensor, kernel: str) -> torch.Tensor:
    """(H, W) ⊛ the named 3x3 kernel, zero-padded SAME."""
    return F.conv2d(img2d[None, None], _kernel(kernel, img2d.device), padding=1)[0, 0]


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """(C, H, W) → (C, H//2, W//2), 2x2 mean, odd edges dropped."""
    C, H, W = img.shape
    H2, W2 = H // 2, W // 2
    return img[:, : 2 * H2, : 2 * W2].reshape(C, H2, 2, W2, 2).mean(dim=(2, 4))


def _radial_distance(h: int, w: int, device):
    cy, cx = h // 2, w // 2
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return torch.sqrt((y - cy) ** 2 + (x - cx) ** 2), float(min(cy, cx))


def _fft_features(gray: torch.Tensor, freq_bands: int = 4):
    """fftshifted magnitude, log-magnitude and phase, and radial band energies."""
    g = clip(gray, 0.0, 1.0)
    Fq = torch.fft.fftshift(torch.fft.fft2(g))
    magnitude = torch.abs(Fq)
    phase = torch.angle(Fq)
    log_magnitude = torch.log(magnitude + 1e-6)
    distance, rmax = _radial_distance(*gray.shape, gray.device)
    energies = []
    for i in range(freq_bands):
        inner = i * rmax / freq_bands
        outer = (i + 1) * rmax / freq_bands
        band = ((distance >= inner) & (distance < outer)).to(torch.float32)
        energies.append((magnitude * band).sum() / (band.sum() + 1e-8))
    return magnitude, log_magnitude, phase, torch.stack(energies)


def _spatial_freq_loss(rendered_gray: torch.Tensor, gt_gray: torch.Tensor) -> torch.Tensor:
    gx_r = _conv2d_same(rendered_gray, "sobel_x")
    gy_r = _conv2d_same(rendered_gray, "sobel_y")
    gx_g = _conv2d_same(gt_gray, "sobel_x")
    gy_g = _conv2d_same(gt_gray, "sobel_y")
    grad_loss = torch.mean((gx_r - gx_g) ** 2) + torch.mean((gy_r - gy_g) ** 2)
    lap_loss = torch.mean((_conv2d_same(rendered_gray, "laplacian") - _conv2d_same(gt_gray, "laplacian")) ** 2)
    return clip(0.7 * grad_loss + 0.3 * lap_loss, 0.0, 1.0)


def _fft_freq_loss(rendered_gray: torch.Tensor, gt_gray: torch.Tensor, freq_bands: int = 4) -> torch.Tensor:
    _, logm_r, ph_r, be_r = _fft_features(rendered_gray, freq_bands)
    _, logm_g, ph_g, be_g = _fft_features(gt_gray, freq_bands)
    mag_loss = clip(torch.mean((logm_r - logm_g) ** 2), 0.0, 10.0)
    phase_diff = abs_(ph_r - ph_g)
    phase_diff = torch.minimum(phase_diff, 2 * math.pi - phase_diff)
    phase_loss = clip(torch.mean(phase_diff), 0.0, math.pi)
    band_loss = clip(torch.mean((be_r - be_g) ** 2), 0.0, 100.0)
    return clip(0.6 * mag_loss + 0.2 * phase_loss + 0.2 * band_loss, 0.0, 10.0)


def high_frequency_mask(gt: torch.Tensor, thresh: float = 0.2) -> torch.Tensor:
    """(3, H, W) ground truth → (H, W) float 0/1 high-frequency mask."""
    gray = torch.mean(gt, dim=0)
    gx = _conv2d_same(gray, "sobel_x")
    gy = _conv2d_same(gray, "sobel_y")
    grad_mag = torch.sqrt(gx * gx + gy * gy + 1e-8)
    lap = torch.abs(_conv2d_same(gray, "laplacian"))
    spatial_score = 0.6 * grad_mag + 0.4 * lap

    Fq = torch.fft.fftshift(torch.fft.fft2(gray))
    distance, rmax = _radial_distance(*gray.shape, gray.device)
    hp = torch.where(distance > 0.3 * rmax, Fq, torch.zeros_like(Fq))
    hf_spatial = torch.abs(torch.fft.ifft2(torch.fft.ifftshift(hp)))
    hf_spatial = hf_spatial / maximum(hf_spatial.max(), 1e-8)

    combined = clip(0.7 * spatial_score + 0.3 * hf_spatial, 0.0, 5.0)
    lo, hi = combined.min(), combined.max()
    combined = torch.where(hi - lo > 1e-6, (combined - lo) / maximum(hi - lo, 1e-6),
                           torch.zeros_like(combined))
    return (combined > thresh).to(torch.float32)


def scale_regularization(scales: torch.Tensor, visible: torch.Tensor, scale_threshold: float = 0.01) -> torch.Tensor:
    """Mean squared excess of the max scale over `scale_threshold` among
    visible gaussians, clipped to [0, 0.01]."""
    max_scale = torch.amax(scales, dim=-1)
    over = visible & (max_scale > scale_threshold)
    excess = torch.where(over, max_scale - scale_threshold, torch.zeros_like(max_scale))
    loss = torch.sum(excess**2) / torch.clamp(over.sum(), min=1)
    return clip(loss, 0.0, 0.01)


def frequency_pyramid_loss(rendered: torch.Tensor, gt: torch.Tensor, num_levels: int = 3,
                           freq_bands: int = 4) -> torch.Tensor:
    """Pyramid frequency loss (compute_true_frequency_loss)."""
    weights = [0.1, 0.05, 0.025][:num_levels]
    total = torch.zeros((), dtype=torch.float32, device=rendered.device)
    r, g = rendered, gt
    for lvl in range(num_levels):
        r_gray = torch.mean(r, dim=0)
        g_gray = torch.mean(g, dim=0)
        spatial = _spatial_freq_loss(r_gray, g_gray)
        fft = _fft_freq_loss(r_gray, g_gray, freq_bands)
        total = total + weights[lvl] * clip(0.7 * spatial + 0.3 * fft, 0.0, 0.1)
        if lvl + 1 < num_levels:
            r = _avg_pool2(r)
            g = _avg_pool2(g)
    return clip(total, 0.0, 0.1)


# frozen copy: save_debug_panel (the trainer's PNG panel) removed


def frequency_regularization(
    rendered: torch.Tensor,
    gt: torch.Tensor,
    scales: torch.Tensor,
    visible: torch.Tensor,
    iteration,
    lambda_freq: float = 0.001,
    lambda_scale: float = 0.005,
    num_levels: int = 3,
    high_freq_thresh: float = 0.2,
    warmup_iterations: int = 1000,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Entry point (frequency_regularization_pyramid_scale). `iteration` is
    an int or a 0-d tensor. Returns (loss, high_freq_mask, debug_info)."""
    freq = frequency_pyramid_loss(rendered, gt, num_levels=num_levels)
    mask = high_frequency_mask(gt, thresh=high_freq_thresh)
    s_reg = scale_regularization(scales, visible)
    s_reg = torch.where(mask.sum() > 0, s_reg, torch.zeros_like(s_reg))
    total = clip(lambda_freq * freq + lambda_scale * s_reg, 0.0, 1.0)
    warm = torch.as_tensor(iteration, device=total.device) < warmup_iterations
    total = torch.where(warm, torch.zeros_like(total), total)
    debug = {
        "freq_loss": freq,
        "scale_loss": s_reg,
        "high_freq_ratio": mask.mean(),
        "total_loss": total,
    }
    return total, mask, debug
