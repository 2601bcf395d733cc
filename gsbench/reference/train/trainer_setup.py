# Frozen copies, at commit 63641d3, of the set-up that hidegs_tpu_torch/train/trainer.py
# does before its first step: train_config_from_opt (trainer.py:77-123), the capacity rule
# (trainer.py:402-406), ROW_BUDGET_SLACK and fit_row_budget (trainer.py:176, 189-192).
"""The trainer's set-up, worked out again by the reference."""
from __future__ import annotations

import numpy as np

from gsbench.reference.config import OptimizationConfig, PipelineConfig, port_backend
from gsbench.reference.model.densify import DensifyConfig
from gsbench.reference.model.schedules import LRConfig
from gsbench.reference.raster.api import RasterConfig, suggest_max_instances
from gsbench.reference.train.loop import TrainConfig

ROW_BUDGET_SLACK = 0.05


def train_config_from_opt(opt: OptimizationConfig, pipe: PipelineConfig, n_init: int) -> TrainConfig:
    max_inst = pipe.max_instances or suggest_max_instances(n_init)
    return TrainConfig(
        iterations=opt.iterations,
        lambda_dssim=opt.lambda_dssim,
        lr=LRConfig(
            position_lr_init=opt.position_lr_init,
            position_lr_final=opt.position_lr_final,
            position_lr_delay_mult=opt.position_lr_delay_mult,
            position_lr_max_steps=opt.position_lr_max_steps,
            feature_lr=opt.feature_lr,
            opacity_lr=opt.opacity_lr,
            scaling_lr=opt.scaling_lr,
            rotation_lr=opt.rotation_lr,
            exposure_lr_init=opt.exposure_lr_init,
            exposure_lr_final=opt.exposure_lr_final,
        ),
        depth_l1_weight_init=opt.depth_l1_weight_init,
        depth_l1_weight_final=opt.depth_l1_weight_final,
        depth_schedule_from=opt.depth_from_iter,
        single_view_weight=opt.single_view_weight,
        single_view_from=opt.single_view_weight_from_iter,
        multi_view_ncc_weight=opt.multi_view_ncc_weight,
        multi_view_geo_weight=opt.multi_view_geo_weight,
        multi_view_from=opt.multi_view_weight_from_iter,
        multi_view_sample_num=min(opt.multi_view_sample_num, 16384),
        multi_view_patch_half=max(opt.multi_view_patch_size // 2, 1),
        multi_view_pixel_noise_th=opt.multi_view_pixel_noise_th,
        lambda_freq=opt.lambda_freq,
        lambda_scale=opt.lambda_scale,
        freq_warmup=opt.freq_warmup_iterations,
        densify_from=opt.densify_from_iter,
        densify_until=opt.densify_until_iter,
        densify_interval=opt.densification_interval,
        opacity_reset_interval=opt.opacity_reset_interval,
        opacity_reset_until=opt.opacity_reset_until_iter,
        densify=DensifyConfig(
            grad_threshold=opt.densify_grad_threshold,
            abs_grad_threshold=opt.densify_abs_grad_threshold,
            min_opacity=opt.min_opacity,
            percent_dense=opt.percent_dense,
            max_growth_frac=opt.densify_max_growth,
        ),
        raster=RasterConfig(backend=port_backend(pipe.raster_backend), max_instances=max_inst,
                            antialias=pipe.antialiasing, tile=pipe.tile,
                            depth_sort_bits=pipe.depth_sort_bits),
    )


def capacity_for(n_init: int, opt_cfg: OptimizationConfig) -> int:
    """The state's capacity for n_init initial points, no scaffold."""
    n_scaffold = 0
    return min(
        max(1 << int(np.ceil(np.log2(max(4 * n_init + n_scaffold, 1 << 14)))), 1 << 14),
        opt_cfg.max_all_points,
    )


def fit_row_budget(n_alive: int, capacity: int) -> int:
    """Octave-rounded active-row budget for the sliced train step."""
    want = max(int(n_alive * (1.0 + ROW_BUDGET_SLACK)), 1 << 12)
    return min(1 << (want - 1).bit_length(), capacity)
