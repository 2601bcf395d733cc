# Frozen copy of hidegs_tpu_torch/config.py:1-204 at commit 63641d3, the benchmark's plain
# reference: the flag dataclasses whose defaults the reference's train step is built from.
"""Config / flag system.

The port's own copy of hidegs_tpu/config.py (no JAX in it): the
reflection-based ParamGroup argparse setup of the reference
(arguments/__init__.py:16-159). Dataclass fields become CLI flags, a
`cfg_args.json` snapshot is written next to checkpoints, and
`get_combined_args` merges it back on eval. Field names and defaults are the
JAX package's, so a snapshot written by either package reads the same in
the other. `raster_backend` keeps the JAX package's values; `port_backend`
maps them to this port's RasterConfig backends.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, fields
from typing import Optional


@dataclass
class ModelConfig:
    """ModelParams (arguments/__init__.py:47-79)."""

    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    depths: str = ""
    masks: str = ""
    resolution: int = -1
    sh_degree: int = 3
    white_background: bool = False
    eval: bool = False
    hierarchy: str = ""  # path to .hier to load
    pretrained: str = ""  # pretrained point cloud dir
    skybox_num: int = 0
    scaffold_file: str = ""
    # multi-view graph (arguments/__init__.py:72-79)
    multi_view_num: int = 8
    multi_view_max_angle: float = 30.0
    multi_view_min_dis: float = 0.01
    multi_view_max_dis: float = 1.5
    # host-RAM policy for decoded training images: "always" caches every view
    # in memory, "never" decodes lazily per step (CameraDataset's lazy path,
    # camera_utils.py:122-144), "auto" caches only when the estimated decoded
    # footprint fits comfortably in available RAM
    cache_images: str = "auto"


@dataclass
class PipelineConfig:
    """PipelineParams (arguments/__init__.py:81-86) + TPU raster knobs."""

    antialiasing: bool = True
    raster_backend: str = "jnp"  # "jnp" | "pallas" | "oracle"
    # -1 = auto-quantized single-key (tile|depth) sort: faster, reorders only
    # near-equal depths; 0 = exact lexicographic sort (reference order)
    depth_sort_bits: int = -1
    # raster tile side in pixels. The reference hardcodes 16 (config.h:16-17);
    # on TPU bigger tiles cut Pallas grid steps and instance duplication —
    # 32 wins ~20%+ fwd+bwd on the config-1 workload with identical output
    # (benchmarks/tile_sweep.py, docs/BENCHMARKS.md)
    tile: int = 32
    max_instances: int = 1 << 21
    capacity: int = 0  # gaussian buffer capacity; 0 → auto from init size
    # frequency-regularization debug panels, dumped every N iters to
    # <model_path>/freq_debug/ (reference save_visualizations cadence,
    # scripts/frequency_regularization.py:1446-1577; 0 disables)
    debug_panel_every: int = 0
    # per-chunk training: cull gaussians outside the chunk's AABB (read from
    # <source_path>/center.txt + extent.txt) during rasterization, matching
    # the reference's boxmin/boxmax cull (forward.cu:319-321) so out-of-cell
    # scaffold/padding gaussians cannot soak up gradient. Skybox/scaffold
    # (protected) rows are exempt.
    chunk_box_cull: bool = False
    # visible-row compaction (raster/preprocess.compact_visible): the trainer
    # observes per-view visible-row demand and packs the visible rows into a
    # fitted buffer before binning, shrinking every N-row stream. Bit-exact;
    # off switch kept for debugging/bisection.
    visible_compaction: bool = True


@dataclass
class OptimizationConfig:
    """OptimizationParams (arguments/__init__.py:88-137)."""

    iterations: int = 30_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 5e-2
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    exposure_lr_init: float = 1e-3
    exposure_lr_final: float = 1e-4
    percent_dense: float = 1e-4
    lambda_dssim: float = 0.2
    densification_interval: int = 300
    opacity_reset_interval: int = 3_000
    # reset backoff (r4 candid analysis: post-reset recovery is incomplete
    # at low view counts — the analytic run's opacity median sat at the
    # reset clamp at iteration 15000): no opacity resets AFTER this
    # iteration. 0 = no backoff (reference behavior: resets run through the
    # whole densify window).
    opacity_reset_until_iter: int = 0
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.015
    densify_abs_grad_threshold: float = 0.0008
    # per-round growth cap as a fraction of the alive count, top-score-first
    # (0 = reference behavior; see model/densify.DensifyConfig.max_growth_frac)
    densify_max_growth: float = 0.0
    min_opacity: float = 0.005
    max_all_points: int = 6_000_000
    # depth supervision (arguments/__init__.py:113-116)
    depth_l1_weight_init: float = 1.0
    depth_l1_weight_final: float = 0.01
    depth_from_iter: int = 7_000
    # geometry (arguments/__init__.py:118-135)
    single_view_weight: float = 0.015
    single_view_weight_from_iter: int = 7_000
    multi_view_ncc_weight: float = 0.15
    multi_view_geo_weight: float = 0.03
    multi_view_weight_from_iter: int = 7_000
    multi_view_patch_size: int = 3
    multi_view_sample_num: int = 102_400
    multi_view_pixel_noise_th: float = 1.0
    # frequency regularization (scripts/frequency_regularization.py:1579-1595)
    lambda_freq: float = 0.001
    lambda_scale: float = 0.005
    freq_warmup_iterations: int = 1_000
    # exposure
    use_exposure: bool = False


# raster_backend of a snapshot → this port's backend. "jnp" and "pallas"
# compute the blend that the port's "blend" backend computes (its CUDA
# kernel on the card, the plain version on the CPU).
_PORT_BACKENDS = {"jnp": "blend", "pallas": "blend", "oracle": "oracle"}


def port_backend(raster_backend: str) -> str:
    """The port's RasterConfig backend for a `raster_backend` value."""
    if raster_backend not in _PORT_BACKENDS:
        raise ValueError(f"unknown raster_backend {raster_backend!r}; expected one of {sorted(_PORT_BACKENDS)}")
    return _PORT_BACKENDS[raster_backend]


def add_group(parser: argparse.ArgumentParser, cfg, prefix: str = ""):
    """Reflect dataclass fields into argparse flags (ParamGroup:19-45)."""
    for f in fields(cfg):
        name = f"--{prefix}{f.name}"
        default = getattr(cfg, f.name)
        if f.type in (bool, "bool") or isinstance(default, bool):
            parser.add_argument(name, action="store_true" if not default else "store_false", default=default)
        else:
            parser.add_argument(name, type=type(default), default=default)


def extract_group(args: argparse.Namespace, cls, prefix: str = ""):
    kwargs = {}
    for f in fields(cls):
        key = f"{prefix}{f.name}"
        if hasattr(args, key):
            kwargs[f.name] = getattr(args, key)
    return cls(**kwargs)


def save_cfg_args(model_path: str, model: ModelConfig, pipe: PipelineConfig, opt: OptimizationConfig):
    """cfg_args snapshot (arguments/__init__.py:144-153 writes a Namespace
    repr; we write JSON, read back by get_combined_args)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(
            {
                "model": dataclasses.asdict(model),
                "pipeline": dataclasses.asdict(pipe),
                "optimization": dataclasses.asdict(opt),
            },
            f,
            indent=1,
        )


def get_combined_args(model_path: str, cli_model: Optional[ModelConfig] = None):
    """Load the saved training config and overlay non-default CLI values
    (arguments/__init__.py:139-159)."""
    path = os.path.join(model_path, "cfg_args.json")
    with open(path) as f:
        saved = json.load(f)
    model = ModelConfig(**saved["model"])
    pipe = PipelineConfig(**saved["pipeline"])
    opt = OptimizationConfig(**saved["optimization"])
    if cli_model is not None:
        defaults = ModelConfig()
        for f in fields(ModelConfig):
            v = getattr(cli_model, f.name)
            if v != getattr(defaults, f.name):
                setattr(model, f.name, v)
    model.model_path = model_path
    return model, pipe, opt
