"""One training iteration on one view, and the host-side schedule.

Port of hidegs_tpu/train/loop.py. A step is

  render → photometric (1-λ)·L1 + λ·(1-SSIM) → depth L1 (when the view has
  a depth prior) → frequency and scale regularization → single-view normal
  consistency → [multi-view NCC / geometric terms] → backward (the blend's
  through its CUDA kernels) → masked sparse Adam → densification
  statistics;

densify / prune, opacity reset and the SH warm-up run from the host loop
(`maybe_host_side_schedule`). The step reads nothing back to the host: the
finite-step gate, the budget counters and the metrics stay tensors on the
device, and the step's constants are fills or are cached per device.

A batch with a multi-view part and no source depth renders the source view
inside the loss, so the step runs two blends forward and backward in one
graph. Its pixel samples come from `TrainState.mv_generator`, a generator
on the state's device: `train_step` draws from a copy of it and returns the
advanced copy in the new state, so the input state is left as it was (the
JAX step splits `ts.rng` the same way).

Weight schedules follow the reference's OptimizationParams: depth 1.0 →
0.01 from iteration 7000; the single-view and multi-view terms from 7000;
densify every 300 in [500, 15000]; opacity reset every 3000; one more SH
band every 1000.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from hidegs_tpu_torch.core.camera_math import CameraParams
from hidegs_tpu_torch.model.adam import AdamState, init_adam, masked_adam_update, reset_opacity_moments
from hidegs_tpu_torch.model.densify import (
    DensifyConfig,
    add_densification_stats,
    densify_and_prune,
    scrub_nonfinite,
)
from hidegs_tpu_torch.model.gaussians import GaussianParams, GaussianState, oneup_sh_degree, reset_opacity
from hidegs_tpu_torch.model.schedules import LRConfig, expon_lr, lr_tree
from hidegs_tpu_torch.raster.api import RasterConfig, render
from hidegs_tpu_torch.train.frequency import frequency_regularization
from hidegs_tpu_torch.train.geometric import (
    MultiViewBatch,
    multi_view_losses,
    sample_pixels,
    single_view_normal_loss,
)
from hidegs_tpu_torch.train.losses import abs_, clip, dssim_l1, maximum


@dataclass(frozen=True)
class TrainConfig:
    """The reference's OptimizationParams plus raster settings (the JAX
    package's TrainConfig)."""

    iterations: int = 30_000
    lambda_dssim: float = 0.2
    lr: LRConfig = field(default_factory=LRConfig)
    # depth supervision
    depth_l1_weight_init: float = 1.0
    depth_l1_weight_final: float = 0.01
    depth_schedule_from: int = 7_000
    # single-view normal consistency
    single_view_weight: float = 0.015
    single_view_from: int = 7_000
    # multi-view consistency
    multi_view_ncc_weight: float = 0.15
    multi_view_geo_weight: float = 0.03
    multi_view_from: int = 7_000
    multi_view_sample_num: int = 4096
    multi_view_patch_half: int = 1
    multi_view_pixel_noise_th: float = 1.0
    # False (default): render the source view inside the loss and
    # backpropagate through both views (the PGSR recipe); True: the trainer
    # passes a detached source depth
    multi_view_detached_src: bool = False
    # frequency regularization
    lambda_freq: float = 0.001
    lambda_scale: float = 0.005
    freq_warmup: int = 1_000
    # densification
    densify_from: int = 500
    densify_until: int = 15_000
    densify_interval: int = 300
    opacity_reset_interval: int = 3_000
    # no opacity resets after this iteration (0 = no backoff)
    opacity_reset_until: int = 0
    densify: DensifyConfig = field(default_factory=DensifyConfig)
    sh_increase_interval: int = 1_000
    # chunk-AABB render cull ((minx, miny, minz), (maxx, maxy, maxz)) or
    # None; protected rows (skybox / scaffold) are exempt
    chunk_box: Optional[tuple] = None
    raster: RasterConfig = field(default_factory=RasterConfig)


class TrainState(NamedTuple):
    gaussians: GaussianState
    opt: AdamState
    exposure: torch.Tensor  # (num_images, 3, 4) per-image exposure matrices
    exposure_m: torch.Tensor
    exposure_v: torch.Tensor
    step: torch.Tensor  # () int32, on the device
    generator: torch.Generator  # CPU generator of the densify draws
    mv_generator: torch.Generator  # generator of the multi-view pixel draws, on the state's device
    rows_split: int = 1  # model ranks the row fields are split over (parallel.sharded.shard_rows)


class ViewBatch(NamedTuple):
    """One training view. Optional members are None when the scene has no
    such data."""

    cam: CameraParams
    image: torch.Tensor  # (3, H, W) ground truth
    image_idx: torch.Tensor  # () int64, exposure index
    invdepth: Optional[torch.Tensor] = None  # (H, W) monodepth inverse depth
    depth_mask: Optional[torch.Tensor] = None  # (H, W) reliability mask
    alpha_mask: Optional[torch.Tensor] = None  # (H, W)
    multi_view: Optional[MultiViewBatch] = None


def init_train_state(gaussians: GaussianState, num_images: int, seed: int = 0) -> TrainState:
    dev = gaussians.alive.device
    eye34 = torch.zeros((3, 4), dtype=torch.float32, device=dev)
    eye34[:, :3] = torch.eye(3, device=dev)
    exposure = eye34[None].repeat(max(num_images, 1), 1, 1)
    return TrainState(
        gaussians=gaussians,
        opt=init_adam(gaussians.params),
        exposure=exposure,
        exposure_m=torch.zeros_like(exposure),
        exposure_v=torch.zeros_like(exposure),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        generator=torch.Generator().manual_seed(seed),
        mv_generator=torch.Generator(device=dev).manual_seed(seed),
    )


def apply_exposure(image: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """(3, H, W), (3, 4) → exposure-corrected image."""
    return torch.einsum("ij,jhw->ihw", M[:, :3], image) + M[:, 3, None, None]


def depth_l1_weight(step, cfg: TrainConfig) -> torch.Tensor:
    dev = step.device if isinstance(step, torch.Tensor) else None
    t = clip(
        (torch.as_tensor(step, dtype=torch.float32, device=dev) - cfg.depth_schedule_from)
        / max(cfg.iterations - cfg.depth_schedule_from, 1),
        0.0, 1.0,
    )
    f32 = dict(dtype=torch.float32, device=dev)
    return torch.exp(torch.log(torch.full((), cfg.depth_l1_weight_init, **f32)) * (1 - t)
                     + torch.log(torch.full((), cfg.depth_l1_weight_final, **f32)) * t)


@functools.lru_cache(maxsize=16)
def chunk_box_tensors(chunk_box: tuple, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(boxmin, boxmax) of `TrainConfig.chunk_box` on `device`, built once
    per box and device, from fills: a copy from the host would make the
    host wait for the device."""
    return tuple(torch.stack([torch.full((), float(v), dtype=torch.float32, device=device) for v in corner])
                 for corner in chunk_box)


def fork_generator(generator: torch.Generator) -> torch.Generator:
    """A new generator on the same device in the same state."""
    out = torch.Generator(device=generator.device)
    out.set_state(generator.get_state())
    return out


def draw_step_pixels(ts: TrainState, batch: ViewBatch, cfg: TrainConfig):
    """The multi-view pixel samples of one step, drawn on the device from a
    copy of `ts.mv_generator`: (uv, the advanced copy)."""
    gen = fork_generator(ts.mv_generator)
    uv = sample_pixels(gen, cfg.multi_view_sample_num, batch.cam.height, batch.cam.width,
                       cfg.multi_view_patch_half)
    return uv, gen


def compute_losses(
    gaussians: GaussianState,
    exposure: torch.Tensor,
    batch: ViewBatch,
    step,
    cfg: TrainConfig,
    mean2d_offset: torch.Tensor,
    use_exposure: bool,
    uv: Optional[torch.Tensor] = None,
    scale_rows: Optional[torch.Tensor] = None,
):
    """The loss stack. Returns (total, aux dict of tensors). `uv`: the
    multi-view pixel samples (`sample_pixels`), needed when the batch has a
    multi-view part. `scale_rows`: the (C, 3) scales the scale
    regularization reads, row for row with the render's visibility; by
    default `gaussians.scales`. A gaussian-sharded step whose render gathers
    the preprocessed rows (parallel/sharded.py) passes the gathered scales."""
    render_geo = cfg.single_view_weight > 0 or batch.multi_view is not None
    box_kw = {}
    if cfg.chunk_box is not None:
        boxmin, boxmax = chunk_box_tensors(cfg.chunk_box, gaussians.alive.device)
        box_kw = dict(boxmin=boxmin, boxmax=boxmax, box_exempt=gaussians.protected)
    out = render(
        gaussians.params.xyz,
        gaussians.scales,
        gaussians.quats,
        gaussians.opacities,
        gaussians.shs_flat,
        batch.cam,
        active_sh_degree=gaussians.active_sh_degree,
        render_geo=render_geo,
        config=cfg.raster,
        mean2d_offset=mean2d_offset,
        **box_kw,
    )
    img = out["render"]
    if use_exposure:
        img = apply_exposure(img, exposure[batch.image_idx])
    # background pixels render as exactly 0: clip's tie gradient matters
    img = clip(img, 0.0, 1.0)

    aux: Dict[str, torch.Tensor] = {}
    gt = batch.image
    if batch.alpha_mask is not None:
        img = img * batch.alpha_mask[None]
        gt = gt * batch.alpha_mask[None]
    photo = dssim_l1(img, gt, cfg.lambda_dssim)
    aux["photo"] = photo
    total = photo

    if batch.invdepth is not None:
        mask = batch.depth_mask if batch.depth_mask is not None else torch.ones_like(batch.invdepth)
        dl1 = torch.sum(abs_(out["invdepth"] - batch.invdepth) * mask) / maximum(mask.sum(), 1.0)
        total = total + depth_l1_weight(step, cfg) * dl1
        aux["depth_l1"] = dl1

    if cfg.lambda_freq > 0 or cfg.lambda_scale > 0:
        freq_loss, _, _ = frequency_regularization(
            img, gt, gaussians.scales if scale_rows is None else scale_rows, out["visibility"], step,
            lambda_freq=cfg.lambda_freq, lambda_scale=cfg.lambda_scale,
            warmup_iterations=cfg.freq_warmup,
        )
        total = total + freq_loss
        aux["freq"] = freq_loss

    if cfg.single_view_weight > 0:
        sv = single_view_normal_loss(out["rendered_normal"], out["depth_normal"], gt, out["alpha"])
        on = torch.as_tensor(step, device=sv.device) >= cfg.single_view_from
        total = total + torch.where(on, cfg.single_view_weight, 0.0) * sv
        aux["single_view"] = sv

    src_out = None
    if batch.multi_view is not None:
        if uv is None:
            raise ValueError("a batch with a multi-view part needs its pixel samples `uv` (sample_pixels)")
        mvb = batch.multi_view
        if mvb.src_plane_depth is None:
            # the differentiable source: render the source view here, so
            # that both views' geometry takes the multi-view gradient
            src_out = render(
                gaussians.params.xyz,
                gaussians.scales,
                gaussians.quats,
                gaussians.opacities,
                gaussians.shs_flat,
                mvb.src_cam,
                active_sh_degree=gaussians.active_sh_degree,
                render_geo=True,
                config=cfg.raster,
                **box_kw,
            )
            mvb = mvb._replace(src_plane_depth=src_out["plane_depth"])
        ncc_l, geo_l = multi_view_losses(
            out["plane_depth"], out["rendered_normal"], torch.mean(batch.image, dim=0), batch.cam, mvb, uv,
            patch_half=cfg.multi_view_patch_half, pixel_noise_th=cfg.multi_view_pixel_noise_th,
        )
        on = torch.as_tensor(step, device=ncc_l.device) >= cfg.multi_view_from
        total = total + torch.where(on, 1.0, 0.0) * (
            cfg.multi_view_ncc_weight * ncc_l + cfg.multi_view_geo_weight * geo_l)
        aux["mv_ncc"] = ncc_l
        aux["mv_geo"] = geo_l

    aux["total"] = total
    aux["visibility"] = out["visibility"]
    aux["radii"] = out["radii"]
    # the budget counters feed the trainer's grow / shrink loop: the source
    # render's demand counts too, or an overflow there would go unseen
    for key in ("overflow", "block_overflow", "visible_overflow"):
        aux[key] = out[key] if src_out is None else out[key] + src_out[key]
    for key in ("num_instances", "needed_blocks", "num_visible"):
        aux[key] = out[key] if src_out is None else torch.maximum(out[key], src_out[key])
    return total, aux


_ROW_FIELDS = ("alive", "grad_max", "grad_abs_max", "max_radii2d", "protected")


def _slice_rows(ts: TrainState, R: int) -> TrainState:
    """The first R rows of every per-gaussian buffer. Valid when the alive
    rows occupy the prefix [0, R) (compact_gaussians keeps that)."""
    g = ts.gaussians
    slp = lambda p: GaussianParams(*(x[:R] for x in p))  # noqa: E731
    return ts._replace(
        gaussians=g._replace(params=slp(g.params), **{f: getattr(g, f)[:R] for f in _ROW_FIELDS}),
        opt=AdamState(m=slp(ts.opt.m), v=slp(ts.opt.v), step=ts.opt.step[:R]),
    )


def _unslice_rows(full: TrainState, view: TrainState) -> TrainState:
    """The view's updated prefix rows over the full buffers' tail rows; the
    state-level fields come from the view."""
    R = view.gaussians.capacity

    def wb(f, v):
        return torch.cat([v, f[R:]], dim=0)

    def wbp(fp, vp):
        return GaussianParams(*(wb(f, v) for f, v in zip(fp, vp)))

    fg, vg = full.gaussians, view.gaussians
    return view._replace(
        gaussians=vg._replace(params=wbp(fg.params, vg.params),
                              **{f: wb(getattr(fg, f), getattr(vg, f)) for f in _ROW_FIELDS}),
        opt=AdamState(m=wbp(full.opt.m, view.opt.m), v=wbp(full.opt.v, view.opt.v),
                      step=wb(full.opt.step, view.opt.step)),
    )


def step_forward(ts: TrainState, batch: ViewBatch, cfg: TrainConfig, use_exposure: bool = False,
                 uv: Optional[torch.Tensor] = None):
    """The forward half of a step: the loss stack on fresh leaves that
    require grad. Returns (loss, aux, inputs); `inputs` are the params'
    leaves, the mean2d offset and, with `use_exposure`, the exposure. `uv`:
    the multi-view pixel samples (draw_step_pixels)."""
    C = ts.gaussians.capacity
    dev = ts.gaussians.alive.device
    params = GaussianParams(*(p.detach().requires_grad_(True) for p in ts.gaussians.params))
    exposure = ts.exposure.detach().requires_grad_(use_exposure)
    # its gradient is dL/d(mean2d), the screen-space gradient of densification
    mean2d_offset = torch.zeros((C, 2), dtype=torch.float32, device=dev, requires_grad=True)
    loss, aux = compute_losses(ts.gaussians._replace(params=params), exposure, batch, ts.step,
                               cfg, mean2d_offset, use_exposure, uv=uv)
    inputs = list(params) + [mean2d_offset] + ([exposure] if use_exposure else [])
    return loss, aux, inputs


def step_backward(loss: torch.Tensor, inputs):
    """Gradients of `loss` for each of `inputs`, zeros where unused."""
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]


def step_update(
    ts: TrainState,
    batch: ViewBatch,
    cfg: TrainConfig,
    loss: torch.Tensor,
    aux: Dict[str, torch.Tensor],
    grads,
    use_exposure: bool = False,
):
    """The update half of a step, from `step_backward`'s gradients: the
    finite-step gate, masked sparse Adam, the densification statistics and
    the exposure Adam. Returns (new state, dict of 0-d metric tensors)."""
    n_params = len(GaussianParams._fields)
    param_grads = GaussianParams(*grads[:n_params])
    screen_grads = grads[n_params]

    # Finite-step gate: one non-finite pixel poisons the gradient of every
    # visible gaussian, and the masked Adam would write NaN into all of
    # them. Such a step is skipped whole; `step_ok` stays on the device.
    step_ok = torch.isfinite(loss)
    for g in param_grads:
        step_ok = step_ok & torch.isfinite(torch.sum(g))
    aux["step_ok"] = step_ok.to(torch.float32)

    visible = aux["visibility"] & step_ok
    lrs = lr_tree(ts.step, cfg.lr, ts.gaussians.spatial_lr_scale)
    new_params, new_opt = masked_adam_update(ts.gaussians.params, param_grads, ts.opt, lrs, visible)

    # the reference's screen-space gradient units: its CUDA backward scales
    # dL/dmean2D by (0.5·W, 0.5·H), and densify's grad_threshold is set for them
    screen_grads = torch.stack([screen_grads[:, 0] * (0.5 * batch.cam.width),
                                screen_grads[:, 1] * (0.5 * batch.cam.height)], dim=1)
    g_state = add_densification_stats(ts.gaussians._replace(params=new_params),
                                      screen_grads, visible, aux["radii"])

    if use_exposure:
        # exposure Adam (dense, tiny), the reference's exposure_optimizer
        expo_grads = grads[-1]
        b1, b2, eps = 0.9, 0.999, 1e-8
        t = torch.clamp(ts.step + 1, min=1).to(torch.float32)
        m = b1 * ts.exposure_m + (1 - b1) * expo_grads
        v = b2 * ts.exposure_v + (1 - b2) * expo_grads**2
        lr_e = expon_lr(ts.step, cfg.lr.exposure_lr_init, cfg.lr.exposure_lr_final, cfg.iterations)
        new_expo = ts.exposure - lr_e * (m / (1 - b1**t)) / (torch.sqrt(v / (1 - b2**t)) + eps)
        m = torch.where(step_ok, m, ts.exposure_m)
        v = torch.where(step_ok, v, ts.exposure_v)
        new_expo = torch.where(step_ok, new_expo, ts.exposure)
    else:
        m, v, new_expo = ts.exposure_m, ts.exposure_v, ts.exposure

    new_ts = TrainState(
        gaussians=g_state, opt=new_opt, exposure=new_expo.detach(), exposure_m=m.detach(),
        exposure_v=v.detach(), step=ts.step + 1, generator=ts.generator, mv_generator=ts.mv_generator,
    )
    metrics = {k: val.detach() for k, val in aux.items() if val.ndim == 0}
    return new_ts, metrics


def train_step(
    ts: TrainState,
    batch: ViewBatch,
    cfg: TrainConfig,
    use_exposure: bool = False,
    row_budget: int = 0,
    uv: Optional[torch.Tensor] = None,
):
    """One iteration (render → loss → gradients → sparse Adam → stats):
    `step_forward`, `step_backward`, `step_update`. Returns (new state, dict
    of 0-d metric tensors). The input state is left as it was.

    `row_budget`: with 0 < R < capacity the step runs on the rows [0, R)
    only, so every per-gaussian stage scales with the live count; it needs
    the alive-prefix layout of compact_gaussians. `uv`: the multi-view
    pixel samples; by default a multi-view batch draws them
    (draw_step_pixels) and the new state carries the advanced generator."""
    mv_generator = ts.mv_generator
    if batch.multi_view is not None and uv is None:
        uv, mv_generator = draw_step_pixels(ts, batch, cfg)
    full_ts = None
    if 0 < row_budget < ts.gaussians.capacity:
        full_ts = ts
        ts = _slice_rows(ts, row_budget)
    loss, aux, inputs = step_forward(ts, batch, cfg, use_exposure, uv=uv)
    grads = step_backward(loss, inputs)
    new_ts, metrics = step_update(ts, batch, cfg, loss, aux, grads, use_exposure)
    if full_ts is not None:
        new_ts = _unslice_rows(full_ts, new_ts)
    return new_ts._replace(mv_generator=mv_generator), metrics


def densify_step(ts: TrainState, scene_extent, cfg: TrainConfig):
    g, opt, info = densify_and_prune(ts.gaussians, ts.opt, scene_extent, cfg.densify, ts.generator)
    return ts._replace(gaussians=g, opt=opt), info


def maybe_host_side_schedule(ts: TrainState, cfg: TrainConfig, scene_extent: float, step: int = None):
    """Densify / opacity reset / SH warm-up, called once per iteration with
    the post-increment step as a Python int. Pass `step` when the host loop
    knows it: reading `int(ts.step)` waits for the device every iteration."""
    step = int(ts.step) if step is None else step
    info = None
    if step % cfg.sh_increase_interval == 0:
        ts = ts._replace(gaussians=oneup_sh_degree(ts.gaussians))
    if step > cfg.densify_until and step % cfg.densify_interval == 0:
        # rows can still diverge after the densify window: keep scrubbing
        g, _ = scrub_nonfinite(ts.gaussians)
        ts = ts._replace(gaussians=g)
    if cfg.densify_from <= step <= cfg.densify_until:
        if step % cfg.densify_interval == 0:
            ts, info = densify_step(ts, scene_extent, cfg)
        if step % cfg.opacity_reset_interval == 0 and (
            cfg.opacity_reset_until <= 0 or step <= cfg.opacity_reset_until
        ):
            ts = ts._replace(gaussians=reset_opacity(ts.gaussians), opt=reset_opacity_moments(ts.opt))
    return ts, info
