"""Scene-level trainer, runnable as `python -m hidegs_tpu_torch.train`.

Port of hidegs_tpu/train/trainer.py. Glue between the data layer (COLMAP
scene, neighbour graph), the model layer (gaussian state with skybox and
KNN init) and the train step: a shuffled view order, multi-view source
views, the densify / opacity-reset / SH schedules, budget re-fitting,
checkpoints and metric logging.

    python -m hidegs_tpu_torch.train --source_path <scene> --model_path <out> [--device cuda]

Everything runs on `--device` (default cuda, which raises without a card).
On a card each iteration is one replay of the train step captured as a CUDA
graph (train/compiled.py, the JAX trainer's jitted, donated step); on the
CPU it is the eager `train_step`. On the host's cadence the densify
round and the scrub replay their own graphs on a card
(train/compiled.py:CompiledDensify), the opacity reset and the SH warm-up
run eagerly; each hands the next step a new state, which it copies into
its buffers once.
The flags are the JAX trainer's; `raster_backend` "jnp" and "pallas" train
with the port's "blend" backend (config.port_backend). The model directory
is the JAX trainer's layout, so `hidegs_tpu_torch.evaluate` and
`hidegs_tpu.evaluate` both read it, and a JAX run's checkpoints resume here.

The host reads the device in windows: the budget counters of
OVERFLOW_CHECK_EVERY steps are fetched in one copy, and the loss only at the
log, densify and save iterations. The Pallas-only block budget of the JAX
trainer is not carried over: the port's blend needs none (max_blocks 0).

Each iteration is a `train.iteration` span (utils/profiling.py) whose
request is the iteration: inside it `train.batch` (with `cache_miss`, the
views copied to the device), `train.step`, `train.schedule` (and
`densify.round` in it), and the host's reads of the device as wait spans,
`train.read_budgets` (with `refit`, 1 when a budget grew or shrank),
`train.read_densify` and `train.read_log`.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import random
import time
from typing import Dict, Optional

import numpy as np
import torch

from hidegs_tpu_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    add_group,
    extract_group,
    port_backend,
    save_cfg_args,
)
from hidegs_tpu_torch.device import DeviceLike, resolve_device
from hidegs_tpu_torch.model.densify import DensifyConfig
from hidegs_tpu_torch.model.gaussians import (
    GaussianState,
    compact_gaussians,
    init_from_points,
    make_skybox,
    prepend_raw_points,
)
from hidegs_tpu_torch.model.knn import initial_scales
from hidegs_tpu_torch.model.schedules import LRConfig
from hidegs_tpu_torch.raster.api import RasterConfig, render, round_budget, suggest_max_instances
from hidegs_tpu_torch.train.budgets import COUNTERS, OVERFLOW_CHECK_EVERY, BudgetRefit
from hidegs_tpu_torch.train.checkpoint import save_train_state
from hidegs_tpu_torch.train.compiled import CompiledDensify, CompiledTrainStep
from hidegs_tpu_torch.train.geometric import MultiViewBatch
from hidegs_tpu_torch.train.loop import (
    TrainConfig,
    TrainState,
    ViewBatch,
    init_train_state,
    maybe_host_side_schedule,
    train_step,
)
from hidegs_tpu_torch.utils.graphs import on_card
from hidegs_tpu_torch.utils.profiling import span


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


def load_scene_scaffold(model_cfg: ModelConfig):
    """Border scaffold of a chunk scene: the annulus of a coarse or
    neighbouring model around the chunk cell, as raw parameter arrays.
    None when model_cfg.scaffold_file is empty."""
    if not model_cfg.scaffold_file:
        return None
    from hidegs_tpu_torch.utils.storage import load_scaffold

    center = np.loadtxt(os.path.join(model_cfg.source_path, "center.txt")).reshape(-1)[:3]
    extent = np.loadtxt(os.path.join(model_cfg.source_path, "extent.txt")).reshape(-1)[:3]
    return load_scaffold(model_cfg.scaffold_file, center, extent)


def init_gaussians_from_scene(scene, model_cfg: ModelConfig, capacity: int, scaffold=None,
                              device: DeviceLike = "cuda") -> GaussianState:
    """The initial state on `device`: the sparse points (plus the skybox at
    the tail, protected) with KNN scales, then the scaffold rows (protected)
    in the last dead slots."""
    dev = resolve_device(device)
    pts = np.asarray(scene.info.points, np.float32)
    cols = np.asarray(scene.info.colors, np.float32)
    protected = None
    if scaffold is None:
        scaffold = load_scene_scaffold(model_cfg)
    if model_cfg.skybox_num > 0:
        sky_pts, sky_cols = make_skybox(model_cfg.skybox_num, scene.info.nerf_norm_center,
                                        scene.info.nerf_norm_radius)
        pts = np.concatenate([pts, sky_pts])
        cols = np.concatenate([cols, sky_cols])
        protected = np.zeros(len(pts), bool)
        protected[-model_cfg.skybox_num:] = True
    points = torch.as_tensor(pts, device=dev)
    state = init_from_points(
        points,
        torch.as_tensor(cols, device=dev),
        capacity=capacity,
        spatial_lr_scale=scene.info.nerf_norm_radius,
        knn_scale=initial_scales(points),
        protected_mask=torch.as_tensor(protected, device=dev) if protected is not None else None,
    )
    if scaffold is not None:
        state = prepend_raw_points(state, scaffold, protected=True)
    return state


# active-row budget headroom: the step's row prefix is n_alive·(1 + this),
# rounded up to a power of two
ROW_BUDGET_SLACK = 0.05
# the order of the per-step counters in a window: the re-fit's, then the
# finite-step gate
_COUNTERS = COUNTERS + ("step_ok",)


def fit_row_budget(n_alive: int, capacity: int) -> int:
    """Octave-rounded active-row budget for the sliced train step."""
    want = max(int(n_alive * (1.0 + ROW_BUDGET_SLACK)), 1 << 12)
    return min(1 << (want - 1).bit_length(), capacity)


class ViewCache:
    """The training views' tensors on the device, an LRU with a byte
    budget ($HIDEGS_VIEW_CACHE_MB, default 4096, as the JAX trainer's):
    each view is copied to the device once while it stays cached (small
    scenes stay resident, large ones churn their oldest views). Views are
    keyed by image path and size, so a view decoded again (the lazy
    CameraDataset path) still hits."""

    def __init__(self, device: DeviceLike, budget_bytes: Optional[int] = None):
        self.device = resolve_device(device)
        if budget_bytes is None:
            budget_bytes = int(os.environ.get("HIDEGS_VIEW_CACHE_MB", "4096")) * (1 << 20)
        self.budget = budget_bytes
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._indices: Dict[int, torch.Tensor] = {}
        self.nbytes = 0
        self.copies = 0  # views (and gray images) copied to the device

    @staticmethod
    def _key(cam):
        return (cam.info.image_path, cam.width, cam.height)

    @staticmethod
    def _entry_nbytes(entry: dict) -> int:
        return sum(v.nbytes for v in entry.values() if isinstance(v, torch.Tensor))

    def arrays(self, cam) -> dict:
        """The view's entry: cam, image, invdepth, depth_mask, alpha_mask
        (and gray once a source view needs it)."""
        key = self._key(cam)
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            return entry
        dev = self.device
        depth_mask = invdepth = None
        if cam.invdepth is not None and cam.depth_reliable:
            # a deliberate difference from the reference's mask (alpha mask
            # or ones), kept from the JAX package: supervise only where the
            # monodepth map has a sample (invdepth > 0)
            dm = np.asarray(cam.invdepth) > 0
            if cam.alpha_mask is not None:
                dm = dm & (np.asarray(cam.alpha_mask) > 0.5)
            depth_mask = torch.as_tensor(dm, dtype=torch.float32, device=dev)
            invdepth = torch.as_tensor(cam.invdepth, device=dev)
        entry = {
            "cam": cam.cam_params(dev),
            "image": torch.as_tensor(cam.image, device=dev),
            "invdepth": invdepth,
            "depth_mask": depth_mask,
            "alpha_mask": torch.as_tensor(cam.alpha_mask, device=dev) if cam.alpha_mask is not None else None,
            "gray": None,
        }
        self._entries[key] = entry
        self.nbytes += self._entry_nbytes(entry)
        self.copies += 1
        while self.nbytes > self.budget and len(self._entries) > 1:
            _, old = self._entries.popitem(last=False)
            self.nbytes -= self._entry_nbytes(old)
        return entry

    def gray(self, cam) -> torch.Tensor:
        entry = self.arrays(cam)
        if entry["gray"] is None:
            entry["gray"] = torch.as_tensor(cam.grayscale(), device=self.device)
            self.nbytes += entry["gray"].nbytes
            self.copies += 1
        return entry["gray"]

    def image_index(self, idx: int) -> torch.Tensor:
        """The 0-d int64 exposure index `idx` on the device, built once."""
        if idx not in self._indices:
            self._indices[idx] = torch.full((), idx, dtype=torch.int64, device=self.device)
        return self._indices[idx]


def build_view_batch(cache: ViewCache, cam, idx: int, src_cam=None, src_depth=None) -> ViewBatch:
    """The train step's batch of view `cam` (index `idx`), from the view
    cache. With `src_cam`, a multi-view part: `src_depth=None` lets the
    loss render the source view itself (the differentiable source)."""
    mv = None
    if src_cam is not None:
        mv = MultiViewBatch(src_image_gray=cache.gray(src_cam), src_plane_depth=src_depth,
                            src_cam=cache.arrays(src_cam)["cam"])
    dev = cache.arrays(cam)
    return ViewBatch(
        cam=dev["cam"],
        image=dev["image"],
        image_idx=cache.image_index(idx),
        invdepth=dev["invdepth"],
        depth_mask=dev["depth_mask"],
        alpha_mask=dev["alpha_mask"],
        multi_view=mv,
    )


def render_plane_depth(ts: TrainState, cam_params, cfg: TrainConfig) -> torch.Tensor:
    """The detached plane depth of view `cam_params` (the detached-source
    multi-view option)."""
    g = ts.gaussians
    with torch.no_grad():
        out = render(g.params.xyz, g.scales, g.quats, g.opacities, g.shs_flat, cam_params,
                     active_sh_degree=g.active_sh_degree, render_geo=True, config=cfg.raster)
    return out["plane_depth"]


def save_frequency_panel(ts: TrainState, cache: ViewCache, cam, cfg: TrainConfig, model_path: str, it: int):
    """Dump the 2x2 frequency-regularization debug panel of the current view
    (render / gt / high-freq mask / gt log-FFT), the reference's
    save_visualizations hook; the view is rendered again outside the step."""
    from hidegs_tpu_torch.train.frequency import high_frequency_mask, save_debug_panel

    g = ts.gaussians
    arrays = cache.arrays(cam)
    with torch.no_grad():
        out = render(g.params.xyz, g.scales, g.quats, g.opacities, g.shs_flat, arrays["cam"],
                     active_sh_degree=g.active_sh_degree, config=cfg.raster)
        gt = arrays["image"]
        save_debug_panel(
            torch.clamp(out["render"], 0.0, 1.0), gt, high_frequency_mask(gt),
            os.path.join(model_path, "freq_debug"), it,
            camera_name=os.path.splitext(cam.info.image_name)[0] if cam.info.image_name else "",
        )


def _fetch(values) -> list:
    """The 0-d tensors `values` on the host, in one copy."""
    return torch.stack([v.to(torch.float64) for v in values]).tolist()


def train(
    model_cfg: ModelConfig,
    pipe_cfg: PipelineConfig,
    opt_cfg: OptimizationConfig,
    save_iterations=(7_000, 30_000),
    log_every: int = 100,
    scene=None,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> TrainState:
    """Full training run on `device`. Returns the final TrainState."""
    dev = resolve_device(device)
    if scene is None:
        from hidegs_tpu_torch.data.scene import load_scene

        scene = load_scene(
            model_cfg.source_path,
            images=model_cfg.images,
            depths=model_cfg.depths,
            eval_split=model_cfg.eval,
            resolution=model_cfg.resolution,
            multi_view_num=model_cfg.multi_view_num,
            multi_view_max_angle=model_cfg.multi_view_max_angle,
            multi_view_min_dis=model_cfg.multi_view_min_dis,
            multi_view_max_dis=model_cfg.multi_view_max_dis,
            cache_all=lambda info: _cache_images(model_cfg, info),
        )
    n_views = len(scene.train_cameras)
    if n_views == 0:
        raise ValueError("no training cameras")

    scaffold = load_scene_scaffold(model_cfg)
    n_scaffold = 0 if scaffold is None else len(scaffold["xyz"])
    if model_cfg.scaffold_file:
        print(f"scaffold: {n_scaffold} border rows from {model_cfg.scaffold_file}", flush=True)
    # capacity must hold the frozen scaffold rows too; scaffold rows never
    # grow, so they add 1x, not 4x
    n_init = len(scene.info.points) + model_cfg.skybox_num
    capacity = pipe_cfg.capacity or min(
        max(1 << int(np.ceil(np.log2(max(4 * n_init + n_scaffold, 1 << 14)))), 1 << 14),
        opt_cfg.max_all_points,
    )
    if pipe_cfg.capacity and n_scaffold:
        need = int(1.5 * n_init) + n_scaffold
        if capacity < need:
            capacity = 1 << int(np.ceil(np.log2(need)))
            print(f"capacity raised to {capacity} to hold the {n_scaffold}-row scaffold", flush=True)
    cfg = train_config_from_opt(opt_cfg, pipe_cfg, n_init)
    if pipe_cfg.chunk_box_cull:
        center_f = os.path.join(model_cfg.source_path, "center.txt")
        extent_f = os.path.join(model_cfg.source_path, "extent.txt")
        if os.path.exists(center_f) and os.path.exists(extent_f):
            # the chunk cell with 1.5x slack, XY only: chunk cells are
            # gridded over camera centres, so their z extent is a thin slab
            # at flight altitude that would exclude the ground
            c = np.loadtxt(center_f).reshape(-1)[:3]
            e = np.loadtxt(extent_f).reshape(-1)[:3] * 1.5
            lo, hi = c - e / 2, c + e / 2
            lo[2], hi[2] = -1e9, 1e9
            cfg = dataclasses.replace(cfg, chunk_box=(tuple(float(v) for v in lo), tuple(float(v) for v in hi)))
            print(f"chunk box cull: {cfg.chunk_box}", flush=True)
    state = init_gaussians_from_scene(scene, model_cfg, capacity, scaffold=scaffold, device=dev)
    ts = init_train_state(state, num_images=n_views, seed=seed)
    # the step runs on the alive prefix (row_budget); a scaffold lands in
    # the last dead slots, so compact once up front
    g0, opt0 = compact_gaussians(ts.gaussians, ts.opt)
    ts = ts._replace(gaussians=g0, opt=opt0)
    row_budget = fit_row_budget(int(ts.gaussians.alive.sum()), capacity)

    # resume from the latest iteration_* checkpoint below the target
    start_iter = 1
    if model_cfg.model_path:
        from hidegs_tpu_torch.train.checkpoint import find_latest_iteration, load_train_state

        ckpt_root = os.path.join(model_cfg.model_path, "point_cloud")
        latest = find_latest_iteration(ckpt_root)
        if latest is not None and latest < cfg.iterations:
            try:
                ts, latest = load_train_state(ts, ckpt_root, latest)
                start_iter = latest + 1
                print(f"resumed from iteration {latest}", flush=True)
                g, opt = compact_gaussians(ts.gaussians, ts.opt)
                ts = ts._replace(gaussians=g, opt=opt)
                row_budget = fit_row_budget(int(g.alive.sum()), capacity)
            except (ValueError, KeyError) as e:
                print(f"resume failed ({e}); training from scratch", flush=True)

    if model_cfg.model_path:
        from hidegs_tpu_torch.data.scene import save_scene_artifacts

        save_cfg_args(model_cfg.model_path, model_cfg, pipe_cfg, opt_cfg)
        scene.save_multi_view_json(os.path.join(model_cfg.model_path, "multi_view.json"))
        save_scene_artifacts(scene, model_cfg.model_path)

    cache = ViewCache(dev)
    # on a card every iteration replays the step captured as a CUDA graph
    # (train/compiled.py); a new budget, row budget or batch layout
    # captures anew. Its metrics live until the next step: the counters are
    # stacked into a tensor of their own below.
    step_fn = CompiledTrainStep() if on_card(dev) else train_step
    # and the densify rounds and scrubs replay theirs; their info tensors
    # live until the next round and are fetched at once below
    rounds = CompiledDensify() if on_card(dev) else None
    rng = random.Random(seed)
    order = []
    t0 = time.time()
    use_mv = cfg.multi_view_ncc_weight > 0 and bool(scene.neighbors)
    # budget bookkeeping: each step's counters stay on the device and are
    # read in windows of OVERFLOW_CHECK_EVERY steps, in one copy; budgets
    # grow on overflow and shrink after a clean window (train/budgets.py)
    pending_overflow = []
    refit = BudgetRefit(visible_compaction=pipe_cfg.visible_compaction)
    total_skipped_steps = 0
    last_schedule_event = 0  # last densify / opacity-reset step (shrink cooldown)
    budget_log = [(start_iter, cfg.raster.max_instances, cfg.raster.max_blocks)]
    for it in range(start_iter, cfg.iterations + 1):
        with span("train.iteration", request=it):
            if len(pending_overflow) >= OVERFLOW_CHECK_EVERY:
                with span("train.read_budgets", wait=True, refit=0) as read:
                    vals = [tuple(int(x) for x in row) for row in torch.stack(pending_overflow).tolist()]
                pending_overflow = []
                bad = sum(1 for v in vals if v[-1] == 0)
                if bad:
                    total_skipped_steps += bad
                    print(f"  {bad} non-finite steps skipped in window ending @{it}", flush=True)
                raster, changed = refit.update(cfg.raster, [v[:-1] for v in vals], it, row_budget,
                                               last_event=last_schedule_event)
                if changed:
                    cfg = dataclasses.replace(cfg, raster=raster)
                    budget_log.append((it, cfg.raster.max_instances, cfg.raster.max_blocks))
                    read.set(refit=1)
            with span("train.batch") as pick:
                copies = cache.copies
                if not order:
                    order = list(range(n_views))
                    rng.shuffle(order)
                vi = order.pop()
                cam = scene.train_cameras[vi]

                src_cam = src_depth = None
                if use_mv and it >= cfg.multi_view_from and scene.neighbors.get(vi):
                    si = rng.choice(scene.neighbors[vi])
                    src_cam = scene.train_cameras[si]
                    if cfg.multi_view_detached_src:
                        src_depth = render_plane_depth(ts, cache.arrays(src_cam)["cam"], cfg)

                batch = build_view_batch(cache, cam, vi, src_cam, src_depth)
                pick.set(cache_miss=cache.copies - copies)
            with span("train.step"):
                ts, metrics = step_fn(ts, batch, cfg, use_exposure=opt_cfg.use_exposure, row_budget=row_budget)
            if model_cfg.model_path and it in save_iterations:
                # save BEFORE the schedule hook: an opacity reset on the same
                # iteration would otherwise leave a near-transparent model in
                # the checkpoint
                d = save_train_state(ts, os.path.join(model_cfg.model_path, "point_cloud"), it)
                print(f"saved checkpoint → {d}", flush=True)
            pending_overflow.append(torch.stack([metrics[k].to(torch.int64) for k in _COUNTERS]))
            # the step is passed explicitly: int(ts.step) would wait for the device
            with span("train.schedule"):
                ts, dens_info = maybe_host_side_schedule(ts, cfg, scene_extent=scene.extent, step=it,
                                                         compiled=rounds)
            if dens_info is not None or (
                cfg.densify_from <= it <= cfg.densify_until
                and it % cfg.opacity_reset_interval == 0
                and (cfg.opacity_reset_until <= 0 or it <= cfg.opacity_reset_until)
            ):
                last_schedule_event = it
            if dens_info is not None:
                # restore the alive-prefix layout (prune leaves holes) and re-fit
                # the active-row budget to the new alive count
                g, opt = compact_gaussians(ts.gaussians, ts.opt)
                ts = ts._replace(gaussians=g, opt=opt)
                with span("train.read_densify", wait=True):
                    info = dict(zip(dens_info, _fetch(dens_info.values())))
                n_alive = int(info["n_alive"])
                new_rb = fit_row_budget(n_alive, capacity)
                if new_rb != row_budget:
                    print(f"  row budget {row_budget} → {new_rb} (alive {n_alive})", flush=True)
                    # scale the compaction budget with the rows, so that the new
                    # rows do not overflow it during the counters' lag
                    if cfg.raster.max_visible and new_rb > row_budget:
                        grown = min(round_budget(int(cfg.raster.max_visible * new_rb / row_budget)), new_rb)
                        cfg = dataclasses.replace(cfg, raster=dataclasses.replace(cfg.raster, max_visible=grown))
                    row_budget = new_rb
                print(
                    f"  densify@{it}: clone={int(info['n_clone'])} split={int(info['n_split'])} "
                    f"pruned={int(info['n_pruned'])} dropped={int(info['n_dropped'])} alive={n_alive} "
                    f"score p50/p90/p99={info['score_p50']:.4f}/{info['score_p90']:.4f}/{info['score_p99']:.4f} "
                    f"grad p50/p99={info['grad_p50']:.5f}/{info['grad_p99']:.5f} "
                    f"radii p50/p99={info['radii_p50']:.0f}/{info['radii_p99']:.0f}",
                    flush=True,
                )

            if it % log_every == 0:
                with span("train.read_log", wait=True):
                    total, photo, n_alive = _fetch([metrics["total"], metrics["photo"], ts.gaussians.alive.sum()])
                print(f"[{it}/{cfg.iterations}] loss={total:.4f} photo={photo:.4f} alive={int(n_alive)} "
                      f"({(time.time() - t0):.1f}s)", flush=True)
            if model_cfg.model_path and pipe_cfg.debug_panel_every > 0 and it % pipe_cfg.debug_panel_every == 0:
                save_frequency_panel(ts, cache, cam, cfg, model_cfg.model_path, it)
    # drain the counters of the last (partial) window
    if pending_overflow:
        vals = [tuple(int(x) for x in row) for row in torch.stack(pending_overflow).tolist()]
        refit.dropped_instances += sum(v[0] for v in vals)
        refit.dropped_blocks += sum(v[1] for v in vals)
        total_skipped_steps += sum(1 for v in vals if v[-1] == 0)
    if refit.dropped_instances or refit.dropped_blocks:
        print(f"run summary: {refit.dropped_instances} instances and {refit.dropped_blocks} kernel blocks were "
              "dropped by budget overflows before re-budgeting caught up", flush=True)
    if total_skipped_steps:
        print(f"run summary: {total_skipped_steps} steps skipped by the finite-step gate "
              "(non-finite loss/grads)", flush=True)
    if len(budget_log) > 1:
        traj = " → ".join(f"@{s}:{mi}/{mb or '-'}" for s, mi, mb in budget_log)
        print(f"run summary: budget trajectory (step:instances/blocks) {traj}", flush=True)
    return ts


def _available_ram_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30  # conservative default when /proc is unavailable


def _cache_images(model_cfg, scene_info=None) -> bool:
    """Decoded-image caching policy (ModelConfig.cache_images): "always" /
    "never", or "auto", which caches when the decoded float32 footprint
    (from the COLMAP intrinsics, before any image is decoded) fits in 40% of
    the available RAM."""
    mode = getattr(model_cfg, "cache_images", "auto")
    if mode == "always":
        return True
    if mode == "never":
        return False
    if scene_info is None:
        return True
    bytes_needed = sum(int(c.width) * int(c.height) * 3 * 4
                       for c in scene_info.train_cameras + scene_info.test_cameras)
    return bytes_needed < 0.4 * _available_ram_bytes()


def main(argv=None) -> TrainState:
    parser = argparse.ArgumentParser("hidegs_tpu_torch trainer")
    add_group(parser, ModelConfig())
    add_group(parser, PipelineConfig())
    add_group(parser, OptimizationConfig())
    parser.add_argument("--save_iterations", type=int, nargs="+", default=[7_000, 30_000])
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    model_cfg = extract_group(args, ModelConfig)
    pipe_cfg = extract_group(args, PipelineConfig)
    opt_cfg = extract_group(args, OptimizationConfig)
    return train(model_cfg, pipe_cfg, opt_cfg, save_iterations=tuple(args.save_iterations), device=args.device)


if __name__ == "__main__":
    main()
