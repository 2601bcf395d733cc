#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (hidegs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's two paths at full width — rendering
(`hidegs_tpu_torch.raster.api.render`, the hand-written CUDA forward blend)
and training (`hidegs_tpu_torch.train.loop.train_step`, which adds the CUDA
backward blend and the gradient fold kernel) — and holds every kernel of
those paths against its plain PyTorch version. Phases:

  1. environment: card name and power limit, versions, the kernel builds
     (one nvcc per source, started together);
  2. small: toy scenes, tile 16 and 32, render_geo on and off, and the
     mask boundary scene (make_blend_boundary_scene: level sets that end on
     the kernels' 8x4 mask blocks) with and without a too-small max_blocks,
     forward kernel ("blend") against plain: planes at atol 3e-4 / rtol
     1e-3, out_observe exactly equal;
  3. small backward: the same scenes, tile 16 and 32, with and without a
     too-small max_blocks: backward + fold kernels against blend_tiles_bwd
     + the plain fold (`hold_grads`), and the fold kernel against the plain
     fold in float64 (`hold_fold`); then 3 train steps with the "blend"
     backend against 3 with the "plain" one;
  4. full width: 1,010,240 gaussians (make_uav_gaussians, 1M ground + 64
     structures), four 1920x1088 views from a 2x2 nadir grid, tile 32, SH 3,
     render_geo, budgets from a probe pass with 1.12x slack. Launch counts
     are read around this run alone. Every view is held against the plain
     blend (run in tile groups); two renders of each must be bitwise equal;
  5. render times with CUDA events (median of 10 after 2 warm-ups): the full
     render, the kernel alone, the plain version; the kernel's bound (and
     PR 2's yardstick beside it, see blend_bound); the visited tiles' span
     lengths; from the plain mask, the share of (instance, 8x4 block) pairs
     the warp-block mask keeps and the pixel pairs the kernel evaluates at
     most (blend_plain.block_masks, block_pair_counts); and the ptxas
     registers and spills from the loaded library's build log;
  6. render breakdown: preprocess, binning and blend timed alone, and one
     render under torch.profiler for the device busy share and top kernels;
  7. training at full width: the four rendered views are the targets; the
     trainable state is the scene through the inverse activations, seeded
     noise on sh_dc, opacity logits and xyz, capacity 1.25x. 30 train steps
     cycling the views, default TrainConfig but freq_warmup=0,
     single_view_from=0 and one densify round of the reference's rules
     after step 10; launch counts are read around this run alone. Checks:
     finite losses, step_ok, no overflow, mean PSNR up over the steps
     before the round and over those after it, one launch of each kernel
     per step, two runs of one step bitwise equal;
  8. the densify round: the alive count changes, every value stays finite,
     the rows it did not split, clone or prune keep their parameters to the
     bit, and the images change only where the rows it changed are drawn;
     prints what it split (screen radii, scales, structure or ground rows)
     and the PSNR it cost in each view;
  9. full-width hold: view 0's backward + fold kernels against the plain
     versions, on the cotangents one train step gives its blend;
 10. train times: the step, split into train_step's own stages
     (step_forward / step_backward / step_update), the backward and fold
     kernels alone, their plain versions and bounds, the backward's mask
     share, evaluated pairs, registers and spills (as in phase 5), and one
     step under torch.profiler.

Prints a `{"kernels": [...]}` line and, last, the `{"ok": true, ...}` line.
Any failed check raises and exits non-zero. Without a CUDA device it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BLEND_TOL = dict(atol=3e-4, rtol=1e-3)  # the JAX suite's Pallas-vs-plain tolerance
PLANE_KEYS = ["render", "invdepth", "alpha", "T_final", "normal", "distance"]
RENDER_KEYS = ["render", "invdepth", "alpha", "T_final", "rendered_normal", "rendered_distance"]

# H100 SXM peaks (NVIDIA data sheet; 700 W): HBM3 bandwidth, non-tensor FP32,
# and the special-function units (16 MUFU results per clock per SM on
# compute capability 9.0, x 132 SMs x the 1.98 GHz boost clock).
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
SFU_OPS_S = 16 * 132 * 1.98e9
# float32 operations of the forward blend per (pixel, instance) pair whose α
# it tests (dx, dy, the quadratic form, clamps, the α product and tests) and
# per pair whose α ≥ 1/255 it uses (the log-transmittance update, the T
# test, w and nine multiply-adds, the observe tests), counted from
# csrc/blend_fwd.cu; each tested pair needs one exp, each used pair a log1p
# and an exp more.
OPS_PER_LIVE_PAIR = 16
OPS_PER_KEPT_PAIR = 23
SFU_PER_KEPT_PAIR = 2
# The same for the backward blend, counted from csrc/blend_bwd.cu: per
# tested pair the forward's α test (15 ops, one exp); per used pair the
# transmittance update, w, chg (17), the prefix and S, dα with its division,
# and the 14 gradient terms with their sums (75 ops), and a log1p, an exp
# and a reciprocal on the special-function units.
BWD_OPS_PER_LIVE_PAIR = 15
BWD_OPS_PER_KEPT_PAIR = 75
BWD_SFU_PER_KEPT_PAIR = 3
# One box test of an instance against an 8x4 pixel block (blend_common.cuh:
# block_reachable, with the per-instance terms hoisted): 84 float32
# operations; per instance a log and two reciprocals.
OPS_PER_BOX_TEST = 84
SFU_PER_BOXED_INSTANCE = 3
# The backward and fold kernels against their plain versions on the same
# inputs (`hold_grads`): each column of the per-gaussian gradients within
# GRAD_NORM_TOL of its max |grad|, and each element within GRAD_RTOL of
# itself plus GRAD_MEDIAN_ATOL times the column's median non-zero |grad|.
# The two differ only in the order of their float32 sums.
GRAD_NORM_TOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_MEDIAN_ATOL = 1e-2
# Adam's first moment after one train step (0.1·grad) with the kernels
# against the plain blend, normalised per leaf: the forward planes already
# differ by up to 1e-4 where the kernel stops a pixel at T < 1e-4.
STEP_GRAD_TOL = 1e-3
TRAIN_STEPS = 30
DENSIFY_AT = 10  # the training run's one densify round follows this step
# the full-width cell: make_uav_gaussians(1M ground + 64 structures), 1920x1088
N_GROUND, N_STRUCTS, FULL_H, FULL_W = 1_000_000, 64, 1088, 1920

WARMUP, ITERS = 2, 10


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_abs_err(a, b):
    return float((a.double() - b.double()).abs().max())


def assert_close(got, want, what):
    bad = ~torch.isclose(got, want, **BLEND_TOL)
    n_bad = int(bad.sum())
    check(n_bad == 0, f"{what}: {n_bad} elements outside atol 3e-4 / rtol 1e-3, "
                      f"max abs err {max_abs_err(got, want):.3e}")


def time_ms(fn, warmup=WARMUP, iters=ITERS):
    """Median ms of `fn` between two CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def reset_counts():
    from hidegs_tpu_torch.raster import cuda_blend

    cuda_blend.LAUNCHES = cuda_blend.BWD_LAUNCHES = cuda_blend.FOLD_LAUNCHES = 0


def read_counts():
    from hidegs_tpu_torch.raster import cuda_blend

    torch.cuda.synchronize()
    return {"blend_fwd": cuda_blend.LAUNCHES, "blend_bwd": cuda_blend.BWD_LAUNCHES,
            "fold_rows": cuda_blend.FOLD_LAUNCHES}


def profile_device(fn, label):
    """Run `fn` once under torch.profiler; print the host wall time, the
    device busy share and the device ops that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, [0, 0.0])
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    if busy_ms == 0.0:
        print(f"[{label}] profiler saw no device time: device busy share not measured")
        return
    n_ops = sum(n for n, _ in by_name.values())
    print(f"[{label}] one run under the profiler: host wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}) in {n_ops} device ops")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[{label}]   {ms:8.3f} ms  x{n:<4d} {name[:100]}")


def phase_environment():
    from hidegs_tpu_torch.raster import cuda_blend

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = cuda_blend.build()
    print(f"[env] built {', '.join(lib.name for lib in libs.values())} in {time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"[env] ptxas ({lib.name.rsplit('_', 1)[0]}): {line.strip()[:160]}")
    return smi


def ptxas_usage(lib):
    """{kernel<tile>: (registers, spill store bytes, spill load bytes)} of
    library `lib`, from the compiler's report in its build log (written
    when the library was built, in this process or an earlier one)."""
    usage, kernel, spill = {}, None, (0, 0)
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '\S*?\d+([a-z_]+_kernel)(?:ILi(\d+)E)?", line)
        if m:
            kernel = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            usage[kernel] = (int(m.group(1)), *spill)
    return usage


def usage_report(usage):
    return ", ".join(f"{k} {r} registers, {st}/{ld} bytes spilled (stores/loads)"
                     for k, (r, st, ld) in usage.items())


def mask_report(pre, tb, tx, tile, count, live):
    """The warp-block mask on this binning, from its plain version (the
    kernels do not count): the share of (instance, 8x4 block) pairs it
    keeps, and the pixel pairs the kernels evaluate at most (warps that
    are done skip the rest)."""
    from hidegs_tpu_torch.raster import blend_plain

    masks = blend_plain.block_masks(pre, tb, tx, tile, count)
    n_blocks = tile * tile // (blend_plain.BLOCK_W * blend_plain.BLOCK_H)
    kept = sum(int(((masks >> b) & 1).sum()) for b in range(n_blocks))
    share = kept / max(int(count.sum()) * n_blocks, 1)
    evaluated = blend_plain.block_pair_counts(pre, tb, tx, tile, count)
    return (f"plain mask's estimate: the warp-block mask keeps {share:.4f} of the (instance, 8x4 block) "
            f"pairs, and the kernel evaluates at most {evaluated} pixel pairs, {evaluated / max(live, 1):.4f} "
            f"of the {live} whole-tile pairs")


def blend_bound(bytes_moved, counts, tile, ops_live, ops_kept, sfu_kept):
    """bound_ms of a blend kernel: the larger of the bytes it must move over
    the memory rate and the operations this run's data needs over the peak
    rates. `counts` is blend_plain.pair_counts (live, kept, open). Needed:
    for each open pair (α ≥ 1/255 at a pixel still at T ≥ 1e-4) the α test
    (`ops_live`, one exp) and the use of α (`ops_kept`, `sfu_kept`), and
    one box test per (reached instance, 8x4 block), which is all a blend
    needs to find the pairs it may skip. Also returns PR 2's yardstick,
    which counts the α test on every pixel of a reached instance's tile
    and the use of α on every kept pair, open or not."""
    from hidegs_tpu_torch.raster import blend_plain

    live, kept, open_ = counts
    P = tile * tile
    reached = live // P
    boxes = reached * (P // (blend_plain.BLOCK_W * blend_plain.BLOCK_H))
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = (open_ * (ops_live + ops_kept) + boxes * OPS_PER_BOX_TEST) / FP32_FLOP_S * 1e3
    t_sfu = (open_ * (1 + sfu_kept) + reached * SFU_PER_BOXED_INSTANCE) / SFU_OPS_S * 1e3
    bound = max(t_bytes, t_ops, t_sfu)
    yardstick = max(t_bytes, (live * ops_live + kept * ops_kept) / FP32_FLOP_S * 1e3,
                    (live + sfu_kept * kept) / SFU_OPS_S * 1e3)
    return dict(bound_ms=bound, bound_by="bytes" if t_bytes >= max(t_ops, t_sfu) else "operations",
                yardstick_ms=yardstick,
                text=f"bound {bound:.4f} ms = max(bytes {t_bytes:.4f}, fp32 ops {t_ops:.4f}, sfu {t_sfu:.4f}) "
                     f"for {open_} open pairs and {boxes} box tests; PR 2 yardstick {yardstick:.4f} ms "
                     f"(every reached pixel's α test, every kept pair)")


def span_report(count):
    """The span lengths (post-cull instances per tile) of the visited tiles."""
    T = count.numel()
    spans = torch.sort(count[count > 0].double(), descending=True).values
    q = torch.quantile(spans, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=spans.device))
    top = -(-spans.numel() // 100)
    return (f"{T} tiles, {T - spans.numel()} empty; non-empty spans p50 {float(q[0]):.0f}, p90 {float(q[1]):.0f}, "
            f"p99 {float(q[2]):.0f}, max {int(spans[0])} instances; the longest 1% of them hold "
            f"{float(spans[:top].sum() / spans.sum()):.4f} of the instances")


def boundary_scene(dev, tile):
    """make_blend_boundary_scene on a 96x64 canvas, binned at `tile`."""
    from hidegs_tpu_torch.data.synthetic import make_blend_boundary_scene
    from hidegs_tpu_torch.raster import binning

    pre = make_blend_boundary_scene(height=64, width=96, seed=7, device=dev)
    ty, tx = binning.tile_grid(64, 96, tile)
    return pre, binning.bin_gaussians(pre, ty, tx, 1 << 16, tile), ty, tx


def phase_small(dev):
    from hidegs_tpu_torch.data.synthetic import make_toy_gaussians, ring_camera
    from hidegs_tpu_torch.raster import blend_autograd, blend_plain
    from hidegs_tpu_torch.raster.api import RasterConfig, render

    scene = make_toy_gaussians(400, seed=11, device=dev)
    cam = ring_camera(1, height=88, width=120, device=dev)
    for tile in (16, 32):
        for geo in (False, True):
            kw = dict(tile=tile, max_instances=1 << 14)
            k = render(*scene, cam, render_geo=geo, config=RasterConfig(backend="blend", **kw))
            p = render(*scene, cam, render_geo=geo, config=RasterConfig(backend="plain", **kw))
            keys = RENDER_KEYS if geo else RENDER_KEYS[:4]
            err = 0.0
            for key in keys:
                check(bool(torch.isfinite(k[key]).all()), f"small tile={tile} geo={geo}: {key} not finite")
                assert_close(k[key], p[key], f"small tile={tile} geo={geo} {key}")
                err = max(err, max_abs_err(k[key], p[key]))
            check(torch.equal(k["out_observe"], p["out_observe"]),
                  f"small tile={tile} geo={geo}: out_observe differs")
            print(f"[small] tile={tile} render_geo={geo}: max abs err {err:.3e}, out_observe equal")
    for tile in (16, 32):
        pre, tb, ty, tx = boundary_scene(dev, tile)
        for max_blocks in (0, 3):
            k = blend_autograd.blend_tiles(pre, tb, ty, tx, tile, max_blocks)
            p = blend_plain.blend_tiles(pre, tb, ty, tx, tile, max_blocks)
            what = f"small mask boundary scene tile={tile} max_blocks={max_blocks}"
            err = 0.0
            for key in PLANE_KEYS:
                check(bool(torch.isfinite(k[key]).all()), f"{what}: {key} not finite")
                assert_close(k[key], p[key], f"{what} {key}")
                err = max(err, max_abs_err(k[key], p[key]))
            check(torch.equal(k["out_observe"], p["out_observe"]), f"{what}: out_observe differs")
            print(f"[small] mask boundary scene ({pre.mean2d.shape[0]} gaussians, {tb.gauss_id.shape[0]} "
                  f"instance slots) tile={tile} max_blocks={max_blocks}: max abs err {err:.3e}, out_observe equal")


def full_width_setup(dev):
    from hidegs_tpu_torch.data.synthetic import make_uav_gaussians, nadir_grid_camera
    from hidegs_tpu_torch.raster import binning, blend_plain
    from hidegs_tpu_torch.raster.api import RasterConfig, round_budget
    from hidegs_tpu_torch.raster.preprocess import preprocess_gaussians

    t0 = time.perf_counter()
    scene = make_uav_gaussians(n_ground=N_GROUND, n_structs=N_STRUCTS, seed=0, device=dev)
    cams = [nadir_grid_camera(ix, iy, 2, 2, altitude=14.0, height=FULL_H, width=FULL_W, device=dev)
            for iy in range(2) for ix in range(2)]
    tile = 32
    ty, tx = binning.tile_grid(FULL_H, FULL_W, tile)
    # budgets from a probe pass with 1.12x slack, as the JAX benchmark sizes them
    want_inst, want_blocks = 0, 0
    for cam in cams:
        pre = preprocess_gaussians(*scene, cam, screen_bounds=(tx * tile, ty * tile))
        tb = binning.bin_gaussians(pre, ty, tx, 1 << 21, tile)
        check(int(tb.overflow) == 0, "probe budget overflowed")
        want_inst = max(want_inst, int(tb.num_instances))
        want_blocks = max(want_blocks, int(blend_plain.needed_blocks(tb.tile_count)))
    max_blocks = -(-int(want_blocks * 1.12) // 256) * 256
    cfg = RasterConfig(backend="blend", tile=tile, max_instances=round_budget(int(want_inst * 1.12)),
                       max_blocks=max_blocks, depth_sort_bits=-1)
    print(f"[full] {scene.means3d.shape[0]} gaussians, {len(cams)} views {FULL_W}x{FULL_H}, "
          f"tile {tile}, max_instances {cfg.max_instances}, max_blocks {cfg.max_blocks} "
          f"(set-up {time.perf_counter() - t0:.1f} s)")
    return scene, cams, cfg


def phase_full_width(scene, cams, cfg):
    """The render path: four views through `render`, counts read around it."""
    from hidegs_tpu_torch.raster.api import render

    reset_counts()
    with torch.no_grad():
        outs = [render(*scene, cam, render_geo=True, active_sh_degree=3, config=cfg) for cam in cams]
    launches = read_counts()
    print(f"[full] launches on the render path: {launches}")
    check(launches == {"blend_fwd": len(cams), "blend_bwd": 0, "fold_rows": 0},
          f"render path launches {launches}, expected {len(cams)} forward blends and nothing else")
    for i, out in enumerate(outs):
        for key in ("overflow", "block_overflow", "visible_overflow"):
            check(int(out[key]) == 0, f"view {i}: {key} = {int(out[key])}")
        check(tuple(out["render"].shape) == (3, FULL_H, FULL_W), f"view {i}: render shape")
        for key in RENDER_KEYS + ["plane_depth", "depth_normal"]:
            check(bool(torch.isfinite(out[key]).all()), f"view {i}: {key} not finite")
        alpha_mean = float(out["alpha"].mean())
        std = float(out["render"].std())
        n_obs = int((out["out_observe"] > 0).sum())
        # the views of the far grid row see past the scene's edge: about
        # half their pixels are background (the hold phase prints each
        # view's plain-blend alpha mean and background share beside these)
        check(alpha_mean > 0.25 and std > 0.02 and n_obs > 1000,
              f"view {i}: trivial image (alpha mean {alpha_mean}, std {std}, observed {n_obs})")
        print(f"[full] view {i}: alpha mean {alpha_mean:.4f}, rgb std {std:.4f}, "
              f"instances {int(out['num_instances'])}, blocks {int(out['needed_blocks'])}, "
              f"visible {int(out['num_visible'])}, observed gaussians {n_obs}")
    return launches, outs


def phase_hold_full_width(scene, cams, cfg, outs):
    """Every view's kernel blend against the plain version on the same
    inputs. The rendered alpha and out_observe must be the held kernel
    output itself, and a second render of each view must match bitwise.
    Returns view 0's preprocessed rows and binning, and the max error."""
    from hidegs_tpu_torch.raster import binning, blend_autograd, blend_plain
    from hidegs_tpu_torch.raster.api import render
    from hidegs_tpu_torch.raster.preprocess import preprocess_gaussians

    tile = cfg.tile
    err, held = 0.0, None
    for i, (cam, out) in enumerate(zip(cams, outs)):
        H, W = cam.height, cam.width
        ty, tx = binning.tile_grid(H, W, tile)
        pre = preprocess_gaussians(*scene, cam, active_sh_degree=3, render_geo=True,
                                   screen_bounds=(tx * tile, ty * tile))
        tb = binning.bin_gaussians(pre, ty, tx, cfg.max_instances, tile, depth_bits=cfg.depth_sort_bits)
        k = blend_autograd.blend_tiles(pre, tb, ty, tx, tile, cfg.max_blocks)
        p = blend_plain.blend_tiles(pre, tb, ty, tx, tile, cfg.max_blocks)
        view_err = 0.0
        for key in PLANE_KEYS:
            assert_close(k[key], p[key], f"full width view {i} {key}")
            view_err = max(view_err, max_abs_err(k[key], p[key]))
        err = max(err, view_err)
        N = pre.mean2d.shape[0]
        n_diff = int((k["out_observe"] != p["out_observe"]).sum())
        check(n_diff <= N // 1000, f"view {i}: out_observe differs on {n_diff} of {N} gaussians (> 0.1%)")
        check(torch.equal(out["alpha"], k["alpha"][:H, :W]) and torch.equal(out["out_observe"], k["out_observe"]),
              f"view {i}: the render's alpha / out_observe are not the held kernel output")
        again = render(*scene, cam, render_geo=True, active_sh_degree=3, config=cfg)
        for key, val in out.items():
            check(torch.equal(val, again[key]), f"two renders of view {i} differ in {key}")
        p_alpha = p["alpha"][:H, :W]
        print(f"[hold] view {i} kernel vs plain: max abs err {view_err:.3e} (atol 3e-4 / rtol 1e-3 holds), "
              f"out_observe differs on {n_diff} of {N} gaussians; alpha mean kernel "
              f"{float(out['alpha'].mean()):.4f} plain {float(p_alpha.mean()):.4f}, plain background "
              f"share (alpha < 1/255) {float((p_alpha < 1 / 255).float().mean()):.4f}; "
              f"two renders bitwise equal")
        if i == 0:
            held = pre, tb
    return held[0], held[1], err


def phase_times(scene, cam, cfg, pre, tb):
    from hidegs_tpu_torch.raster import binning, blend_plain, cuda_blend
    from hidegs_tpu_torch.raster.api import render

    tile, P = cfg.tile, cfg.tile * cfg.tile
    ty, tx = binning.tile_grid(cam.height, cam.width, tile)
    render_ms = time_ms(lambda: render(*scene, cam, render_geo=True, active_sh_degree=3, config=cfg))

    attrs = blend_plain.pack_gaussian_attrs(pre)
    I = tb.gauss_id.shape[0]
    count = cuda_blend.visited_count(tb, cfg.max_blocks)
    out = torch.empty((ty * tx, P, cuda_blend.OUT_CH), device=attrs.device)
    obs = torch.zeros((I,), dtype=torch.int32, device=attrs.device)

    def launch():
        obs.zero_()
        cuda_blend.launch_blend_fwd(attrs, tb.gauss_id, tb.tile_start, count, tx, tile, out, obs)

    kernel_ms = time_ms(launch)
    plain_ms = time_ms(lambda: blend_plain.blend_tiles(pre, tb, ty, tx, tile, cfg.max_blocks))

    post_cull = int(count.sum())
    valid_ids = tb.gauss_id[:post_cull]  # spans of visited tiles form the prefix
    unique_rows = int(torch.unique(valid_ids).numel())
    T = ty * tx
    bytes_moved = post_cull * 4 + 2 * T * 4 + unique_rows * 64 + T * P * 64 + post_cull * 4
    counts = blend_plain.pair_counts(pre, tb, tx, tile, cfg.max_blocks)
    bound = blend_bound(bytes_moved, counts, tile, OPS_PER_LIVE_PAIR, OPS_PER_KEPT_PAIR, SFU_PER_KEPT_PAIR)
    print(f"[times] full render {render_ms:.3f} ms; blend kernel {kernel_ms:.3f} ms; "
          f"plain blend {plain_ms:.3f} ms")
    print(f"[times] post-cull instances {post_cull}, gaussian rows {unique_rows}, pairs {post_cull * P} "
          f"(live {counts[0]}, kept {counts[1]}, open {counts[2]}); spans: {span_report(count)}")
    print(f"[times] {bound['text']}; kernel at {bound['bound_ms'] / kernel_ms:.1%} of the bound, "
          f"{bound['yardstick_ms'] / kernel_ms:.1%} of the yardstick")
    print(f"[times] forward: {mask_report(pre, tb, tx, tile, count, counts[0])}; ptxas (build log): "
          f"{usage_report(ptxas_usage(cuda_blend.build()['blend_fwd']))}")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                render_ms=render_ms)


def phase_breakdown(scene, cam, cfg, pre, tb):
    """Where a full render's time goes: each stage timed alone with CUDA
    events, then one render under torch.profiler for the device busy share
    and the kernels that take the device time."""
    from hidegs_tpu_torch.raster import binning, blend_autograd
    from hidegs_tpu_torch.raster.api import render
    from hidegs_tpu_torch.raster.preprocess import preprocess_gaussians

    tile = cfg.tile
    ty, tx = binning.tile_grid(cam.height, cam.width, tile)
    stages = {
        "preprocess": lambda: preprocess_gaussians(*scene, cam, active_sh_degree=3, render_geo=True,
                                                   screen_bounds=(tx * tile, ty * tile)),
        "binning": lambda: binning.bin_gaussians(pre, ty, tx, cfg.max_instances, tile,
                                                 depth_bits=cfg.depth_sort_bits),
        "blend (wrapper)": lambda: blend_autograd.blend_tiles(pre, tb, ty, tx, tile, cfg.max_blocks),
    }
    parts = ", ".join(f"{name} {time_ms(fn):.3f} ms" for name, fn in stages.items())
    print(f"[breakdown] stages alone (CUDA events): {parts}")

    profile_device(lambda: render(*scene, cam, render_geo=True, active_sh_degree=3, config=cfg), "breakdown")


def grad_gate_stats(got, want):
    """Per column of the gradient rows, against the plain versions' `want`:
    the elements outside the per-element gate (`n_bad`), the multiple of
    the median the worst element needed, the max error normalised by the
    column's max, and the median non-zero |want|. A column where `want` is
    all zero has no median, and n_bad counts its non-zero elements."""
    from hidegs_tpu_torch.raster import blend_plain

    cols = []
    for c in range(blend_plain.GRAD_COLS):
        w, g = want[:, c].double(), got[:, c].double()
        mag = w.abs()
        scale = float(mag.max())
        if scale == 0.0:
            cols.append(dict(n_bad=int(g.ne(0).sum()), needed=0.0, norm=0.0, med=None))
            continue
        err = (g - w).abs()
        med = float(mag[mag > 0].median())
        cols.append(dict(n_bad=int((err > GRAD_RTOL * mag + GRAD_MEDIAN_ATOL * med).sum()),
                         needed=float(((err - GRAD_RTOL * mag) / med).max()), norm=float(err.max()) / scale,
                         med=med))
    return cols


def hold_grads(got, want, what):
    """Per-gaussian gradient rows of the kernels against the plain versions
    (see GRAD_NORM_TOL). A column with no gradient in the plain version
    must be exactly zero. Returns the max abs error, the max normalised
    error, and the multiple of the median the per-element test needed."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite gradients")
    check(float(want.abs().max()) > 0, f"{what}: all-zero gradients")
    cols = grad_gate_stats(got, want)
    for c, s in enumerate(cols):
        if s["med"] is None:
            check(s["n_bad"] == 0, f"{what}: column {c} has no gradient in the plain version but not here")
            continue
        check(s["norm"] <= GRAD_NORM_TOL, f"{what}: column {c} normalised err {s['norm']:.3e} > {GRAD_NORM_TOL}")
        check(s["n_bad"] == 0, f"{what}: column {c}: {s['n_bad']} elements outside rtol {GRAD_RTOL} + "
                               f"{GRAD_MEDIAN_ATOL} x the median non-zero |grad| {s['med']:.3e}")
    return max_abs_err(got, want), max(s["norm"] for s in cols), max(0.0, *(s["needed"] for s in cols))


def hold_fold(rows_exp, g_start, got, what):
    """The fold kernel's float32 sums against the plain fold of the same
    rows in float64: each element within k·2^-24·Σ|row|, the rounding of a
    float32 sum of the k rows of its span. Returns the max abs error and
    the largest share of that bound used."""
    from hidegs_tpu_torch.raster import blend_plain

    want = blend_plain.fold_rows(rows_exp.double(), g_start)
    bound = (torch.diff(g_start.long()).double()[:, None] * 2.0 ** -24
             * blend_plain.fold_rows(rows_exp.double().abs(), g_start))
    err = (got.double() - want).abs()
    n_bad = int((err > bound).sum())
    check(n_bad == 0, f"{what}: {n_bad} folded elements outside the float32 summation bound")
    used = float((err / bound.clamp(min=1e-300)).max())
    return float(err.max()), used


def hold_backward(attrs, tb, count, tile_out, g_tiles, ty, tx, tile, max_blocks, what):
    """The backward and fold kernels (`grad_attrs`) against blend_tiles_bwd
    and the plain fold on the same packed rows, binning and cotangents, and
    the fold kernel against the float64 plain fold of the kernel's own
    rows; two kernel runs must agree to the bit. Returns the errors and the
    inputs, for timing."""
    from hidegs_tpu_torch.raster import blend_plain, cuda_blend

    g_aug = blend_plain.augment_cotangents(tile_out, g_tiles)
    got = cuda_blend.grad_attrs(attrs, tb, count, g_aug, tx, tile)
    rows = blend_plain.blend_tiles_bwd(blend_plain.unpack_attrs(attrs), tb, g_aug, ty, tx, tile, max_blocks)
    want = blend_plain.fold_rows(blend_plain.expansion_rows(rows, tb.slot_s), tb.g_start)
    abs_err, norm_err, needed = hold_grads(got, want, what)
    k_rows_exp = blend_plain.expansion_rows(cuda_blend.instance_rows(attrs, tb, count, g_aug, tx, tile), tb.slot_s)
    fold_err, fold_used = hold_fold(k_rows_exp, tb.g_start, got, f"{what}, fold")
    again = cuda_blend.grad_attrs(attrs, tb, count, g_aug, tx, tile)
    check(torch.equal(again, got), f"{what}: two backward runs differ")
    return dict(err=abs_err, norm_err=norm_err, needed=needed, fold_err=fold_err, fold_used=fold_used,
                attrs=attrs, count=count, g_aug=g_aug, rows_exp=k_rows_exp)


def hold_report(h):
    return (f"max abs err {h['err']:.3e}, max normalised err {h['norm_err']:.3e} (tol {GRAD_NORM_TOL}), "
            f"per element needed {h['needed']:.3e} x median (tol {GRAD_MEDIAN_ATOL}); fold vs float64: "
            f"max abs err {h['fold_err']:.3e}, {h['fold_used']:.3f} of its bound; two runs bitwise equal")


def toy_train_problem(dev, n=300, hw=80):
    from hidegs_tpu_torch.data.synthetic import make_toy_gaussians, ring_camera
    from hidegs_tpu_torch.model.gaussians import init_from_points
    from hidegs_tpu_torch.model.knn import initial_scales
    from hidegs_tpu_torch.raster.api import RasterConfig, render
    from hidegs_tpu_torch.train import loop as tl

    rcfg = RasterConfig(tile=16, max_instances=1 << 15)
    scene = make_toy_gaussians(n, seed=8, device=dev)
    cams = [ring_camera(i, n_cams=4, height=hw, width=hw, device=dev) for i in range(4)]
    with torch.no_grad():
        gts = [render(*scene, c, config=rcfg)["render"] for c in cams]
    jitter = torch.randn(scene.means3d.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    pts = scene.means3d + 0.01 * jitter
    state = init_from_points(pts, torch.full((n, 3), 0.5, device=dev), capacity=512,
                             knn_scale=initial_scales(pts), spatial_lr_scale=3.0)
    cfg = tl.TrainConfig(iterations=100, raster=rcfg, freq_warmup=0, single_view_from=0)
    batches = [tl.ViewBatch(cam=c, image=g, image_idx=torch.tensor(i, device=dev))
               for i, (c, g) in enumerate(zip(cams, gts))]
    return tl.init_train_state(state, 4), batches, cfg


def phase_small_backward(dev):
    import dataclasses

    from hidegs_tpu_torch.data.synthetic import make_toy_gaussians, ring_camera
    from hidegs_tpu_torch.raster import binning, blend_plain, cuda_blend
    from hidegs_tpu_torch.raster.preprocess import preprocess_gaussians
    from hidegs_tpu_torch.train import loop as tl

    scene = make_toy_gaussians(400, seed=11, device=dev)
    cam = ring_camera(1, height=88, width=120, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    for tile in (16, 32):
        ty, tx = binning.tile_grid(cam.height, cam.width, tile)
        pre = preprocess_gaussians(*scene, cam, render_geo=True, screen_bounds=(tx * tile, ty * tile))
        toy = (pre, binning.bin_gaussians(pre, ty, tx, 1 << 14, tile), ty, tx)
        for label, (pre, tb, ty, tx) in (("toy scene", toy), ("mask boundary scene", boundary_scene(dev, tile))):
            need = int(blend_plain.needed_blocks(tb.tile_count))
            attrs = blend_plain.pack_gaussian_attrs(pre)
            for max_blocks in (0, max(need // 2, 1)):
                count = cuda_blend.visited_count(tb, max_blocks)
                tile_out, _ = cuda_blend.blend_tile_out(attrs, tb, count, ty, tx, tile)
                g = torch.randn(tile_out.shape, generator=gen, device=dev)
                g[..., 10:] = 0.0
                h = hold_backward(attrs, tb, count, tile_out, g, ty, tx, tile, max_blocks,
                                  f"small backward, {label}, tile={tile} max_blocks={max_blocks}")
                print(f"[small-bwd] {label} tile={tile} max_blocks={max_blocks} (needs {need}): "
                      f"{hold_report(h)}")
    ts, batches, cfg = toy_train_problem(dev)
    pcfg = dataclasses.replace(cfg, raster=dataclasses.replace(cfg.raster, backend="plain"))
    k, p = ts, ts
    for step in range(3):
        k, mk = tl.train_step(k, batches[step], cfg)
        p, mp = tl.train_step(p, batches[step], pcfg)
        lk, lp = float(mk["total"]), float(mp["total"])
        check(abs(lk - lp) <= 1e-3 * abs(lp), f"train step {step}: loss blend {lk} plain {lp}")
        check(float(mk["step_ok"]) == 1.0 and float(mp["step_ok"]) == 1.0, f"train step {step}: step_ok")
        note = ""
        if step == 0:  # Adam's first moment after one step is 0.1·grad
            worst = 0.0
            for name, a, b in zip(k.opt.m._fields, k.opt.m, p.opt.m):
                e = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)
                check(e <= STEP_GRAD_TOL, f"train step 0: {name} gradient normalised err {e:.3e}")
                worst = max(worst, e)
            note = f"; first-step gradients max normalised err {worst:.3e} (tol {STEP_GRAD_TOL})"
        print(f"[small-train] step {step}: loss blend {lk:.6f} plain {lp:.6f}{note}")


def trainable_state(scene, capacity, spatial_lr_scale, seed=0):
    """The scene as a GaussianState through the inverse activations (log
    scale, logit opacity, the quaternion and SH as they are), with seeded
    numpy noise on sh_dc, the opacity logits and xyz; 1% of the rows get an
    opacity logit of -8, below densify's prune threshold. Rows past N are
    dead (model.gaussians.state_from_rows)."""
    from hidegs_tpu_torch.model.gaussians import GaussianParams, state_from_rows

    dev = scene.means3d.device
    N = scene.means3d.shape[0]
    rng = np.random.default_rng(seed)

    def noise(shape, std):
        return torch.as_tensor(rng.normal(0.0, std, shape).astype(np.float32), device=dev)

    logit = torch.log(scene.opacities / (1.0 - scene.opacities)) + noise((N,), 0.5)
    faint = torch.as_tensor(rng.random(N) < 0.01, device=dev)
    logit = torch.where(faint, torch.full_like(logit, -8.0), logit)
    rows = GaussianParams(
        xyz=scene.means3d + noise((N, 3), 0.005),
        sh_dc=scene.shs[:, 0] + noise((N, 3), 0.3),
        sh_rest=scene.shs[:, 1:],
        scaling=torch.log(scene.scales),
        rotation=scene.quats,
        opacity=logit,
    )
    return state_from_rows(rows, capacity, spatial_lr_scale, active_sh_degree=3)


def render_image(g, cam, cfg, rows=None):
    """The clipped image of state `g`, or of its rows in the mask `rows`
    alone, and the alpha plane."""
    from hidegs_tpu_torch.raster.api import render

    opac = g.opacities if rows is None else torch.where(rows, g.opacities, torch.zeros_like(g.opacities))
    with torch.no_grad():
        out = render(g.params.xyz, g.scales, g.quats, opac, g.shs_flat, cam,
                     active_sh_degree=g.active_sh_degree, config=cfg)
    return torch.clamp(out["render"], 0.0, 1.0), out["alpha"]


def mean_psnr(ts, cams, targets, cfg):
    from hidegs_tpu_torch.train.losses import psnr

    vals = [float(psnr(render_image(ts.gaussians, cam, cfg)[0], gt)) for cam, gt in zip(cams, targets)]
    return float(np.mean(vals)), vals


def train_leaves(ts):
    g = ts.gaussians
    return (list(g.params) + list(ts.opt.m) + list(ts.opt.v)
            + [ts.opt.step, g.alive, g.grad_max, g.grad_abs_max, g.max_radii2d, ts.exposure, ts.step])


def phase_train(scene, cams, cfg):
    """The training path at full width; launch counts read around it."""
    import dataclasses

    from hidegs_tpu_torch.raster.api import render, round_budget
    from hidegs_tpu_torch.train import loop as tl

    dev = scene.means3d.device
    t0 = time.perf_counter()
    with torch.no_grad():
        targets = [render(*scene, cam, active_sh_degree=3, config=cfg)["render"] for cam in cams]
    # the reference's cameras_extent: 1.1 x the largest camera distance from
    # the cameras' mean centre; the spatial learning rate and densify's
    # percent_dense both scale with it
    centres = torch.stack([cam.camera_center for cam in cams])
    extent = float(1.1 * (centres - centres.mean(0)).norm(dim=1).max())
    N = scene.means3d.shape[0]
    capacity = -(-int(1.25 * N) // 1024) * 1024
    ts = tl.init_train_state(trainable_state(scene, capacity, extent), num_images=len(cams))
    # headroom over the render budgets: noise and densify change the load
    rcfg = dataclasses.replace(cfg, max_instances=round_budget(int(cfg.max_instances * 1.5)),
                               max_blocks=-(-int(cfg.max_blocks * 1.5) // 256) * 256)
    tcfg = tl.TrainConfig(raster=rcfg, freq_warmup=0, single_view_from=0, densify_from=1,
                          densify_until=DENSIFY_AT, densify_interval=DENSIFY_AT)
    batches = [tl.ViewBatch(cam=cam, image=gt, image_idx=torch.tensor(i, device=dev))
               for i, (cam, gt) in enumerate(zip(cams, targets))]
    # PSNR and the densify round's footprints are read from renders with the
    # exact (tile, depth) sort: the quantized sort scales depth by the range
    # of the visible instances, so a round that moves that range reorders
    # rows it never touched
    pcfg = dataclasses.replace(rcfg, depth_sort_bits=0)
    psnr0, views0 = mean_psnr(ts, cams, targets, pcfg)
    alive0 = int(ts.gaussians.alive.sum())
    print(f"[train] capacity {capacity}, alive {alive0}, extent {extent:.3f}, max_instances "
          f"{rcfg.max_instances}, max_blocks {rcfg.max_blocks}; mean PSNR before {psnr0:.4f} dB "
          f"(views {', '.join(f'{v:.3f}' for v in views0)}) (set-up {time.perf_counter() - t0:.1f} s)")

    reset_counts()
    t0 = time.perf_counter()
    metrics, rounds = [], []
    for k in range(TRAIN_STEPS):
        ts, m = tl.train_step(ts, batches[k % len(batches)], tcfg)
        metrics.append(m)
        before = ts
        ts, info = tl.maybe_host_side_schedule(ts, tcfg, extent, step=k + 1)
        if info is not None:  # states are not updated in place: keep both sides
            rounds.append((k + 1, info, before, ts))
    launches = read_counts()
    wall_s = time.perf_counter() - t0
    print(f"[train] {TRAIN_STEPS} steps in {wall_s:.2f} s host wall; launches on the train path: {launches}")
    check(launches == {"blend_fwd": TRAIN_STEPS, "blend_bwd": TRAIN_STEPS, "fold_rows": TRAIN_STEPS},
          f"train path launches {launches}, expected one of each kernel per step")
    for k, m in enumerate(metrics):
        check(bool(torch.isfinite(m["total"])), f"train step {k}: loss {float(m['total'])}")
        check(float(m["step_ok"]) == 1.0, f"train step {k}: step_ok {float(m['step_ok'])}")
        for key in ("overflow", "block_overflow", "visible_overflow"):
            check(int(m[key]) == 0, f"train step {k}: {key} = {int(m[key])}")
    print("[train] losses: " + ", ".join(f"{float(m['total']):.5f}" for m in metrics))
    check([r[0] for r in rounds] == [DENSIFY_AT], f"densify rounds ran at {[r[0] for r in rounds]}")
    _, info, pre_round, post_round = rounds[0]
    print(f"[train] densify at step {DENSIFY_AT}: " + ", ".join(f"{k} {float(v):.6g}" for k, v in info.items()))
    psnr_pre, psnr_post = phase_densify_round(pre_round, post_round, cams, targets, pcfg, tcfg)
    del pre_round, post_round, rounds
    psnr1, views1 = mean_psnr(ts, cams, targets, pcfg)
    print(f"[train] mean PSNR: before {psnr0:.4f} dB, step {DENSIFY_AT} before the round {psnr_pre:.4f}, "
          f"after it {psnr_post:.4f}, step {TRAIN_STEPS} {psnr1:.4f} "
          f"(views {', '.join(f'{v:.3f}' for v in views1)})")
    check(psnr_pre > psnr0, f"mean PSNR did not rise before the round: {psnr0:.4f} -> {psnr_pre:.4f}")
    check(psnr1 > psnr_post, f"mean PSNR did not rise after the round: {psnr_post:.4f} -> {psnr1:.4f}")

    # two runs of one step from the same cloned state
    clone = ts._replace(gaussians=ts.gaussians._replace(params=type(ts.gaussians.params)(
        *(x.clone() for x in ts.gaussians.params))))
    a, _ = tl.train_step(clone, batches[0], tcfg)
    b, _ = tl.train_step(clone, batches[0], tcfg)
    for i, (x, y) in enumerate(zip(train_leaves(a), train_leaves(b))):
        check(torch.equal(x, y), f"two train steps from one state differ in leaf {i}")
    print("[train] two steps from one cloned state: params, moments, stats bitwise equal")
    return dict(ts=ts, tcfg=tcfg, batches=batches, launches=launches, psnr=(psnr0, psnr1))


def phase_densify_round(pre_round, post_round, cams, targets, cfg, tcfg):
    """What the densify round did and what it cost. Checks that the alive
    count changed, every value stays finite, the rows it did not split,
    clone or prune keep their parameters to the bit, and each view's image
    changed only where the rows it changed are drawn (their footprint: the
    pixels where one of them is kept, before or after the round). Prints
    the split rows' screen radii and scales, how many are structure rows,
    and each view's PSNR before and after. Returns the two mean PSNRs."""
    from hidegs_tpu_torch.train.losses import psnr

    g0, g1 = pre_round.gaussians, post_round.gaussians
    a0, a1 = int(g0.alive.sum()), int(g1.alive.sum())
    check(a1 != a0, "the densify round left the alive count unchanged")
    for name, x in zip(g1.params._fields, g1.params):
        check(bool(torch.isfinite(x[g1.alive]).all()), f"densify round: non-finite {name} in an alive row")
    split = g0.alive & g1.alive & (g1.params.scaling != g0.params.scaling).any(-1)
    new = g1.alive & ~g0.alive
    pruned = g0.alive & ~g1.alive
    kept = g1.alive & ~split & ~new
    for name, x0, x1 in zip(g0.params._fields, g0.params, g1.params):
        check(torch.equal(x0[kept], x1[kept]), f"densify round changed {name} of rows it did not touch")
    radii = g0.max_radii2d[split]
    scale = torch.exp(g0.params.scaling[split]).amax(-1)
    q = torch.tensor([0.5, 0.9, 1.0], device=radii.device)
    n_struct = int(split[N_GROUND:].sum())
    shrink = float(np.log(tcfg.densify.split_n * tcfg.densify.split_scale_div))
    print(f"[densify] alive {a0} -> {a1}: {int(split.sum())} rows split ({n_struct} of them structure "
          f"rows, index >= {N_GROUND}), {int(new.sum())} new rows, {int(pruned.sum())} pruned; split rows' "
          f"max screen radius p50/p90/max {', '.join(f'{float(v):.0f}' for v in torch.quantile(radii, q))} px "
          f"(all alive rows p50 {float(g0.max_radii2d[g0.alive].median()):.0f}), largest scale p50/p90/max "
          f"{', '.join(f'{float(v):.4f}' for v in torch.quantile(scale, q))}; a child's log-scale sits "
          f"{shrink:.3f} under its parent's, and Adam moves it by at most about scaling_lr = "
          f"{tcfg.lr.scaling_lr} a step: >= {shrink / tcfg.lr.scaling_lr:.0f} steps to regrow")
    before, after = [], []
    for i, (cam, gt) in enumerate(zip(cams, targets)):
        img0, _ = render_image(g0, cam, cfg)
        img1, _ = render_image(g1, cam, cfg)
        _, foot0 = render_image(g0, cam, cfg, rows=split | pruned)
        _, foot1 = render_image(g1, cam, cfg, rows=split | new)
        foot = (foot0 > 0) | (foot1 > 0)
        change = (img1 - img0).abs().amax(0)
        outside = float(torch.where(foot, torch.zeros_like(change), change).max())
        d_se = ((img1 - gt) ** 2 - (img0 - gt) ** 2).sum(0)
        inside = float(d_se[foot].sum()) / (float(d_se.sum()) + 1e-30)
        check(outside == 0.0, f"densify round, view {i}: the image changed by {outside:.3e} outside the "
                              f"footprint of the rows the round changed")
        before.append(float(psnr(img0, gt)))
        after.append(float(psnr(img1, gt)))
        print(f"[densify] view {i}: PSNR {before[-1]:.4f} -> {after[-1]:.4f} dB; the changed rows' footprint "
              f"covers {float(foot.float().mean()):.4f} of the pixels and holds {inside:.4f} of the squared-"
              f"error change; max change outside it {outside:.3e}")
    return float(np.mean(before)), float(np.mean(after))


def find_node(root, name):
    """The first node of class `name` in the autograd graph under `root`."""
    seen, stack = set(), [root]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        if type(node).__name__ == name:
            return node
        seen.add(node)
        stack.extend(fn for fn, _ in node.next_functions)
    raise AssertionError(f"no {name} node in the step's graph")


def blend_backward_inputs(ts, batch, tcfg):
    """One step's forward and backward (train_step's own stages) with a
    pre-hook on the blend's autograd node, which keeps what the node's
    backward is given: the packed rows, the tile planes, the binning, the
    visited counts and the planes' cotangents."""
    from hidegs_tpu_torch.train import loop as tl

    loss, _, inputs = tl.step_forward(ts, batch, tcfg)
    node = find_node(loss.grad_fn, "BlendPackedBackward")
    got = {}

    def keep(grad_outputs):
        attrs, tile_out = (x.detach() for x in node.saved_tensors)
        got.update(attrs=attrs, tile_out=tile_out, g_tiles=grad_outputs[0].contiguous(), tb=node.binning,
                   count=node.count, args=node.args)

    handle = node.register_prehook(keep)
    tl.step_backward(loss, inputs)
    handle.remove()
    check(bool(got), "the blend's backward did not run")
    return got


def phase_hold_train(train):
    ts, tcfg = train["ts"], train["tcfg"]
    b = blend_backward_inputs(ts, train["batches"][0], tcfg)
    ty, tx, tile, max_blocks = b["args"]
    h = hold_backward(b["attrs"], b["tb"], b["count"], b["tile_out"], b["g_tiles"], ty, tx, tile, max_blocks,
                      "full-width backward, view 0")
    print(f"[hold-bwd] view 0, trained state, the cotangents one train step gives its blend: backward + fold "
          f"kernels vs blend_tiles_bwd + plain fold: {hold_report(h)}")
    return dict(tb=b["tb"], ty=ty, tx=tx, **h)


def phase_train_times(train, held):
    from hidegs_tpu_torch.raster import blend_plain, cuda_blend
    from hidegs_tpu_torch.train import loop as tl

    ts, tcfg, batch = train["ts"], train["tcfg"], train["batches"][0]
    step_ms = time_ms(lambda: tl.train_step(ts, batch, tcfg))

    # train_step's three stages, its own functions timed between CUDA events
    def stages():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, aux, inputs = tl.step_forward(ts, batch, tcfg)
        ev[1].record()
        grads = tl.step_backward(loss, inputs)
        ev[2].record()
        tl.step_update(ts, batch, tcfg, loss, aux, grads)
        ev[3].record()
        ev[3].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]

    for _ in range(WARMUP):
        stages()
    split = [statistics.median(x) for x in zip(*(stages() for _ in range(ITERS)))]
    print(f"[train-times] train step {step_ms:.3f} ms (CUDA events, median of {ITERS}); stages: "
          f"step_forward (forward+loss) {split[0]:.3f} ms, step_backward {split[1]:.3f} ms, "
          f"step_update (Adam+stats) {split[2]:.3f} ms")

    tb, ty, tx = held["tb"], held["ty"], held["tx"]
    attrs, count, g_aug, rows_exp = held["attrs"], held["count"], held["g_aug"], held["rows_exp"]
    tile, P = tcfg.raster.tile, tcfg.raster.tile ** 2
    I, N, T = tb.gauss_id.shape[0], attrs.shape[0], ty * tx
    rows = torch.zeros((I, cuda_blend.ATTR), device=attrs.device)

    def launch_bwd():
        rows.zero_()
        cuda_blend.launch_blend_bwd(attrs, tb.gauss_id, tb.tile_start, count, tx, tile, g_aug, rows)

    bwd_ms = time_ms(launch_bwd)
    view = blend_plain.unpack_attrs(attrs)
    bwd_plain_ms = time_ms(lambda: blend_plain.blend_tiles_bwd(view, tb, g_aug, ty, tx, tile,
                                                               tcfg.raster.max_blocks))
    folded = torch.empty((N, cuda_blend.ATTR), device=attrs.device)
    g_start = tb.g_start.contiguous()
    fold_ms = time_ms(lambda: cuda_blend.launch_fold_rows(rows_exp, g_start, folded))
    fold_plain_ms = time_ms(lambda: blend_plain.fold_rows(rows_exp, g_start))
    zeros = torch.zeros((N + 1, cuda_blend.ATTR), device=attrs.device)
    owner = tb.owner.long()
    fold_library_ms = time_ms(lambda: zeros.index_add_(0, owner, rows_exp))
    same = torch.equal(folded, blend_plain.fold_rows(rows_exp, g_start))

    post_cull = int(count.sum())
    unique_rows = int(torch.unique(tb.gauss_id[:post_cull]).numel())
    counts = blend_plain.pair_counts(view, tb, tx, tile, tcfg.raster.max_blocks)
    bwd_bytes = post_cull * 4 + 2 * T * 4 + unique_rows * 64 + T * P * 48 + I * 64
    bound = blend_bound(bwd_bytes, counts, tile, BWD_OPS_PER_LIVE_PAIR, BWD_OPS_PER_KEPT_PAIR,
                        BWD_SFU_PER_KEPT_PAIR)
    total = int(tb.num_instances.clamp(max=I))
    fold_bound = (total * 64 + (N + 1) * 4 + N * 64) / HBM_BYTES_S * 1e3
    print(f"[train-times] backward kernel {bwd_ms:.3f} ms, plain {bwd_plain_ms:.3f} ms; {bound['text']}; "
          f"kernel at {bound['bound_ms'] / bwd_ms:.1%} of the bound, {bound['yardstick_ms'] / bwd_ms:.1%} of the "
          f"yardstick (post-cull instances {post_cull}, pairs live {counts[0]} kept {counts[1]} open {counts[2]})")
    print(f"[train-times] fold kernel {fold_ms:.3f} ms, plain (segment_reduce, float32) {fold_plain_ms:.3f} ms "
          f"(bitwise equal to the kernel: {same}), index_add_ {fold_library_ms:.3f} ms; bound "
          f"{fold_bound:.4f} ms (bytes: {total} expansion rows in, {N} rows out); kernel at "
          f"{fold_bound / fold_ms:.1%} of it")
    print(f"[train-times] backward: {mask_report(view, tb, tx, tile, count, counts[0])}; ptxas (build log): "
          f"{usage_report(ptxas_usage(cuda_blend.build()['blend_bwd']))}")
    profile_device(lambda: tl.train_step(ts, batch, tcfg), "train-breakdown")
    return dict(step_ms=step_ms, split=split,
                bwd=dict(ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bound["bound_ms"], bound_by=bound["bound_by"]),
                fold=dict(ms=fold_ms, plain_ms=fold_plain_ms, bound_ms=fold_bound, bound_by="bytes",
                          library_ms=fold_library_ms))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    phase_environment()
    phase_small(dev)
    phase_small_backward(dev)
    scene, cams, cfg = full_width_setup(dev)
    render_launches, outs = phase_full_width(scene, cams, cfg)
    pre, tb, err = phase_hold_full_width(scene, cams, cfg, outs)
    times = phase_times(scene, cams[0], cfg, pre, tb)
    phase_breakdown(scene, cams[0], cfg, pre, tb)
    del outs, pre, tb
    train = phase_train(scene, cams, cfg)
    held = phase_hold_train(train)
    ttimes = phase_train_times(train, held)
    launches = train["launches"]
    by_path = {name: {"render": render_launches[name], "train": launches[name]} for name in launches}
    kernels = [{
        "name": "blend_fwd",
        "route": "cuda",
        "source": "hidegs_tpu_torch/raster/csrc/blend_fwd.cu",
        "replaces": "hidegs_tpu/raster/pallas_blend.py:326",
        "launches": launches["blend_fwd"],
        "launches_by_path": by_path["blend_fwd"],
        "max_abs_err": err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this blend
    }, {
        "name": "blend_bwd",
        "route": "cuda",
        "source": "hidegs_tpu_torch/raster/csrc/blend_bwd.cu",
        "replaces": "hidegs_tpu/raster/pallas_vjp.py:61",
        "launches": launches["blend_bwd"],
        "launches_by_path": by_path["blend_bwd"],
        "max_abs_err": held["err"],
        "ms": ttimes["bwd"]["ms"],
        "plain_ms": ttimes["bwd"]["plain_ms"],
        "bound_ms": ttimes["bwd"]["bound_ms"],
        "bound_by": ttimes["bwd"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this backward
    }, {
        "name": "fold_rows",
        "route": "cuda",
        "source": "hidegs_tpu_torch/raster/csrc/blend_bwd.cu",
        # the instance-to-gaussian segment sum after the TPU backward kernel
        "replaces": "hidegs_tpu/raster/pallas_vjp.py:455",
        "launches": launches["fold_rows"],
        "launches_by_path": by_path["fold_rows"],
        "max_abs_err": held["fold_err"],
        "ms": ttimes["fold"]["ms"],
        "plain_ms": ttimes["fold"]["plain_ms"],
        "bound_ms": ttimes["fold"]["bound_ms"],
        "bound_by": ttimes["fold"]["bound_by"],
        "library_ms": ttimes["fold"]["library_ms"],  # index_add_ (atomics: not deterministic)
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
