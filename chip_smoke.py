#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (hidegs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's paths at full width — rendering
(`hidegs_tpu_torch.raster.api.render`, the hand-written CUDA forward blend;
eager, and replayed as a CUDA graph by `raster.compiled.CompiledRender`,
as the serving entry points and the viewers replay it),
the LOD hierarchy (`hier.interp.AdaptiveHierRenderer`: cut select,
interpolation, then the forward blend, once per frame, eager and replayed
as a CUDA graph by `hier.interp.CompiledLodFrame`), its post-optimizer
(`train.hier_trainer.post_optimize`: a forward blend, a backward blend
and a fold per step, on the compiled step `CompiledHierTrainStep`),
serving a trained
scene (`python -m hidegs_tpu_torch.evaluate` and `render_cli`, with and
without `--hierarchy`, which reach the forward blend once per view), the
viewers (`python -m hidegs_tpu_torch.viewer`'s HTTP and SIBR frontends),
training (`hidegs_tpu_torch.train.loop.train_step`, which adds the CUDA
backward blend and the gradient fold kernel, eager and compiled into one
CUDA graph per static key by `train.compiled.CompiledTrainStep`), and the
scene trainer
(`python -m hidegs_tpu_torch.train`, two blends forward and backward per
multi-view step), the large-scene pipeline (`python -m
hidegs_tpu_torch.pipeline`: chunking, a coarse model, the chunks in worker
processes, merge, post-opt, the τ sweep), and the view-parallel trainer
(`parallel.sharded.make_dp_train_step`: four views a step, a forward
blend, a backward blend and a fold per view, the gradients summed by one
collective; one rank, a one-rank NCCL group, two gloo ranks on the card,
and `python -m hidegs_tpu_torch.parallel`; eager and compiled into one
CUDA graph per static key by `parallel.compiled.CompiledDPStep`) — and
holds every kernel of those
paths, and the bf16
attribute-stream mode of both blends, against its plain PyTorch version.
Phases (run in the order of `main`):

  1. environment: card name and power limit, versions, the kernel builds
     (one nvcc per source, started together, with the scalar fold of
     tools/csrc/fold_rows_scalar.cu that phase 11 times beside the fold);
 1a. masked Adam: the kernel (model/csrc/masked_adam.cu) at the post-opt
     cell's 2,020,479 rows with packed gradients and at the train step's
     row budget 2^21 (a prefix of longer buffers), all rows and about half
     in the mask, out of place and in place: one launch a call, bitwise
     masked_adam_plain, the inputs (out of place) and the rows past the
     prefix (in place) untouched; the kernel alone in turns with the plain
     body at both shapes, beside its bytes bound; ptxas registers;
  2. small: toy scenes, tile 16 and 32, render_geo on and off, and the
     mask boundary scene (make_blend_boundary_scene: level sets that end on
     the kernels' 8x4 mask blocks) with and without a too-small max_blocks,
     forward kernel ("blend") against plain: planes at atol 3e-4 / rtol
     1e-3, out_observe exactly equal;
  3. small backward: the same scenes, tile 16 and 32, with and without a
     too-small max_blocks: backward + fold kernels against blend_tiles_bwd
     + the plain fold (`hold_grads`), the fold kernel against the plain
     fold in float64 (`hold_fold`) and bitwise against the plain fold in
     float32; then 3 train steps with the "blend" backend against 3 with
     the "plain" one;
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
 5p. the preprocess forward kernel (csrc/preprocess.cu, preprocess_fwd) on
     the four views against preprocess_plain on the same inputs, one launch
     per call: floats at atol 1e-5 / rtol 1e-5, the radius within 1 on at
     most 1% of the rows, the visible mask differing only where the radius
     does, two launches bitwise equal; view 0's kernel timed alone beside
     the plain forward and its bound (bytes);
  6. render breakdown: preprocess, binning and blend timed alone, and one
     render under torch.profiler for the device busy share, the top
     kernels and the device ops by kind (every profile prints them: the
     accumulation adds, scans, fills, copies and the port's kernels);
 6r. the compiled render (raster/compiled.py:CompiledRender, what evaluate,
     render_cli and the viewers replay on a card) in the render cell's
     configuration (render_geo) and the serve one (tile 16, render_cli's
     budget, no block cap, the two-key sort) on the four views; launch
     counts are read around those eight calls: one replayed forward launch
     per view, the warm-up's per capture (two). Checks: every key of every
     view bitwise the eager render, no overflow, replays under
     set_sync_debug_mode("error"). Prints per configuration, on view 0,
     eager and compiled ms in turns (CUDA events, median of 10 after 2),
     the host ms per compiled call split into the lookup (of it the key),
     the copy-in and the replay, one call of each mode under the profiler,
     the warm-up and capture seconds and the pool's growth. Then the KNN
     scale init (model/knn.py:initial_scales) on the 1,010,240 means: no
     host sync, within 1e-5 (relative) of the CPU on 100,000 of them, ms
     (CUDA events) and the device busy share;
 6a. hierarchy: the scene through the port's native builder (compiled with
     g++ from hidegs_tpu_torch/hier/native/hier_builder.cpp into
     build/hier/) on the host: seconds, points, nodes; written as .hier and
     read back equal. AdaptiveHierRenderer on the card renders every view
     at every tau of LOD_TAUS (0, 3, 6, 15 px), eager (`compiled` None) and
     then compiled (the default: each frame a CompiledLodFrame replay,
     cloned before the next); launch counts are read around each run:
     exactly one cut-and-render call and one forward blend per frame
     (eager: through the launcher; compiled: replayed, and the warm-up's
     launch once per capture; a re-expansion or a regrow fails it).
     Checks: the compiled frames bitwise the eager ones (every key), with
     the same cuts and budgets; the tau=0 cut is exactly the 1,010,240
     leaves and its frames are within PSNR >= 40 dB of the leaf render;
     cut sizes do not rise with tau; num_selected equals the count pass;
     the eager tau=6 frame's forward kernel against the plain blend on the
     frame's own rows and binning at phase 4's gates; two eager and two
     compiled tau=6 frames bitwise equal; the interpolation forward kernel
     on the eager tau=6 frame's cut (through interpolate_cut) bitwise
     interpolate_plain; no overflow. Prints the cut,
     budget and instances per view and tau, ms per LOD frame of both modes
     (CUDA events, median of 10 after 2 warm-ups), the host ms per compiled
     frame, the four stages (count, select, interpolate, render) timed
     alone, one frame of each mode under the profiler at tau 0 and 6, and
     each capture's seconds and pool growth;
 6b. post-opt: phase 6a's hierarchy with every SH coefficient scaled by
     0.7, `post_optimize` for 30 steps on the four views (targets: phase
     4's leaf renders, clipped) at the τ=6 cut (budget 2^21, interpolated
     parents), exposure trained, tile 32, an instance budget from a probe
     with 1.12x slack. On the card it runs the compiled step (a cut
     replay and a step replay per iteration); every iteration is held
     against the eager select_cut and hier_train_step on the same inputs,
     with the launches of both read around each call and the budget
     counters taken from the graph's outputs. Checks: the cut, the state
     and the metrics bitwise the eager ones after every step; per step one
     eager launch of each kernel and one replayed, the warm-up's once per
     capture; every replay but the first under
     set_sync_debug_mode("error"); finite losses, no overflow, the τ-cut
     PSNR (mean of the views) above the perturbed start's; the last step's
     blend node held against the plain versions on its own rows, binning
     and cotangents (forward planes and observe at phase 4's gates,
     backward + fold with `hold_backward`); the last step's interpolation
     node (`hold_interp`: its cut, B = 2^21 slots over the 2,020,479 rows,
     and the render's gradients of its five outputs): both kernels bitwise
     interpolate_plain and interp_plain_bwd, one launch a call, the node's
     gradient of the rows bitwise the plain rows' sorted sums, both kernels
     timed in turns with their plain versions beside their bytes bounds
     (`interp_bytes`: each distinct row read once); two eager steps from one state
     bitwise equal; an eager step and three compiled iterations under
     set_sync_debug_mode("error"); hierarchy_from_state written as .hier
     and read back equal. Prints ms per step of both modes (CUDA events,
     median of 10 after 2 warm-ups) with the eager stages (select, forward,
     backward, update), the host ms per compiled iteration, each capture's
     seconds and pool growth, one step of each mode under the profiler,
     and the peak device memory;
  7. serve at full width: the port's write_synthetic_colmap_scene writes
     the four views as a COLMAP scene (the ground truth is the 8-bit image
     of the model), the model is written as point_cloud/iteration_30000/
     point_cloud.ply with a cfg_args.json (raster_backend "pallas", tile
     16, render_cli's tile, and render_cli's budget), then `evaluate.main`
     (--eval: view 0 is the test set) and `render_cli.main` serve it;
     launch counts are read around those two calls alone. Both render
     through a CompiledRender (one each, a capture each). Checks: PSNR >=
     50 dB and SSIM >= 0.99 per view, finite LPIPS, both sets and
     lpips_kind in results.json, render_cli's PNGs equal to evaluate's,
     every served image (a replay) bitwise the eager render of its inputs,
     the eager render of render_cli's view 0 (tile 16) held against the
     plain blend as in phase 4, one replayed forward launch per served
     view and the warm-up's per capture, no budget overflow, every tensor
     of the path on the card. Prints the seconds of each step, the ms per
     evaluated view split into render (the first view's, with the capture,
     and the replays'), LPIPS, image I/O and the rest, each capture's cost,
     and whether Pillow imports; then `render_cli --hierarchy
     <the scene's .hier> --tau 6` on the same scene: ms per view, exactly
     one compiled cut-and-render call and one replayed forward launch per
     PNG, and the warm-up's launch per capture, counted on the compiled
     hierarchy path. evaluate's LPIPS is the compiled one
     (train/lpips.py:CompiledLpips), held bitwise against the eager
     distance on two full-width renders: ms of both, the host ms per
     compiled call, one call of each under the profiler;
 7a. viewers: `python -m hidegs_tpu_torch.viewer`'s render function behind
     both frontends, one 1920x1088 frame each over localhost (HttpViewer on
     port 0 fetched with urllib, NetworkGUI with a socket client speaking
     the SIBR protocol), a second HTTP frame at another yaw; the render
     function replays a CompiledRender, captured in the HTTP handler
     thread; each frame's pixels equal render()'s image of the same
     camera, clipped and quantised; one replayed forward launch per frame
     and the warm-up's per capture;
  8. training at full width: the four rendered views are the targets; the
     trainable state is the scene through the inverse activations, seeded
     noise on sh_dc, opacity logits and xyz, capacity 1.25x. 30 train steps
     cycling the views, default TrainConfig but freq_warmup=0,
     single_view_from=0 and one densify round of the reference's rules
     after step 10, replayed from the compiled pair
     (train/compiled.py:CompiledDensify; so are the scrubs after the
     window) and held bitwise against the eager round on the same draws,
     both timed; launch counts are read around this run alone. Checks:
     finite losses, step_ok, no overflow, mean PSNR up over the steps
     before the round and over those after it, one launch of each kernel
     per step, two runs of one step bitwise equal;
  9. the densify round: the alive count changes, every value stays finite,
     the rows it did not split, clone or prune keep their parameters to the
     bit, and the images change only where the rows it changed are drawn;
     prints what it split (screen radii, scales, structure or ground rows)
     and the PSNR it cost in each view;
 10. full-width hold: view 0's backward + fold kernels against the plain
     versions, on the cotangents one train step gives its blend;
 10p. the preprocess backward kernel (preprocess_bwd) on the cotangents one
     train step gives the PreprocessFn node: its gradients against torch
     autograd of preprocess_plain on the node's inputs, within 5e-3 of each
     leaf's max |grad|; one backward launch in the step; the kernel timed
     alone beside the plain closed-form backward (preprocess_plain_bwd)
     and its bound (bytes);
 10a. B3, the bf16 attribute stream, through the path a user turns on:
     RasterConfig(bf16_stream=True) in render() on the render cell's view 0
     with the loss of the JAX package's bf16 test, mean(render²), and in
     train_step's forward and backward on phase 8's trained state (the full
     loss stack); one launch of each kernel for the render and its
     backward. Each BlendPacked node is held against the plain bf16
     versions on its own rows, binning and cotangents (the rows it saved
     are bf16_rows of the packed rows; planes at phase 4's gates; d_attrs
     with hold_backward), and its planes and d_attrs are bitwise the
     launchers'. bf16 against float32 on the render cell at the JAX
     tolerances: rgb within 0.03, the means' and opacities' gradients
     within 5e-2 of their max. On the train cell the packed gradients of
     both modes on the same cotangents, per column against the float32
     column's max: within 5e-2 with the distance plane's cotangent zeroed
     and with all geometric planes' (invdepth, normal, distance) zeroed;
     with the whole cotangents printed, with the worst gaussians (C12).
     Both modes timed in turns (f32, bf16, bf16, f32) one launch at a
     time, with the bf16 bounds;
 11. train times: the step, split into train_step's own stages
     (step_forward / step_backward / step_update), the backward and fold
     kernels alone, their plain versions and bounds, the backward's mask
     share, evaluated pairs, registers and spills (as in phase 5), the fold
     against the scalar fold path it replaced (the sorted rows scattered by
     blend_plain.expansion_rows, then the scalar fold) in turns and
     bitwise, and one step under torch.profiler;
 11a. the compiled train step (train/compiled.py: one CUDA graph per
     static key, replayed) beside the eager one from the train cell's
     fresh state: 30 single-view steps, 30 multi-view steps (each view with
     its row neighbour as the source, the same injected samples for both),
     5 steps each with use_exposure, a row budget below the capacity and
     visible-row compaction, all five keys in one CompiledTrainStep.
     Checks: after every step the states and the metrics bitwise equal;
     every replay under set_sync_debug_mode("error"); per replay the
     graph's 1 or 2 launches of each kernel, the warm-up's once per
     capture. Prints ms per step of both modes (CUDA events, median of 10
     after 2 warm-ups), host ms per replay, warm-up and capture seconds
     and the graph pool's growth per key, an eager step's peak allocation,
     and a single- and a multi-view step of each mode under the profiler;
 12. trainer at full width: the four views written as a COLMAP scene
     (write_synthetic_colmap_scene, point_stride 4: 252,560 sparse points;
     every view must have a neighbour), then `trainer.main` (`python -m
     hidegs_tpu_torch.train`) for 60 iterations on the card, on the
     compiled step: automatic capacity, no eval split, freq warm-up 0, the
     single-view term from 0, the multi-view terms (differentiable source)
     from iteration 21, one densify round at 30, checkpoints at 1 and 60.
     Launch counts are read around the trainer's train steps alone: one
     replayed launch of each kernel per single-view step, two per
     multi-view step (100 each), and a capture's warm-up step once more.
     Checks: finite losses, no step skipped by the finite-step gate, at
     least a fifth of the multi-view steps with valid samples (a pair that
     overlaps), the final state on the card, `evaluate.main` reads both
     checkpoints and the PSNR rises. Then the same run on the eager step
     (loop.train_step handed to the trainer), for its times in this call.
     Prints ms per trainer iteration of the single-view window (2-20) and
     the multi-view window (31-60) of both runs, host clock synchronised at
     the ends of each run of counted iterations (saves, the densify round
     and the iterations before a counter fetch left out), each capture's
     cost, and the init times;
 13. trainer hold, on the trained state and the view pair of the last
     multi-view iteration with valid samples: both BlendPacked nodes of
     the step (reference and source render) held against the plain
     versions on each node's own rows and binning: the forward tile planes
     and observe counts at phase 4's gates, the backward and fold with
     `hold_backward`; two multi-view steps from one state and
     generator bitwise equal, a step with the chunk box under
     torch.cuda.set_sync_debug_mode("error"), a multi-view and a
     single-view step timed eager and compiled, and a multi-view step of
     each under the profiler;
 14. pipeline: the JAX package's large-scene layout (the r5 record,
     benchmarks/largescene_run.py) at reduced depth:
     make_uav_gaussians(60,000, 96 structures, seed 7, extent 24) as a
     COLMAP scene from an 8x6 nadir grid at altitude 16 (48 views,
     256x256), then `pipeline.main` with 9 chunks (chunk size 18, at least
     4 cameras), capacity 65536, 200 coarse, 200 chunk and 100 post-opt
     iterations, 3 chunk workers on the card, τ 0/3/6/15. Seconds and
     parent-process launches per stage are read around each stage (the
     workers' launches are theirs). Checks: 9 chunks, finite chunk, merged
     and post-optimized hierarchies, the workers run the port on the
     card with the coarse scaffold and the chunk-box cull, one replayed
     launch of each kernel per coarse and post-opt step (both compiled; the
     interpolation's in the post-opt step only) and the warm-up's per
     capture, one forward blend and one interpolation forward per (τ, view)
     of the eval and nothing else in the parent,
     `hier.cli merge` bitwise merged.hier, `hier.cli create --cameras` on
     chunk 0, ChunkStreamer over the chunks, the mean cut not rising with
     τ. Prints the seconds per stage, the merged size, PSNR and cut per τ,
     the steps each chunk's finite-step gate skipped, and ms per post-opt
     step;
 15. view-parallel (parallel/sharded.py:make_dp_train_step) on phase 8's
     train cell, four views a step: (a) one rank, 10 steps with no process
     group and 10 in a one-rank NCCL group, float32 and on the bf16 wire;
     launch counts read around the no-group runs: 4 of each render kernel
     and one masked Adam per step. Checks: finite losses, mean PSNR up; each NCCL run bitwise its
     no-group run; the bf16 wire's first step within rtol 1e-4 of float32's
     loss and its xyz update at cosine > 0.99; two steps from one state
     bitwise equal; a V = 1 step on view 0 bitwise train_step's; one NCCL
     step under set_sync_debug_mode("error"); the four blend nodes of a step
     held against the plain versions (forward with hold_node_forward,
     backward and fold with hold_backward). Prints ms per step (no group,
     NCCL), the local forward + backward alone, the gradient all-reduce
     alone in float32 and bf16 with its bytes, the masked Adam update (and
     its kernel on the step's gradients, bitwise masked_adam_plain), one
     step under the profiler and the peak memory. (d) one step under
     utils.profiling.trace: the trace must name the three kernels and the
     range of a utils.profiling.span. The compiled step
     (parallel/compiled.py) beside the
     eager one, 10 steps each, from the same state: no group on both wires
     and a one-rank NCCL group on both (the all-reduces recorded in the
     graph); after every step both states and the metrics bitwise equal,
     every replay under set_sync_debug_mode("error"), launches exact (4 of
     each render kernel and one masked Adam per replay, as many per
     warm-up). Prints ms per step of both
     modes (no group, NCCL), the host ms per replay, both under the
     profiler, the capture and warm-up seconds, the pool and the eager
     step's peak. (b) two ranks on the card: whether NCCL takes them
     (a two-rank NCCL probe), then gloo on CUDA tensors, 3 steps on a
     (2, 1) mesh (two views a rank) and on a (1, 2) mesh (rows split, all
     views), each against (a)'s float32 run at tests/test_torch_train.py's
     tolerances, the ranks bitwise equal (digests of the whole state). (c)
     `python -m hidegs_tpu_torch.parallel --nproc 1 --backend nccl` and
     `--nproc 4 --backend gloo --device cuda` pass their asserts.

Every launch gate counts the eight kernels (chip_smoke.KERNEL_NAMES,
utils/graphs.py:ALL_KERNELS): a render launches a preprocess forward
beside its forward blend, a differentiated render a preprocess backward
beside its backward blend, every train, post-opt and view-parallel step
one masked Adam, every LOD frame, pipeline LOD eval view and post-opt step
one interpolation forward and every post-opt step one interpolation
backward (`per_kernel`); a render launches no masked Adam, a train step no
interpolation.
Prints a `{"kernels": [...]}` line and, last, the `{"ok": true, ...}` line.
In the kernels line, `ms`, `plain_ms`, `bound_ms` and `library_ms` come from
the render cell (phase 5: blend_fwd; 5p: preprocess_fwd), the train path
(phase 11: blend_bwd, fold_rows; 10p: preprocess_bwd) and phase 1a
(masked_adam: the post-opt cell's rows, with `in_place_ms` and the train
row budget's `train_ms` and `train_plain_ms` beside them) and phase 6b
(interp_fwd, interp_bwd: the last post-opt step's cut); `launches` is the train path's count (phase 8), as
in earlier slices; `launches_by_path` holds the count of every path (render,
render_compiled (phase 6r: replays and warm-ups), serve (replays and
warm-ups), train, train_compiled (phase 11a: replays and warm-ups), trainer,
hierarchy (the eager renderer), hierarchy_compiled (the compiled renderer
and render_cli --hierarchy: replays and warm-ups), viewer (replays and
warm-ups), post_opt (the
eager steps held beside post_optimize), post_opt_compiled (post_optimize's
replays and warm-up), pipeline, view_parallel (the eager no-group
float32 run), view_parallel_compiled (phase 15's compiled steps: replays
and warm-ups)); a replay of a captured
graph counts the launches it recorded (utils/graphs.py:REPLAY_LAUNCHES);
`max_abs_err` is the largest error of the kernel's full-width holds in
phases 4 and 6a (forward), 10 (backward, fold), 13 (all three, on both
nodes of a multi-view step), 6b (all three, the post-opt step) and 15
(all three, the four nodes of a view-parallel step) for the blends, and
5p (preprocess_fwd, with `radius_flips`: flipped rows and rows held) and
10p (preprocess_bwd, with `grad_err_of_max`) for the preprocess kernels;
masked_adam's is 0 (phases 1a and 15 hold it bitwise), and so are
interp_fwd's and interp_bwd's (phases 6a and 6b).
Each blend entry has a `bf16` object from
phase 10a: the bf16 mode's `ms` (median of its two turns), the float32
kernel's time in the same turns (`f32_ms_in_turns`), `plain_ms`,
`bound_ms`, `bound_by`, `max_abs_err` against the plain bf16 version, and
the bf16-against-float32 errors: `image_err` (rgb), `grad_err_vs_f32` (the
render cell's means3d and opacities gradients, gated at 5e-2) and
`train_grad_err_vs_f32` (the train cell's largest packed-column departure
per cotangent variant; gated at 5e-2 but with the whole cotangents).
Any failed check raises and exits non-zero. Without a CUDA device it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BLEND_TOL = dict(atol=3e-4, rtol=1e-3)  # the JAX suite's Pallas-vs-plain tolerance
KERNEL_NAMES = ("blend_fwd", "blend_bwd", "fold_rows", "preprocess_fwd", "preprocess_bwd",
                "masked_adam", "interp_fwd", "interp_bwd")  # utils/graphs.py:ALL_KERNELS
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
# profile_device's op kinds, by substrings of the device ops' names: autograd's
# accumulation adds, binning's scans (C40's cummax), fills, copies, and the
# port's kernels (the render's and the masked Adam)
OP_KINDS = (("adds", ("CUDAFunctor_add",)), ("scans", ("scan",)), ("fills", ("FillFunctor", "fill_kernel")),
            ("copies", ("copy_kernel", "Memcpy", "CatArrayBatchedCopy")), ("preprocess kernels", ("preprocess_",)),
            ("blend kernels", ("blend_fwd", "blend_bwd", "fold_rows")), ("adam kernel", ("masked_adam",)))
ROOT = Path(__file__).resolve().parent
# the fold design the package's fold kernel replaced, built and timed beside it
SCALAR_FOLD_SRC = ROOT / "tools" / "csrc" / "fold_rows_scalar.cu"
SERVE_ITER = 30_000
SERVE_MIN_PSNR, SERVE_MIN_SSIM = 50.0, 0.99
# the trainer phase: `python -m hidegs_tpu_torch.train` on the render cell's
# scene written as a COLMAP dataset; single-view steps up to
# TRAINER_MV_FROM - 1, then the multi-view terms with the differentiable
# source; one densify round at TRAINER_DENSIFY_AT
TRAINER_ITERS, TRAINER_MV_FROM, TRAINER_DENSIFY_AT = 60, 21, 30
TRAINER_SAVES = (1, TRAINER_ITERS)
# the share of multi-view steps whose view pair must overlap (valid samples,
# mv_geo > 0): only the pairs along a grid row share a footprint, and the
# trainer draws each view's source from its two neighbours, so about a
# quarter of the multi-view steps overlap
TRAINER_MIN_OVERLAP_SHARE = 0.2
# the timed windows (iterations, inclusive): single-view, and multi-view
# after the densify round
TRAINER_WINDOWS = {"single-view": (2, TRAINER_MV_FROM - 1), "multi-view": (TRAINER_DENSIFY_AT + 1, TRAINER_ITERS)}


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


def time_per_launch_ms(fn, launches=20, warmup=WARMUP, iters=ITERS):
    """Median over `iters` runs of `launches` back-to-back calls of `fn`
    between two CUDA events, per call: the device time of a short kernel,
    without the gap the host's enqueue leaves before a single launch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def reset_counts():
    from hidegs_tpu_torch.hier import interp_autograd
    from hidegs_tpu_torch.model import adam
    from hidegs_tpu_torch.raster import cuda_blend, preprocess_autograd
    from hidegs_tpu_torch.utils import graphs

    cuda_blend.LAUNCHES = cuda_blend.BWD_LAUNCHES = cuda_blend.FOLD_LAUNCHES = 0
    preprocess_autograd.FWD_LAUNCHES = preprocess_autograd.BWD_LAUNCHES = 0
    adam.LAUNCHES = 0
    interp_autograd.FWD_LAUNCHES = interp_autograd.BWD_LAUNCHES = 0
    graphs.REPLAY_LAUNCHES.update(dict.fromkeys(graphs.REPLAY_LAUNCHES, 0))


def direct_counts():
    """The launchers' own counts (kernel by kernel, KERNEL_NAMES' order),
    which a graph replay does not reach."""
    from hidegs_tpu_torch.hier import interp_autograd
    from hidegs_tpu_torch.model import adam
    from hidegs_tpu_torch.raster import cuda_blend, preprocess_autograd

    return (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES,
            preprocess_autograd.FWD_LAUNCHES, preprocess_autograd.BWD_LAUNCHES, adam.LAUNCHES,
            interp_autograd.FWD_LAUNCHES, interp_autograd.BWD_LAUNCHES)


def replay_counts():
    """The launches graph replays made (the compiled train step, post-opt
    step and LOD frame: utils/graphs.py's one count)."""
    from hidegs_tpu_torch.utils import graphs

    return tuple(graphs.REPLAY_LAUNCHES[k] for k in KERNEL_NAMES)


def read_counts():
    """Every launch since reset_counts: the launchers' and the replays'."""
    torch.cuda.synchronize()
    return dict(zip(KERNEL_NAMES, (a + b for a, b in zip(direct_counts(), replay_counts()))))


def per_kernel(fwd, bwd, steps=0, cuts=0, cut_grads=0):
    """The eight kernels' launches on a path where every render blends with
    the kernels: `fwd` renders (a forward blend and a preprocess forward
    each), `bwd` of them differentiated (a backward blend, a fold and a
    preprocess backward each), `steps` optimizer steps (one masked Adam
    each, whatever the views a step renders), and `cuts` interpolated LOD
    cuts (one interpolation forward each: a LOD frame, a post-opt step),
    `cut_grads` of them differentiated (one interpolation backward each: a
    post-opt step)."""
    return (fwd, bwd, bwd, fwd, bwd, steps, cuts, cut_grads)


def kernel_dict(counts):
    return dict(zip(KERNEL_NAMES, counts))


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
        return None
    n_ops = sum(n for n, _ in by_name.values())
    print(f"[{label}] one run under the profiler: host wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}) in {n_ops} device ops")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[{label}]   {ms:8.3f} ms  x{n:<4d} {name[:100]}")
    kinds = {}
    for kind, keys in OP_KINDS:
        picked = [v for name, v in by_name.items() if any(k in name for k in keys)]
        kinds[kind] = (sum(n for n, _ in picked), sum(ms for _, ms in picked))
    print(f"[{label}] device ops by kind: " + ", ".join(f"{kind} x{n} {ms:.3f} ms" for kind, (n, ms) in kinds.items()))
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, ops=n_ops, kinds=kinds)


def phase_environment():
    from hidegs_tpu_torch import kernel_sources
    from hidegs_tpu_torch.raster import cuda_blend
    from hidegs_tpu_torch.utils import graphs

    check(KERNEL_NAMES == graphs.ALL_KERNELS, f"chip_smoke counts {KERNEL_NAMES}, the package {graphs.ALL_KERNELS}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs = cuda_blend.build({**kernel_sources.SOURCES, "fold_rows_scalar": SCALAR_FOLD_SRC})
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


# The masked Adam's problems (phase 1a, tools/adam_kernel_ab.py): the rows
# and gradient layouts of the post-opt step (2,020,479 rows, the cell's
# hierarchy; xyz, sh_dc and sh_rest cut out of one packed (rows, 59)
# gradient) and of the train step (its row budget 2^21: params and
# moments the first rows of longer buffers, sh_dc and sh_rest cut out of
# one (rows, 16, 3) gradient)
ADAM_ROWS = {"postopt": 2_020_479, "train": 1 << 21}
ADAM_TRAIN_SPARE = 1 << 18  # rows of the train step's buffers past its row budget
ADAM_TAIL = dict(xyz=(3,), sh_dc=(3,), sh_rest=(15, 3), scaling=(3,), rotation=(4,), opacity=())
ADAM_ROW_FLOATS = 59


def adam_problem(dev, shape, share, seed):
    """One masked Adam step's inputs at `shape` ("postopt" or "train") with
    about `share` of the rows in the mask, from `seed`: (params, grads,
    opt, lr, visible, buffers). For "train" the params and moments are the
    first ADAM_ROWS rows of `buffers` (a (params, opt) pair ADAM_TRAIN_SPARE
    rows longer), as a row-budget step's are; for "postopt" `buffers` is
    None. Steps run 0 to 2^16 (t = 0 clamps to 1); the xyz learning rate
    is a 0-d device tensor, as lr_tree's."""
    from hidegs_tpu_torch.model import adam
    from hidegs_tpu_torch.model.gaussians import GaussianParams

    rows = ADAM_ROWS[shape]
    cap = rows + (ADAM_TRAIN_SPARE if shape == "train" else 0)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaves(n):
        return GaussianParams(*(torch.randn((n, *ADAM_TAIL[f]), generator=gen, device=dev)
                                for f in GaussianParams._fields))

    params, m = leaves(cap), leaves(cap)
    v = GaussianParams(*(x.abs_() for x in leaves(cap)))
    opt = adam.AdamState(m=m, v=v, step=torch.randint(0, 1 << 16, (cap,), generator=gen, device=dev,
                                                      dtype=torch.int32))
    buffers = None
    if shape == "train":
        buffers = (params, opt)
        params = GaussianParams(*(x[:rows] for x in params))
        opt = adam.AdamState(m=GaussianParams(*(x[:rows] for x in m)), v=GaussianParams(*(x[:rows] for x in v)),
                             step=opt.step[:rows])
    g = leaves(rows)
    if shape == "postopt":
        packed = torch.randn((rows, ADAM_ROW_FLOATS), generator=gen, device=dev)
        g = g._replace(xyz=packed[:, 0:3], sh_dc=packed[:, 11:14], sh_rest=packed[:, 14:59].reshape(rows, 15, 3))
    else:
        sh = torch.randn((rows, 16, 3), generator=gen, device=dev)
        g = g._replace(sh_dc=sh[:, 0], sh_rest=sh[:, 1:])
    visible = torch.rand((rows,), generator=gen, device=dev) < share
    lr = GaussianParams(xyz=torch.tensor(1.6e-4 * 3.7, device=dev), sh_dc=2.5e-3, sh_rest=2.5e-3 / 20,
                        scaling=5e-3, rotation=1e-3, opacity=5e-2)
    return params, g, opt, lr, visible, buffers


def adam_bytes(rows, share, in_place):
    """Bytes the masked Adam kernel needs over `rows` rows of
    ADAM_ROW_FLOATS floats with a share `share` of them in the mask: the
    mask, and per row in the mask (every row out of place) p, m and v read
    and written; per row in the mask the gradient and the two bias
    corrections."""
    row = 4 * ADAM_ROW_FLOATS
    if in_place:
        return rows * (1 + share * (7 * row + 8))
    return rows * (1 + 6 * row + share * (row + 8))


def adam_leaves(params, opt):
    """Every tensor a masked Adam step writes."""
    return [*params, *opt.m, *opt.v, opt.step]


def phase_adam(dev):
    """1a. The masked Adam kernel (model/csrc/masked_adam.cu) at the post-opt
    cell's 2,020,479 rows (packed gradients) and the train step's row
    budget (a prefix of longer buffers; `adam_problem`), every row and
    about half of them in the mask: masked_adam_update out of place and in
    place, one launch a call, bitwise masked_adam_plain; in place the
    buffers' rows past the prefix are left as they were. Then at both
    shapes with every row in the mask, in turns (plain, kernel, kernel,
    plain; CUDA events): the plain body, the kernel alone out of place and
    in place, beside its bytes bound; and its ptxas report."""
    from hidegs_tpu_torch import kernel_sources
    from hidegs_tpu_torch.model import adam
    from hidegs_tpu_torch.model.gaussians import GaussianParams

    err, out = 0.0, {}
    for shape in ADAM_ROWS:
        for share in (1.0, 0.5):
            params, g, opt, lr, visible, buffers = adam_problem(dev, shape, share, seed=2026 + len(out))
            want = adam_leaves(*adam.masked_adam_plain(params, g, opt, lr, visible))
            before = [x.clone() for x in adam_leaves(params, opt)]
            spare = None if buffers is None else [x[ADAM_ROWS[shape]:].clone() for x in adam_leaves(*buffers)]
            n0 = adam.LAUNCHES
            got = adam_leaves(*adam.masked_adam_update(params, g, opt, lr, visible))
            check(all(torch.equal(x, y) for x, y in zip(adam_leaves(params, opt), before)),
                  f"masked Adam {shape}, share {share}: the out-of-place update wrote its inputs")
            done = adam_leaves(*adam.masked_adam_update(params, g, opt, lr, visible, in_place=True))
            check(adam.LAUNCHES == n0 + 2, f"masked Adam {shape}: {adam.LAUNCHES - n0} launches for two updates")
            check(all(x is y for x, y in zip(done, adam_leaves(params, opt))),
                  f"masked Adam {shape}: the in-place update did not return its inputs")
            for form, res in (("out of place", got), ("in place", done)):
                err = max(err, *(max_abs_err(x, y) for x, y in zip(res, want)))
                bad = [i for i, (x, y) in enumerate(zip(res, want)) if not torch.equal(x, y)]
                check(not bad, f"masked Adam {shape}, share {share}, {form}: leaves {bad} differ from "
                               f"masked_adam_plain (max abs err {err:.3e})")
            if spare is not None:
                check(all(torch.equal(x[ADAM_ROWS[shape]:], y) for x, y in zip(adam_leaves(*buffers), spare)),
                      f"masked Adam {shape}: the in-place update wrote rows past the row budget")
            n_vis = int(visible.sum())
            print(f"[adam] {shape}: {ADAM_ROWS[shape]:,} rows, {n_vis:,} in the mask ({share:g}): the kernel out of "
                  f"place and in place bitwise masked_adam_plain, one launch each")
            out[shape, share] = n_vis
            del params, g, opt, lr, visible, buffers, want, before, spare, got, done
            torch.cuda.empty_cache()
    times = {}
    for shape, rows in ADAM_ROWS.items():
        params, g, opt, lr, visible, _ = adam_problem(dev, shape, 1.0, seed=7)
        _, c1, c2 = adam.bias_corrections(opt.step, visible, 0.9, 0.999)
        outs = tuple(GaussianParams(*(torch.empty_like(x) for x in t)) for t in (params, opt.m, opt.v))
        sp, sm, sv = (GaussianParams(*(x.clone() for x in t)) for t in (params, opt.m, opt.v))
        fns = {"plain": lambda: adam.masked_adam_plain(params, g, opt, lr, visible),
               "kernel": lambda: adam.launch_masked_adam(params, g, opt.m, opt.v, lr, visible, c1, c2, *outs,
                                                         0.9, 0.999, 1e-15),
               "in_place": lambda: adam.launch_masked_adam(sp, g, sm, sv, lr, visible, c1, c2, sp, sm, sv,
                                                           0.9, 0.999, 1e-15)}
        turns = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                turns[k].append(time_ms(fns[k]))
        t = {k: statistics.median(v) for k, v in turns.items()}
        t["bound_ms"] = adam_bytes(rows, 1.0, False) / HBM_BYTES_S * 1e3
        t["in_place_bound_ms"] = adam_bytes(rows, 1.0, True) / HBM_BYTES_S * 1e3
        times[shape] = t
        print(f"[adam] {shape}, {rows:,} rows, every row in the mask (CUDA events, median of {ITERS} after {WARMUP}, "
              f"two turns): plain {t['plain']:.3f} ms, kernel {t['kernel']:.4f} ms out of place "
              f"({t['bound_ms'] / t['kernel']:.1%} of its {t['bound_ms']:.4f} ms bytes bound), {t['in_place']:.4f} ms "
              f"in place ({t['in_place_bound_ms'] / t['in_place']:.1%} of {t['in_place_bound_ms']:.4f} ms)")
        del params, g, opt, lr, visible, c1, c2, outs, sp, sm, sv, fns
        torch.cuda.empty_cache()
    print(f"[adam] ptxas (build log): {ptxas_report(kernel_sources.SOURCES['masked_adam'])}")
    post = times["postopt"]
    return dict(err=err, ms=post["kernel"], plain_ms=post["plain"], bound_ms=post["bound_ms"], bound_by="bytes",
                in_place_ms=post["in_place"], train_ms=times["train"]["kernel"],
                train_plain_ms=times["train"]["plain"])


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
    check(launches == kernel_dict(per_kernel(len(cams), 0)),
          f"render path launches {launches}, expected {len(cams)} forward blends and preprocess forwards and "
          f"nothing else")
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
    count = cuda_blend.visited_count(tb, cfg.max_blocks)
    out = torch.empty((ty * tx, P, cuda_blend.OUT_CH), device=attrs.device)
    obs = torch.zeros((attrs.shape[0],), dtype=torch.int32, device=attrs.device)

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


# the preprocess kernels (csrc/preprocess.cu): the holds' tolerances are
# tests/test_torch_raster.py's preprocess ones (floats atol 1e-5 / rtol
# 1e-5, the integer radius within 1 on a share of the rows) and the JAX
# suite's gradient tolerance (5e-3 of each leaf's max |grad|)
PRE_FIELDS = ("mean2d", "conic", "depth", "inv_depth", "opacity", "rgb", "normal", "distance")
PRE_TOL = dict(atol=1e-5, rtol=1e-5)
RADIUS_FLIP_SHARE = 0.01
PRE_GRAD_TOL = 5e-3
# float operations a row, counted from csrc/preprocess.cu and rounded up
# (SH degree 3, render_geo): the operations' bound, far below the bytes'
OPS_PER_PRE_FWD_ROW = 450
OPS_PER_PRE_BWD_ROW = 1100


def pre_bound(bytes_moved, ops):
    """The least time of a preprocess kernel: its bytes over the memory rate
    or its float operations over the FP32 rate, whichever is longer."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / FP32_FLOP_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                text=f"{bytes_moved / 1e6:.1f} MB moved: {t_bytes:.4f} ms; {ops / 1e9:.2f} GFLOP: {t_ops:.4f} ms")


def hold_preprocess_forward(got, want, what):
    """The kernel's ten outputs against the plain forward's on the same
    inputs: the radius within 1 on at most RADIUS_FLIP_SHARE of the rows,
    the visible mask differing only where the radius does, every float at
    PRE_TOL (opacity and inv_depth, which the mask zeroes, on the rows
    where the masks agree)."""
    N = got.visible.shape[0]
    dr = (got.radius - want.radius).abs()
    flips = int((dr > 0).sum())
    check(int(dr.max()) <= 1 and flips <= RADIUS_FLIP_SHARE * N,
          f"{what}: the radius departs by up to {int(dr.max())} on {flips} of {N} rows")
    vis_diff = got.visible != want.visible
    check(not bool((vis_diff & (dr == 0)).any()), f"{what}: the visible mask differs where the radius does not")
    same = ~vis_diff
    errs = {}
    for k in PRE_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if k in ("opacity", "inv_depth"):
            a, b = a[same], b[same]
        n_bad = int((~torch.isclose(a, b, **PRE_TOL)).sum())
        errs[k] = max_abs_err(a, b)
        check(n_bad == 0, f"{what}: {k} outside atol 1e-5 / rtol 1e-5 on {n_bad} elements (max abs err {errs[k]:.3e})")
    return dict(err=max(errs.values()), errs=errs, flips=flips, vis_diff=int(vis_diff.sum()), rows=N)


def phase_preprocess(scene, cams, cfg):
    """preprocess_fwd on the render cell's four full-width views against
    preprocess_plain on the same inputs (one launch per call), then view
    0's kernel timed alone beside the plain version and its bound."""
    from hidegs_tpu_torch.core.ewa import H_VAR, NEAR_Z
    from hidegs_tpu_torch.core.sh import degree_mask
    from hidegs_tpu_torch import kernel_sources
    from hidegs_tpu_torch.raster import binning, preprocess_autograd as pa
    from hidegs_tpu_torch.raster.preprocess import camera_pack, preprocess_gaussians, preprocess_plain

    tile = cfg.tile
    held = []
    for i, cam in enumerate(cams):
        ty, tx = binning.tile_grid(cam.height, cam.width, tile)
        kw = dict(active_sh_degree=3, render_geo=True, screen_bounds=(tx * tile, ty * tile))
        with torch.no_grad():
            before = pa.FWD_LAUNCHES
            got = preprocess_gaussians(*scene, cam, **kw)
            check(pa.FWD_LAUNCHES == before + 1, f"preprocess view {i}: {pa.FWD_LAUNCHES - before} forward launches")
            want = preprocess_plain(*scene, cam, **kw)
            again = preprocess_gaussians(*scene, cam, **kw)
        h = hold_preprocess_forward(got, want, f"preprocess_fwd view {i}")
        check(all(torch.equal(a, b) for a, b in zip(got.tensors(), again.tensors())),
              f"preprocess_fwd view {i}: two launches differ")
        held.append(h)
        print(f"[preprocess] view {i}: kernel vs plain forward, max abs err per field "
              + ", ".join(f"{k} {e:.3e}" for k, e in h["errs"].items())
              + f" (atol 1e-5 / rtol 1e-5 holds); radius flips {h['flips']} of {h['rows']} rows "
              f"({h['flips'] / h['rows']:.2e}), visible differs on {h['vis_diff']} (each a flipped radius); "
              f"{int(got.visible.sum())} visible; two launches bitwise equal")
        del got, want, again

    cam = cams[0]
    ty, tx = binning.tile_grid(cam.height, cam.width, tile)
    N = scene.means3d.shape[0]
    K = scene.shs.shape[-2]
    kw = dict(active_sh_degree=3, render_geo=True, screen_bounds=(tx * tile, ty * tile))
    flags = pa.USE_SH | pa.ANTIALIAS | pa.RENDER_GEO | pa.SCREEN
    params, mask = camera_pack(cam), degree_mask(3, K, device=scene.means3d.device)
    color = scene.shs.reshape(N, 3 * K)
    out = {k: torch.empty((N, pa.WIDTHS[k]) if k in pa.WIDTHS else (N,), device=color.device,
                          dtype={"radius": torch.int32, "visible": torch.bool}.get(k, torch.float32))
           for k in pa.FIELDS}

    def launch():
        pa.launch_preprocess_fwd(scene.means3d, scene.scales, scene.quats, scene.opacities, color, None, params,
                                 mask, None, None, None, K, flags, H_VAR, NEAR_Z, float(tx * tile), float(ty * tile),
                                 out)

    def plain():
        with torch.no_grad():
            return preprocess_plain(*scene, cam, **kw)

    ms = time_ms(launch)
    plain_ms = time_ms(plain)
    bytes_moved = N * (11 + 3 * K) * 4 + N * 15 * 4 + N * 5 + 4 * (len(params) + K)
    bound = pre_bound(bytes_moved, N * OPS_PER_PRE_FWD_ROW)
    print(f"[preprocess] forward kernel, view 0 ({N} rows, SH degree 3, render_geo): {ms:.4f} ms one launch at a "
          f"time (CUDA events, median of {ITERS} after {WARMUP}), plain forward {plain_ms:.3f} ms; bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['text']}), the kernel at "
          f"{bound['bound_ms'] / ms:.1%} of it; ptxas (build log): {ptxas_report(kernel_sources.SOURCES['preprocess'])}")
    return dict(err=max(h["err"] for h in held), flips=sum(h["flips"] for h in held), rows=sum(h["rows"] for h in held),
                ms=ms, plain_ms=plain_ms, bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])


def ptxas_report(src):
    """Registers, stack and spills of each kernel of `src`'s library, from its build log."""
    from hidegs_tpu_torch.raster import cuda_blend

    log = cuda_blend.build({"src": src})["src"].with_suffix(".log")
    lines = log.read_text().splitlines() if log.exists() else []
    kernels = [re.search(r"(\w+_kernel)", ln).group(1) for ln in lines if "Compiling entry" in ln]
    regs = [re.search(r"Used (\d+) registers", ln).group(1) for ln in lines if "registers" in ln]
    spills = [ln.strip() for ln in lines if "spill" in ln]
    return "; ".join(f"{k}: {r} registers, {s}" for k, r, s in zip(kernels, regs, spills)) or "no build log"


def phase_preprocess_backward(train):
    """preprocess_bwd on the train cell's step: the cotangents one train
    step gives the PreprocessFn node (train_step's own stages, view 0 of
    the trained state), its gradients against torch autograd of
    preprocess_plain on the node's inputs and cotangents; then the kernel
    timed alone beside the plain closed-form backward and its bound."""
    from hidegs_tpu_torch.raster import preprocess_autograd as pa
    from hidegs_tpu_torch.raster.preprocess import preprocess_plain, preprocess_plain_bwd
    from hidegs_tpu_torch.train import loop as tl

    calls = []

    def record(fn):
        def call(*args, **kwargs):
            calls.append((args, kwargs))
            return fn(*args, **kwargs)
        return call

    ts, tcfg = train["ts"], train["tcfg"]
    with patched(pa, "preprocess_cuda", record):
        loss, _, inputs = tl.step_forward(ts, train["batches"][0], tcfg)
    check(len(calls) == 1, f"the train step preprocessed {len(calls)} times")
    node = find_node(loss.grad_fn, "PreprocessFnBackward")
    got = {}

    def keep(grad_outputs):
        got.update(cts=tuple(None if g is None else g.detach().contiguous() for g in grad_outputs),
                   saved=tuple(None if x is None else x.detach() for x in node.saved_tensors))

    def keep_result(grad_inputs, _grad_outputs):
        got.update(grads=grad_inputs)

    handles = node.register_prehook(keep), node.register_hook(keep_result)
    before = pa.BWD_LAUNCHES
    tl.step_backward(loss, inputs)
    for h in handles:
        h.remove()
    check(pa.BWD_LAUNCHES == before + 1 and "grads" in got,
          f"the train step's backward launched preprocess_bwd {pa.BWD_LAUNCHES - before} times")
    args, kwargs = calls[0]
    cam = args[5]
    leaves = [x.detach().clone().requires_grad_(True) for x in args[:5]]
    kw = dict(kwargs)
    if kw.get("mean2d_offset") is not None:
        kw["mean2d_offset"] = kw["mean2d_offset"].detach().clone().requires_grad_(True)
    names = ["means3d", "scales", "quats", "opacities", "shs" if kw.get("colors_precomp") is None else None,
             "mean2d_offset" if kw.get("mean2d_offset") is not None else None]
    wrt = [x for x, n in zip(leaves + [kw.get("mean2d_offset")], names) if n is not None]
    pre = preprocess_plain(*leaves, cam, **kw)
    outs = [(getattr(pre, k), ct) for k, ct in zip(PRE_FIELDS, got["cts"]) if ct is not None
            and getattr(pre, k).requires_grad]
    want = torch.autograd.grad([o for o, _ in outs], wrt, [ct for _, ct in outs])
    errs, abs_err = {}, 0.0
    for name, w, g in zip([n for n in names if n is not None], want, [g for g, n in zip(got["grads"], names)
                                                                    if n is not None]):
        scale = float(w.abs().max())
        abs_err = max(abs_err, max_abs_err(g, w))
        errs[name] = max_abs_err(g, w) / scale
        check(scale > 0 and errs[name] <= PRE_GRAD_TOL,
              f"preprocess_bwd, train step: {name} departs {errs[name]:.3e} of its max |grad|")
    present = [k for k, ct in zip(PRE_FIELDS, got["cts"]) if ct is not None]
    N = args[0].shape[0]
    print(f"[preprocess] backward kernel on the train cell's step (view 0, {N} rows, cotangents of {present}) "
          f"vs torch autograd of the plain forward: departure of each leaf's max |grad| "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()) + f" (<= {PRE_GRAD_TOL}); max abs err {abs_err:.3e}")

    means3d, scales, quats, opacities, color, params, mask, visible = got["saved"]
    K, flags, h_var, near_z, _, _ = node.static
    cts = dict(zip(PRE_FIELDS, got["cts"]))
    grads = {k: torch.empty_like(x) for k, x in (("means3d", means3d), ("scales", scales), ("quats", quats),
                                                   ("opacities", opacities), ("color", color))}
    grads["mean2d_offset"] = torch.empty((N, 2), device=means3d.device) if node.has_offset else None

    def launch():
        pa.launch_preprocess_bwd(means3d, scales, quats, opacities, color, params, mask, visible, cts, K, flags,
                                 h_var, near_z, grads)

    plain_kw = {k: v for k, v in kw.items() if k not in ("boxmin", "boxmax", "box_exempt", "screen_bounds")}

    def plain():
        with torch.no_grad():
            return preprocess_plain_bwd(cts, visible, *(x.detach() for x in args[:5]), cam, **plain_kw)

    ms = time_ms(launch)
    plain_ms = time_ms(plain)
    width = color.shape[1]
    ct_floats = sum(x.shape[1] if x.ndim == 2 else 1 for x in cts.values() if x is not None)
    out_floats = 11 + width + (2 if node.has_offset else 0)
    bytes_moved = N * (11 + width) * 4 + N + N * ct_floats * 4 + N * out_floats * 4 + 4 * (len(params) + K)
    bound = pre_bound(bytes_moved, N * OPS_PER_PRE_BWD_ROW)
    print(f"[preprocess] backward kernel ({N} rows, {ct_floats} cotangent floats a row): {ms:.4f} ms one launch at "
          f"a time, plain closed-form backward {plain_ms:.3f} ms; bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} ({bound['text']}), the kernel at {bound['bound_ms'] / ms:.1%} of it")
    return dict(err=abs_err, rel_err=max(errs.values()), ms=ms, plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                bound_by=bound["bound_by"])


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


def host_split_ms(comp, args, kwargs, iters=ITERS):
    """Host ms of one compiled render call (the card synchronised before
    each, not after), and of its parts alone: the key, the lookup (the key,
    the held check, the graph's dict), the copy-in and the replay; medians
    of `iters`."""
    from hidegs_tpu_torch.raster.compiled import render_key
    from hidegs_tpu_torch.utils.graphs import copy_into

    g = comp._graphs[render_key(*args, **kwargs)]  # the callers' calls captured it
    cam, bg, held = args[5], kwargs.get("background"), (args[:5], kwargs.get("colors_precomp"))
    parts = {"call": lambda: comp(*args, **kwargs), "key": lambda: render_key(*args, **kwargs),
             "lookup": lambda: (comp._check_held(held), comp._graphs.get(render_key(*args, **kwargs))),
             "copy-in": lambda: copy_into((g.state, g.inputs), (None, (cam, bg))),
             "replay": lambda: comp.replay(g)}
    out = {}
    for name, fn in parts.items():
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        out[name] = statistics.median(times)
    torch.cuda.synchronize()
    return out


def phase_render_compiled(scene, cams, cfg):
    """The serving render compiled (raster/compiled.py:CompiledRender, one
    CUDA graph per static key) beside the eager render, in the render
    cell's configuration and the serve one (evaluate's and render_cli's:
    tile 16, render_cli's budget, no block cap, the two-key sort). Counts
    are read around the compiled calls on the four views of both; then
    each is held bitwise against the eager render, replayed under
    set_sync_debug_mode("error"), timed beside the eager render and run
    under the profiler; then the KNN scale init at full width."""
    from hidegs_tpu_torch.model.knn import initial_scales
    from hidegs_tpu_torch.raster.api import RasterConfig, render
    from hidegs_tpu_torch.raster.binning import TILE
    from hidegs_tpu_torch.raster.compiled import CompiledRender

    serve_cfg = RasterConfig(tile=TILE, max_instances=serve_budget(scene, cams, TILE))
    modes = {"render cell": dict(render_geo=True, active_sh_degree=3, config=cfg), "serve": dict(config=serve_cfg)}
    comp = CompiledRender()
    reset_counts()
    got = {name: [{k: v.clone() for k, v in comp(*scene, cam, **kw).items()} for cam in cams]
           for name, kw in modes.items()}
    launches = read_counts()
    n = len(modes) * len(cams)
    check(len(comp.captures) == len(modes) and replay_counts() == per_kernel(n, 0)
          and direct_counts() == per_kernel(len(modes), 0),
          f"compiled render launches {launches} for {n} views and {len(comp.captures)} captures: expected one "
          f"replayed forward launch per view and the warm-up's per capture")
    print(f"[render-compiled] launches {launches}: {n} replayed views ({len(cams)} per configuration) and "
          f"{len(comp.captures)} warm-ups; serve configuration: tile {TILE}, max_instances {serve_cfg.max_instances}, "
          f"max_blocks 0, depth_sort_bits 0")
    results = {}
    for name, kw in modes.items():
        with torch.no_grad():
            for i, cam in enumerate(cams):
                want = render(*scene, cam, **kw)
                check(set(want) == set(got[name][i]), f"compiled render ({name}) view {i}: other keys")
                for key, val in want.items():
                    check(torch.equal(got[name][i][key], val),
                          f"compiled render ({name}) view {i}: {key} is not the eager render's")
                over = {key: int(want[key]) for key in ("overflow", "block_overflow", "visible_overflow")}
                check(not any(over.values()), f"compiled render ({name}) view {i}: {over}")
        del want
        got[name] = None
        sync(scene.means3d.device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for cam in cams:
                comp(*scene, cam, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        cam = cams[0]

        def eager():
            with torch.no_grad():
                return render(*scene, cam, **kw)

        def compiled():
            return comp(*scene, cam, **kw)

        eager_ms = time_ms(eager)
        compiled_ms = time_ms(compiled)
        compiled_ms2 = time_ms(compiled)
        eager_ms2 = time_ms(eager)
        host = host_split_ms(comp, (*scene, cam), kw)
        profs = {mode: profile_device(fn, f"render-{mode} {name}") for mode, fn in (("eager", eager),
                                                                                      ("compiled", compiled))}
        busy = {mode: "not measured" if p is None else
                f"{p['busy_ms']:.3f} ms busy of {p['wall_ms']:.3f} ({p['busy_ms'] / p['wall_ms']:.1%}, {p['ops']} ops)"
                for mode, p in profs.items()}
        info = next(c for c in comp.captures if c["tile"] == kw["config"].tile)
        # a first view costs the warm-up and the capture on top of its
        # replay; each later one saves eager - compiled
        capture_ms = 1e3 * (info["warmup_s"] + info["capture_s"])
        saved_ms = (eager_ms + eager_ms2 - compiled_ms - compiled_ms2) / 2
        break_even = math.ceil(capture_ms / saved_ms) if saved_ms > 0 else None
        print(f"[render-compiled] {name}: the four views bitwise the eager render (every key), replays made no "
              f"host sync; view 0, CUDA events, median of {ITERS} after {WARMUP}, in turns: eager {eager_ms:.3f} / "
              f"{eager_ms2:.3f} ms, compiled {compiled_ms:.3f} / {compiled_ms2:.3f} ms; host ms per compiled call "
              f"(synchronised before, median of {ITERS}) {host['call']:.3f}: lookup {host['lookup']:.3f} (of it the "
              f"key {host['key']:.3f}), copy-in {host['copy-in']:.3f}, replay {host['replay']:.3f}; under the "
              f"profiler eager {busy['eager']}, compiled {busy['compiled']}; warm-up {info['warmup_s']:.3f} s, "
              f"capture {info['capture_s']:.3f} s, graph pool +{info['pool_reserved_bytes'] / 2**30:.3f} GiB reserved; "
              f"the capture's {capture_ms:.3f} ms pay back after {break_even} views at {saved_ms:.3f} ms saved "
              f"a view")
        results[name] = dict(eager_ms=(eager_ms, eager_ms2), compiled_ms=(compiled_ms, compiled_ms2), host=host,
                             busy={m: p and p["busy_ms"] / p["wall_ms"] for m, p in profs.items()},
                             break_even=break_even)
    del comp, got
    torch.cuda.empty_cache()

    # the KNN scale init (model/knn.py) at full width: no host sync, held
    # on a 100,000-point slice against the CPU, timed
    pts = scene.means3d
    sync(pts.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        scales = initial_scales(pts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(tuple(scales.shape) == (pts.shape[0],) and bool(torch.isfinite(scales).all()) and float(scales.min()) > 0,
          "knn: initial scales not finite and positive")
    part = pts[:100_000]
    err = float(((initial_scales(part).cpu() - initial_scales(part.cpu())).abs() / initial_scales(part.cpu())).max())
    check(err <= 1e-5, f"knn: the card's scales depart {err:.3e} (relative) from the CPU's on 100,000 points")
    knn_ms = time_ms(lambda: initial_scales(pts))
    prof = profile_device(lambda: initial_scales(pts), "knn")
    print(f"[knn] initial_scales on {pts.shape[0]} points: {knn_ms:.3f} ms (CUDA events, median of {ITERS} after "
          f"{WARMUP}), no host sync, within {err:.2e} (relative) of the CPU on {part.shape[0]} points; device busy "
          f"{'not measured' if prof is None else format(prof['busy_ms'] / prof['wall_ms'], '.1%')}")
    return dict(launches=launches, modes=results, knn_ms=knn_ms)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def patched(obj, name, wrapper):
    """obj.name replaced by wrapper(original) inside the block."""
    original = getattr(obj, name)
    setattr(obj, name, wrapper(original))
    try:
        yield
    finally:
        setattr(obj, name, original)


def tensors_of(x):
    """The tensors in x (a tensor, a tuple or list of them, a dict's values,
    or a CameraParams' fields)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors_of(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensors_of(v)]
    if hasattr(x, "R") and hasattr(x, "cx"):  # CameraParams
        return [x.R, x.t, x.fx, x.fy, x.cx, x.cy]
    return []


def serve_budget(scene, cams, tile):
    """render_cli's --max_instances for `cams` at `tile` (render_cli bins at
    the RasterConfig default tile): a probe pass with 1.12x slack, as
    full_width_setup sizes the render cell."""
    from hidegs_tpu_torch.raster import binning
    from hidegs_tpu_torch.raster.api import round_budget
    from hidegs_tpu_torch.raster.preprocess import preprocess_gaussians

    want = 0
    for cam in cams:
        ty, tx = binning.tile_grid(cam.height, cam.width, tile)
        pre = preprocess_gaussians(*scene, cam, screen_bounds=(tx * tile, ty * tile))
        tb = binning.bin_gaussians(pre, ty, tx, 1 << 22, tile)
        check(int(tb.overflow) == 0, "serve probe budget overflowed")
        want = max(want, int(tb.num_instances))
    return round_budget(int(want * 1.12))


def phase_serve(scene, cams, cfg, hier_path):
    """The serving path at full width: a COLMAP scene and a model directory
    on disk, then the port's evaluate and render_cli entry points, as a
    user calls them. Counts are read around those two calls alone; then
    render_cli --hierarchy renders the scene's hierarchy (`hier_path`) at
    tau SERVE_TAU, counted apart."""
    from hidegs_tpu_torch import config, evaluate, render_cli
    from hidegs_tpu_torch.data import cameras as cam_io
    from hidegs_tpu_torch.data import scene as scene_io
    from hidegs_tpu_torch.data.synthetic import write_synthetic_colmap_scene
    from hidegs_tpu_torch.raster import blend_autograd, blend_plain
    from hidegs_tpu_torch.raster.api import RasterConfig, render
    from hidegs_tpu_torch.raster.binning import TILE
    from hidegs_tpu_torch.raster.compiled import CompiledRender
    from hidegs_tpu_torch.train import lpips
    from hidegs_tpu_torch.utils import png
    from hidegs_tpu_torch.utils.ply import gaussian_properties, write_ply

    dev = scene.means3d.device
    work = ROOT / "build" / "serve_smoke"
    shutil.rmtree(work, ignore_errors=True)
    src, model, out = work / "scene", work / "model", work / "render_cli"
    try:
        import PIL  # noqa: F401

        pil = f"yes (Pillow {PIL.__version__})"
    except ImportError:
        pil = "no"
    print(f"[serve] import PIL on this machine: {pil}")

    t0 = time.perf_counter()
    write_synthetic_colmap_scene(str(src), scene, cams, render_config=RasterConfig(
        tile=cfg.tile, max_instances=cfg.max_instances))
    t_scene = time.perf_counter() - t0
    # render_cli bins at the RasterConfig default tile (16), as the JAX one
    # does; the snapshot asks evaluate for the same tile and budget, so both
    # entry points render every view alike and their PNGs must be equal
    cli_budget = serve_budget(scene, cams, TILE)
    t0 = time.perf_counter()
    op = scene.opacities.double()
    ckpt = model / "point_cloud" / f"iteration_{SERVE_ITER}"
    os.makedirs(ckpt)
    write_ply(str(ckpt / "point_cloud.ply"), gaussian_properties(
        scene.means3d.cpu().numpy(), scene.shs[:, 0].cpu().numpy(), scene.shs[:, 1:].cpu().numpy(),
        torch.log(op / (1.0 - op)).float().cpu().numpy(), torch.log(scene.scales).cpu().numpy(),
        scene.quats.cpu().numpy()))
    config.save_cfg_args(str(model), config.ModelConfig(source_path=str(src), eval=True),
                         config.PipelineConfig(raster_backend="pallas", tile=TILE, max_instances=cli_budget),
                         config.OptimizationConfig())
    t_model = time.perf_counter() - t0
    print(f"[serve] wrote the COLMAP scene ({len(cams)} views {FULL_W}x{FULL_H}, rendered at tile {cfg.tile}, "
          f"+ PNGs + sparse points) in {t_scene:.2f} s and the model (ply of {scene.means3d.shape[0]} gaussians, "
          f"cfg_args.json: raster_backend pallas, tile {TILE}, max_instances {cli_budget}; render_cli gets the "
          f"same budget) in {t_model:.2f} s")

    timers = {k: [] for k in ("load_scene", "read_ply", "render", "lpips", "decode", "png_write")}
    renders = []  # each served view: its image (a replay's, cloned) and the render's arguments
    served = []  # the CompiledRender of each entry point
    blend_in = {}  # the blend's inputs and planes in the eager render of render_cli's first view, held below

    def keep_blend(blend_tiles):
        def call(*args, **kwargs):
            res = blend_tiles(*args, **kwargs)
            blend_in.update(args=args, planes=res)
            return res
        return call

    def timed(key, check_devices=False):
        def wrap(fn):
            def call(*args, **kwargs):
                if check_devices:
                    for t in tensors_of(args) + tensors_of(kwargs):
                        check(t.device == dev, f"serve: a {key} input lies on {t.device}")
                sync(dev)
                t0 = time.perf_counter()
                res = fn(*args, **kwargs)
                sync(dev)
                timers[key].append(time.perf_counter() - t0)
                if check_devices:
                    for t in tensors_of(res):
                        check(t.device == dev, f"serve: a {key} output lies on {t.device}")
                if key == "render":
                    renders.append(dict(image=res["render"].clone(), args=args, kwargs=kwargs, **{
                        k: int(res[k]) for k in ("overflow", "block_overflow", "visible_overflow")}))
                return res
            return call
        return wrap

    def timed_serving(make):
        def call(device, config):
            fn = make(device, config)
            check(isinstance(fn, CompiledRender), f"serve: an entry point renders with {type(fn)}, not CompiledRender")
            served.append(fn)
            return timed("render", check_devices=True)(fn)
        return call

    def timed_lpips(default_fn):
        def make(*args, **kwargs):
            fn, kind = default_fn(*args, **kwargs)
            check(isinstance(fn, lpips.CompiledLpips), f"serve: evaluate's LPIPS is {type(fn)}, not CompiledLpips")
            return timed("lpips", check_devices=True)(fn), kind
        return make

    eval_args = ["--model_path", str(model), "--source_path", str(src), "--eval", "--resolution", "1",
                 "--device", str(dev)]
    cli_args = ["--model_path", str(model), "--source_path", str(src), "--resolution", "1", "--backend", "pallas",
                "--max_instances", str(cli_budget), "--output_path", str(out), "--device", str(dev)]
    n_eval = len(cams)  # evaluate's renders come first; render_cli's first blend is held below
    with contextlib.ExitStack() as stack:
        for obj, name, wrapper in (
            (scene_io, "load_scene", timed("load_scene")),
            (evaluate, "load_gaussian_state_from_ply", timed("read_ply", check_devices=True)),
            (render_cli, "load_gaussian_state_from_ply", timed("read_ply", check_devices=True)),
            (evaluate, "serving_render", timed_serving),
            (render_cli, "serving_render", timed_serving),
            (lpips, "default_lpips_fn", timed_lpips),
            (cam_io, "load_camera", timed("decode")),
            (evaluate, "save_png", timed("png_write")),
            (render_cli, "save_png", timed("png_write")),
        ):
            stack.enter_context(patched(obj, name, wrapper))
        reset_counts()
        t0 = time.perf_counter()
        report = evaluate.main(eval_args)
        sync(dev)
        t_eval = time.perf_counter() - t0
        check(len(renders) == n_eval, f"serve: evaluate rendered {len(renders)} views, expected {n_eval}")
        t0 = time.perf_counter()
        render_cli.main(cli_args)
        sync(dev)
        t_cli = time.perf_counter() - t0
        launches = read_counts()
    n_served = len(renders)
    n_captures = sum(len(fn.captures) for fn in served)
    print(f"[serve] launches on the serve path: {launches} for {n_served} served views: replayed "
          f"{dict(zip(launches, replay_counts()))}, the warm-ups of {n_captures} captures {dict(zip(launches, direct_counts()))}")
    check(len(served) == 2 and n_served == 2 * len(cams) and replay_counts() == per_kernel(n_served, 0)
          and direct_counts() == per_kernel(n_captures, 0),
          f"serve path launches {launches}, expected one replayed forward blend per served view ({2 * len(cams)}) "
          f"and the warm-up's per capture ({n_captures}) through one CompiledRender per entry point ({len(served)})")
    for i, r in enumerate(renders):
        over = {k: r[k] for k in ("overflow", "block_overflow", "visible_overflow")}
        check(all(v == 0 for v in over.values()), f"serve: view {i} overflows its budget: {over}")
    # every served image (a replay) is the eager render of the same inputs,
    # to the bit; render_cli's first view's eager blend is kept for the hold
    for i, r in enumerate(renders):
        with contextlib.ExitStack() as stack, torch.no_grad():
            if i == n_eval:
                stack.enter_context(patched(blend_autograd, "blend_tiles", keep_blend))
            want = render(*r["args"], **r["kwargs"])["render"]
        check(torch.equal(r["image"], want), f"serve: served view {i} (a replay) is not the eager render")
    del want
    print("[serve] every served view (a replay) bitwise the eager render of its inputs; captures: " + "; ".join(
        f"{c['image'][1]}x{c['image'][0]} tile {c['tile']}: warm-up {c['warmup_s']:.3f} s, capture "
        f"{c['capture_s']:.3f} s, pool +{c['pool_reserved_bytes'] / 2**30:.3f} GiB" for fn in served for c in fn.captures))

    saved = json.loads((model / f"eval_{SERVE_ITER}" / "results.json").read_text())
    check(set(saved) == {"lpips_kind", "train", "test"}, f"serve: results.json keys {sorted(saved)}")
    check(len(saved["test"]["per_view"]) == 1 and len(saved["train"]["per_view"]) == len(cams) - 1,
          "serve: --eval should give one test view and the rest train views")
    for split in ("test", "train"):
        for v in saved[split]["per_view"]:
            check(v["psnr"] >= SERVE_MIN_PSNR and v["ssim"] >= SERVE_MIN_SSIM and np.isfinite(v["lpips"]),
                  f"serve: {split} view {v['name']}: PSNR {v['psnr']:.3f} dB, SSIM {v['ssim']:.5f}, "
                  f"LPIPS {v['lpips']}")
            print(f"[serve] {split} {v['name']}: PSNR {v['psnr']:.4f} dB, SSIM {v['ssim']:.6f}, LPIPS "
                  f"{v['lpips']:.6g} ({saved['lpips_kind']})")
    check(report == saved, "serve: evaluate.main's report differs from results.json")

    # render_cli renders every view in COLMAP order, evaluate its train set
    # first (--eval made view 0 the test set), both at tile 16 on the same
    # budget: each of render_cli's PNGs must equal evaluate's of that view
    ev = model / f"eval_{SERVE_ITER}"
    eval_pngs = [ev / "test" / "renders" / "00000.png"] + [
        ev / "train" / "renders" / f"{i:05d}.png" for i in range(len(cams) - 1)]
    for i, want in enumerate(eval_pngs):
        got = png.read_image(str(out / f"{i:05d}.png"))
        check(got.shape == (FULL_H, FULL_W, 3) and np.array_equal(got, png.read_image(str(want))),
              f"serve: render_cli's view {i} differs from evaluate's {want.parent.parent.name}/{want.name}")
    print(f"[serve] render_cli's {len(eval_pngs)} PNGs equal evaluate's, to the bit")

    # render_cli's view 0 (tile 16, the budget above): the kernel's planes
    # in the eager render of its inputs against the plain blend on the same
    # inputs, as phase 4 holds tile 32; the served image is the held kernel
    # output
    pre, tb, ty, tx, tile, max_blocks, _bf16 = blend_in["args"]
    k = blend_in["planes"]
    p = blend_plain.blend_tiles(pre, tb, ty, tx, tile, max_blocks)
    err = 0.0
    for key in PLANE_KEYS:
        assert_close(k[key], p[key], f"serve: render_cli view 0 {key}")
        err = max(err, max_abs_err(k[key], p[key]))
    N = pre.mean2d.shape[0]
    n_diff = int((k["out_observe"] != p["out_observe"]).sum())
    check(n_diff <= N // 1000, f"serve: render_cli view 0: out_observe differs on {n_diff} of {N} gaussians (> 0.1%)")
    check(tile == TILE and torch.equal(renders[n_eval]["image"], k["render"][:, :FULL_H, :FULL_W]),
          "serve: render_cli's view 0 is not the held kernel output")
    print(f"[serve] render_cli view 0 (tile {tile}, {int(tb.num_instances)} instances) kernel vs plain: max abs err "
          f"{err:.3e} (atol 3e-4 / rtol 1e-3 holds), out_observe differs on {n_diff} of {N} gaussians")
    blend_in.clear()
    del pre, tb, k, p
    # evaluate's calls come first in each timer's list, render_cli's after them
    setup_s = timers["load_scene"][0] + timers["read_ply"][0]
    per_view = 1e3 * (t_eval - setup_s) / n_eval
    render_ms = 1e3 * float(np.mean(timers["render"][:n_eval]))
    lpips_ms = 1e3 * float(np.mean(timers["lpips"]))
    decode_ms = 1e3 * float(np.mean(timers["decode"][:n_eval]))
    write_ms = 2e3 * float(np.mean(timers["png_write"][:2 * n_eval]))  # a render and a ground truth
    print(f"[serve] evaluate: {t_eval:.2f} s for {n_eval} views: load the scene {timers['load_scene'][0]:.3f} s, "
          f"read the PLY {timers['read_ply'][0]:.3f} s, then per view {per_view:.1f} ms = render {render_ms:.2f} "
          f"+ LPIPS {lpips_ms:.2f} + image I/O {decode_ms + write_ms:.2f} (decode the ground truth "
          f"{decode_ms:.2f}, write 2 PNGs {write_ms:.2f}) + the rest (PSNR, SSIM, host) "
          f"{per_view - render_ms - lpips_ms - decode_ms - write_ms:.2f} (host clock, the card synchronised "
          f"around each timed call); the render averages {render_ms:.2f} ms a view with the capture: "
          f"{1e3 * timers['render'][0]:.2f} ms in the first view (warm-up and capture), then "
          f"{1e3 * np.mean(timers['render'][1:n_eval]):.2f} ms per replayed view")
    print(f"[serve] render_cli: {t_cli:.2f} s for {n_served - n_eval} views: render "
          f"{1e3 * np.mean(timers['render'][n_eval:]):.2f} ms ({1e3 * timers['render'][n_eval]:.2f} in the first "
          f"view, then {1e3 * np.mean(timers['render'][n_eval + 1:]):.2f} per replayed view) and PNG write "
          f"{1e3 * np.mean(timers['png_write'][2 * n_eval:]):.2f} ms per view")
    phase_lpips(renders[0]["image"], renders[1]["image"])
    hier_launches = serve_hierarchy(src, hier_path, dev)
    shutil.rmtree(work, ignore_errors=True)
    return dict(launches=launches, hier_launches=hier_launches, cli_budget=cli_budget)


def phase_lpips(a, b):
    """The serve phase's LPIPS (train/lpips.py) compiled and eager on two
    full-width renders: bitwise equal; times of both (CUDA events), the
    host ms per compiled call, one call of each under the profiler."""
    from hidegs_tpu_torch.train import lpips

    a, b = torch.clamp(a, 0.0, 1.0), torch.clamp(b, 0.0, 1.0)
    params = lpips.random_lpips_params(0, a.device)

    def eager():
        with torch.no_grad():
            return lpips.lpips_distance(params, a, b)

    comp = lpips.CompiledLpips(params)
    got, want = comp(a, b).clone(), eager()
    check(torch.equal(got, want), f"serve: compiled LPIPS {float(got)!r} is not the eager {float(want)!r}")
    sync(a.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = comp(a, b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(torch.equal(again, want), "serve: a steady compiled LPIPS call differs from the eager distance")
    eager_ms = time_ms(eager)
    compiled_ms = time_ms(lambda: comp(a, b))
    host = []
    for _ in range(ITERS):
        sync(a.device)
        t0 = time.perf_counter()
        comp(a, b)
        host.append(1e3 * (time.perf_counter() - t0))
    sync(a.device)
    profs = {mode: profile_device(fn, f"lpips-{mode}") for mode, fn in (("eager", eager),
                                                                          ("compiled", lambda: comp(a, b)))}
    busy = {mode: "not measured" if p is None else f"{p['busy_ms']:.3f} ms busy ({p['busy_ms'] / p['wall_ms']:.1%})"
            for mode, p in profs.items()}
    info = comp.captures[0]
    print(f"[lpips] {tuple(a.shape)} pair, random VGG16: compiled bitwise the eager distance ({float(want):.6g}); "
          f"a steady call made no host sync; CUDA events, median of {ITERS} after {WARMUP}: eager {eager_ms:.3f} ms, "
          f"compiled {compiled_ms:.3f} ms; host ms per compiled call {statistics.median(host):.3f}; under the "
          f"profiler eager {busy['eager']}, compiled {busy['compiled']}; warm-up {info['warmup_s']:.3f} s, capture "
          f"{info['capture_s']:.3f} s, graph pool +{info['pool_reserved_bytes'] / 2**30:.3f} GiB reserved")
    del comp
    return dict(eager_ms=eager_ms, compiled_ms=compiled_ms)


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


def hold_backward(attrs, tb, count, tile_out, g_tiles, ty, tx, tile, max_blocks, what, bf16=False):
    """The backward and fold kernels (`grad_attrs`) against blend_tiles_bwd
    and the plain fold on the same packed rows, binning and cotangents, and
    the fold kernel against the float64 plain fold of the kernel's own
    rows; two kernel runs must agree to the bit. `bf16`: the kernels read
    `bf16_rows(attrs)`, the plain backward its bf16 mode. Returns the
    errors, the kernels' gradient rows and the inputs, for timing."""
    from hidegs_tpu_torch.raster import blend_plain, cuda_blend

    rows_k = blend_plain.bf16_rows(attrs) if bf16 else attrs
    g_aug = blend_plain.augment_cotangents(tile_out, g_tiles)
    got = cuda_blend.grad_attrs(rows_k, tb, count, g_aug, tx, tile)
    rows = blend_plain.blend_tiles_bwd(blend_plain.unpack_attrs(attrs), tb, g_aug, ty, tx, tile, max_blocks, bf16)
    want = blend_plain.fold_rows(blend_plain.expansion_rows(rows, tb.slot_s), tb.g_start)
    abs_err, norm_err, needed = hold_grads(got, want, what)
    k_rows_exp = cuda_blend.instance_rows(rows_k, tb, count, g_aug, tx, tile)  # expansion order
    fold_err, fold_used = hold_fold(k_rows_exp, tb.g_start, got, f"{what}, fold")
    check(torch.equal(got, blend_plain.fold_rows(k_rows_exp, tb.g_start)),
          f"{what}: the fold kernel is not bitwise the plain fold")
    again = cuda_blend.grad_attrs(rows_k, tb, count, g_aug, tx, tile)
    check(torch.equal(again, got), f"{what}: two backward runs differ")
    return dict(err=abs_err, norm_err=norm_err, needed=needed, fold_err=fold_err, fold_used=fold_used,
                attrs=attrs, count=count, g_aug=g_aug, rows_exp=k_rows_exp, got=got)


def hold_report(h):
    return (f"max abs err {h['err']:.3e}, max normalised err {h['norm_err']:.3e} (tol {GRAD_NORM_TOL}), "
            f"per element needed {h['needed']:.3e} x median (tol {GRAD_MEDIAN_ATOL}); fold vs float64: "
            f"max abs err {h['fold_err']:.3e}, {h['fold_used']:.3f} of its bound, bitwise the float32 plain "
            f"fold; two runs bitwise equal")


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


def train_cell(scene, cams, cfg):
    """The train cell (phases 8 and 15): the four rendered views as
    targets, the trainable state, the TrainConfig and the batches."""
    import dataclasses

    from hidegs_tpu_torch.raster.api import render, round_budget
    from hidegs_tpu_torch.train import loop as tl

    dev = scene.means3d.device
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
    return dict(targets=targets, extent=extent, capacity=capacity, ts=ts, rcfg=rcfg, tcfg=tcfg, batches=batches,
                pcfg=pcfg)


def phase_train(scene, cams, cfg):
    """The training path at full width; launch counts read around it. Its
    densify round replays the compiled round, held against the eager one."""
    from hidegs_tpu_torch.train import compiled
    from hidegs_tpu_torch.train import loop as tl
    from hidegs_tpu_torch.utils import graphs

    t0 = time.perf_counter()
    cell = train_cell(scene, cams, cfg)
    targets, extent, capacity, ts = cell["targets"], cell["extent"], cell["capacity"], cell["ts"]
    rcfg, tcfg, batches, pcfg = cell["rcfg"], cell["tcfg"], cell["batches"], cell["pcfg"]
    del cell
    psnr0, views0 = mean_psnr(ts, cams, targets, pcfg)
    alive0 = int(ts.gaussians.alive.sum())
    print(f"[train] capacity {capacity}, alive {alive0}, extent {extent:.3f}, max_instances "
          f"{rcfg.max_instances}, max_blocks {rcfg.max_blocks}; mean PSNR before {psnr0:.4f} dB "
          f"(views {', '.join(f'{v:.3f}' for v in views0)}) (set-up {time.perf_counter() - t0:.1f} s)")

    reset_counts()
    t0 = time.perf_counter()
    metrics, rounds = [], []
    densify = compiled.CompiledDensify()  # the round replays its graph, as in the trainer
    for k in range(TRAIN_STEPS):
        ts, m = tl.train_step(ts, batches[k % len(batches)], tcfg)
        metrics.append(m)
        before, gen = ts, ts.generator.get_state()
        ts, info = tl.maybe_host_side_schedule(ts, tcfg, extent, step=k + 1, compiled=densify)
        if info is not None:  # keep both sides: the round's state is its graph's buffers, which the scrubs
            # after the densify window overwrite
            rounds.append((k + 1, {key: v.clone() for key, v in info.items()}, before,
                           graphs._map(torch.clone, ts), gen))
    launches = read_counts()
    wall_s = time.perf_counter() - t0
    print(f"[train] {TRAIN_STEPS} steps in {wall_s:.2f} s host wall; launches on the train path: {launches}")
    check(launches == kernel_dict(per_kernel(TRAIN_STEPS, TRAIN_STEPS, TRAIN_STEPS)),
          f"train path launches {launches}, expected one of each kernel per step")
    for k, m in enumerate(metrics):
        check(bool(torch.isfinite(m["total"])), f"train step {k}: loss {float(m['total'])}")
        check(float(m["step_ok"]) == 1.0, f"train step {k}: step_ok {float(m['step_ok'])}")
        for key in ("overflow", "block_overflow", "visible_overflow"):
            check(int(m[key]) == 0, f"train step {k}: {key} = {int(m[key])}")
    print("[train] losses: " + ", ".join(f"{float(m['total']):.5f}" for m in metrics))
    check([r[0] for r in rounds] == [DENSIFY_AT], f"densify rounds ran at {[r[0] for r in rounds]}")
    _, info, pre_round, post_round, gen = rounds[0]
    print(f"[train] densify at step {DENSIFY_AT}: " + ", ".join(f"{k} {float(v):.6g}" for k, v in info.items()))
    hold_densify_round(densify, pre_round, post_round, info, gen, extent, tcfg)
    del densify
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


def same_bits(a, b):
    """Bitwise equality of two tensors, NaNs included."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def hold_densify_round(densify, pre_round, post_round, info, gen, extent, tcfg):
    """The train phase's densify round, replayed from the compiled pair
    (train/compiled.py:CompiledDensify), against the eager `densify_step`
    on the same state and draws: every tensor of the state and every info
    value bitwise equal. Times both from the round's input state (CUDA
    events, the host's split draws included) and one of each under the
    profiler."""
    from hidegs_tpu_torch.train import loop as tl
    from hidegs_tpu_torch.utils.graphs import _tensors

    dev = pre_round.gaussians.alive.device

    def with_gen():
        g = torch.Generator()
        g.set_state(gen)
        return pre_round._replace(generator=g)

    eager, einfo = tl.densify_step(with_gen(), extent, tcfg)
    for n, (a, b) in enumerate(zip(_tensors(post_round), _tensors(eager), strict=True)):
        check(same_bits(a, b), f"densify round: the compiled round's state tensor {n} differs from the eager round's")
    check(einfo.keys() == info.keys() and all(same_bits(info[k], einfo[k]) for k in info),
          "densify round: the compiled round's info differs from the eager round's")
    # after the window every DENSIFY_AT-th step scrubs: the pair's second graph
    n_scrubs = sum(1 for k in range(DENSIFY_AT + 1, TRAIN_STEPS + 1) if k % DENSIFY_AT == 0)
    check([c["kind"] for c in densify.captures] == ["densify", "scrub"] and densify.replays == 1 + n_scrubs,
          f"densify round: captures {[c['kind'] for c in densify.captures]}, {densify.replays} replays; expected "
          f"the round and the scrub, {1 + n_scrubs} replays")
    del eager, einfo
    # the times replay a pair of their own: the held round's buffers
    # (`post_round`) stay as the round left them
    timed = type(densify)()
    src = with_gen()
    eager_ms = time_ms(lambda: tl.densify_step(src, extent, tcfg), warmup=1, iters=5)
    compiled_ms = time_ms(lambda: timed.densify_step(src, extent, tcfg), warmup=1, iters=5)
    host = []
    for _ in range(5):
        sync(dev)
        t0 = time.perf_counter()
        timed.densify_step(src, extent, tcfg)
        host.append(1e3 * (time.perf_counter() - t0))
    sync(dev)
    profs = {mode: profile_device(fn, f"densify-{mode}")
             for mode, fn in (("eager", lambda: tl.densify_step(src, extent, tcfg)),
                              ("compiled", lambda: timed.densify_step(src, extent, tcfg)))}
    busy = {mode: "not measured" if p is None else f"{p['busy_ms']:.3f} ms busy ({p['busy_ms'] / p['wall_ms']:.1%})"
            for mode, p in profs.items()}
    c = densify.captures[0]
    print(f"[densify] the round at step {DENSIFY_AT} replayed its graph, the {n_scrubs} scrubs after the window "
          f"theirs; the round's state and info bitwise the eager round's on the same draws; CUDA events, median of 5 after 1 (the host's split draws included): eager "
          f"{eager_ms:.3f} ms, compiled {compiled_ms:.3f} ms; host ms per compiled round (draws, copy-in, launch) "
          f"{statistics.median(host):.3f}; under the profiler eager {busy['eager']}, compiled {busy['compiled']}; "
          f"warm-up {c['warmup_s']:.3f} s, capture {c['capture_s']:.3f} s, graph pool "
          f"+{c['pool_reserved_bytes'] / 2**30:.3f} GiB reserved")
    del timed
    return dict(eager_ms=eager_ms, compiled_ms=compiled_ms)


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


def find_nodes(root, name):
    """Every node of class `name` in the autograd graph under `root`."""
    seen, stack, found = set(), [root], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == name:
            found.append(node)
        stack.extend(fn for fn, _ in node.next_functions)
    return found


def find_node(root, name):
    """The first node of class `name` in the autograd graph under `root`."""
    found = find_nodes(root, name)
    check(bool(found), f"no {name} node in the step's graph")
    return found[0]


def keep_backward_inputs(node, got):
    """Hooks on a blend node that keep what its backward is given (the
    rows it saved, the tile planes, the binning, the visited counts and the
    planes' cotangents) and what it returns (`d_attrs`). Returns the
    hooks' handles."""
    def keep(grad_outputs):
        attrs, tile_out = (x.detach() for x in node.saved_tensors)
        got.update(attrs=attrs, tile_out=tile_out, g_tiles=grad_outputs[0].contiguous(), tb=node.binning,
                   count=node.count, args=node.args)

    def keep_result(grad_inputs, _grad_outputs):
        got.update(d_attrs=grad_inputs[0])

    return node.register_prehook(keep), node.register_hook(keep_result)


def blend_backward_inputs(ts, batch, tcfg):
    """One step's forward and backward (train_step's own stages) with a
    pre-hook on the blend's autograd node, which keeps what the node's
    backward is given: the packed rows, the tile planes, the binning, the
    visited counts and the planes' cotangents."""
    from hidegs_tpu_torch.train import loop as tl

    loss, _, inputs = tl.step_forward(ts, batch, tcfg)
    node = find_node(loss.grad_fn, "BlendPackedBackward")
    got = {}
    handles = keep_backward_inputs(node, got)
    tl.step_backward(loss, inputs)
    for h in handles:
        h.remove()
    check(bool(got), "the blend's backward did not run")
    return got


def phase_hold_train(train):
    ts, tcfg = train["ts"], train["tcfg"]
    b = blend_backward_inputs(ts, train["batches"][0], tcfg)
    ty, tx, tile, max_blocks, _bf16 = b["args"]
    h = hold_backward(b["attrs"], b["tb"], b["count"], b["tile_out"], b["g_tiles"], ty, tx, tile, max_blocks,
                      "full-width backward, view 0")
    check(torch.equal(b["d_attrs"], h["got"]), "full-width backward: the node's d_attrs are not bitwise the launchers'")
    print(f"[hold-bwd] view 0, trained state, the cotangents one train step gives its blend: backward + fold "
          f"kernels vs blend_tiles_bwd + plain fold: {hold_report(h)}")
    return dict(tb=b["tb"], ty=ty, tx=tx, g_tiles=b["g_tiles"], **h)


def scalar_fold_fn():
    """The scalar fold of tools/csrc/fold_rows_scalar.cu (built in phase 1)."""
    from hidegs_tpu_torch.raster import cuda_blend

    lib = cuda_blend.build({"fold_rows_scalar": SCALAR_FOLD_SRC})["fold_rows_scalar"]
    return cuda_blend.bind(lib, "hidegs_fold_rows_scalar", 2, 1, 0, 2)


def fold_ab(rows_exp, tb, N):
    """The fold kernel on the backward's expansion-order rows against the
    path it replaced on the same rows: the sorted-instance rows scattered
    into a new (I, 16) buffer by blend_plain.expansion_rows, then the scalar
    fold. Both must equal the plain fold bitwise. Times in turns (fold,
    scalar path, scalar path, fold) with time_ms, one launch at a time, as
    every kernel of the `kernels` line is timed; then each again over runs
    of 20 back-to-back launches (time_per_launch_ms), which leaves out the
    gap the host's enqueue opens before a single short launch. The fold's
    bound counts the bytes it must move: the expansion rows that hold
    instances read once, g_start read once, the output rows written once."""
    from hidegs_tpu_torch.raster import blend_plain, cuda_blend

    dev = rows_exp.device
    g_start = tb.g_start.contiguous()
    slot_s = tb.slot_s.long()
    sorted_rows = rows_exp[slot_s]  # the layout the backward kernel wrote before
    scalar = scalar_fold_fn()
    stream = torch.cuda.current_stream().cuda_stream
    new_out = torch.empty((N, cuda_blend.ATTR), device=dev)
    old_out = torch.empty_like(new_out)

    def new_path():
        cuda_blend.launch_fold_rows(rows_exp, g_start, new_out)

    def old_path():
        scattered = blend_plain.expansion_rows(sorted_rows, tb.slot_s)
        rc = scalar(scattered.data_ptr(), g_start.data_ptr(), N, old_out.data_ptr(), stream)
        check(rc == 0, f"scalar fold launch failed: cudaError {rc}")

    def old_kernel_only():
        rc = scalar(rows_exp.data_ptr(), g_start.data_ptr(), N, old_out.data_ptr(), stream)
        check(rc == 0, f"scalar fold launch failed: cudaError {rc}")

    new_path()
    old_path()
    plain = blend_plain.fold_rows(rows_exp, g_start)
    check(torch.equal(new_out, plain), "the fold kernel is not bitwise the plain fold at full width")
    check(torch.equal(new_out, old_out), "the fold kernel is not bitwise the scalar fold path at full width")
    turns = [time_ms(fn) for fn in (new_path, old_path, old_path, new_path)]
    b2b = [time_per_launch_ms(fn) for fn in (new_path, old_path, old_kernel_only)]
    fold_ms = statistics.median([turns[0], turns[3]])
    plain_ms = time_ms(lambda: blend_plain.fold_rows(rows_exp, g_start))
    total = int(tb.num_instances.clamp(max=rows_exp.shape[0]))
    visible = int((torch.diff(g_start.long()) > 0).sum())
    fold_bound = (total * 64 + (N + 1) * 4 + N * 64) / HBM_BYTES_S * 1e3
    print(f"[train-times] fold kernel in turns with the scalar fold path (fold, scalar path, scalar path, fold), "
          f"one launch at a time: {', '.join(f'{t:.4f}' for t in turns)} ms; per launch over runs of 20 "
          f"back-to-back launches: fold {b2b[0]:.4f}, scalar path {b2b[1]:.4f}, the scalar fold kernel alone "
          f"{b2b[2]:.4f} ms; plain (segment_reduce, float32) {plain_ms:.3f} ms; the fold is bitwise the plain "
          f"fold and the scalar path")
    print(f"[train-times] fold bound {fold_bound:.4f} ms (bytes: {total} expansion rows in, {N + 1} span bounds, "
          f"{N} rows out, {visible} of them with a non-empty span); one launch at a time the fold is at "
          f"{fold_bound / fold_ms:.1%} of it and the scalar path at {fold_bound / statistics.median(turns[1:3]):.1%}; "
          f"back to back the fold at {fold_bound / b2b[0]:.1%}, the scalar fold kernel at {fold_bound / b2b[2]:.1%}")
    return dict(ms=fold_ms, plain_ms=plain_ms, bound_ms=fold_bound, bound_by="bytes")


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
    slot_s = tb.slot_s.contiguous()

    def launch_bwd():
        rows.zero_()
        cuda_blend.launch_blend_bwd(attrs, tb.gauss_id, tb.tile_start, count, tx, tile, slot_s, g_aug, rows)

    bwd_ms = time_ms(launch_bwd)
    view = blend_plain.unpack_attrs(attrs)
    bwd_plain_ms = time_ms(lambda: blend_plain.blend_tiles_bwd(view, tb, g_aug, ty, tx, tile,
                                                               tcfg.raster.max_blocks))
    fold = fold_ab(rows_exp, tb, N)
    zeros = torch.zeros((N + 1, cuda_blend.ATTR), device=attrs.device)
    owner = tb.owner.long()
    fold_library_ms = time_ms(lambda: zeros.index_add_(0, owner, rows_exp))

    post_cull = int(count.sum())
    unique_rows = int(torch.unique(tb.gauss_id[:post_cull]).numel())
    counts = blend_plain.pair_counts(view, tb, tx, tile, tcfg.raster.max_blocks)
    # the rows, the cotangents, the spans, the gather ids, the expansion
    # slots (the new addressing of the rows) and the rows written
    bwd_bytes = post_cull * 4 + 2 * T * 4 + unique_rows * 64 + T * P * 48 + I * 4 + I * 64
    bound = blend_bound(bwd_bytes, counts, tile, BWD_OPS_PER_LIVE_PAIR, BWD_OPS_PER_KEPT_PAIR,
                        BWD_SFU_PER_KEPT_PAIR)
    print(f"[train-times] backward kernel {bwd_ms:.3f} ms, plain {bwd_plain_ms:.3f} ms; {bound['text']}; "
          f"kernel at {bound['bound_ms'] / bwd_ms:.1%} of the bound, {bound['yardstick_ms'] / bwd_ms:.1%} of the "
          f"yardstick (post-cull instances {post_cull}, pairs live {counts[0]} kept {counts[1]} open {counts[2]})")
    print(f"[train-times] fold: index_add_ {fold_library_ms:.3f} ms (atomics: not deterministic)")
    print(f"[train-times] backward: {mask_report(view, tb, tx, tile, count, counts[0])}; ptxas (build log): "
          f"{usage_report(ptxas_usage(cuda_blend.build()['blend_bwd']))}")
    profile_device(lambda: tl.train_step(ts, batch, tcfg), "train-breakdown")
    return dict(step_ms=step_ms, split=split,
                bwd=dict(ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bound["bound_ms"], bound_by=bound["bound_by"]),
                fold=dict(fold, library_ms=fold_library_ms))


COMPILED_STEPS = 30  # single- and multi-view steps of each mode in the compiled phase (11a)
COMPILED_SHORT = 5  # steps of the exposure, row-budget and compaction variants


def first_difference(a, b):
    """None when the tensors of two train states are bitwise equal, else
    the first that differs: (index, its shape, max abs difference)."""
    from hidegs_tpu_torch.utils import graphs

    for n, (x, y) in enumerate(zip(graphs._tensors(a), graphs._tensors(b), strict=True)):
        if not torch.equal(x, y):
            return n, tuple(x.shape), max_abs_err(x.float(), y.float())
    return None


def phase_compiled(scene, cams, cfg):
    """11a. The compiled train step (train/compiled.py) beside the eager
    one, from the same fresh train-cell state: COMPILED_STEPS single-view
    steps, COMPILED_STEPS multi-view steps (each view with its row
    neighbour as the source, both modes fed the same injected samples),
    and COMPILED_SHORT steps each with use_exposure, a row budget below
    the capacity, and visible-row compaction (max_visible). One
    CompiledTrainStep holds every key, so their graphs share one pool.
    Gates: after every step the two states and the metrics bitwise equal;
    every replay (all but each variant's first call, which warms up and
    captures) under set_sync_debug_mode("error"); launches exact: the
    graph's recorded launches (1 or 2 of each kernel) per replay, the
    warm-up's once per capture. Prints ms per step of both modes (CUDA
    events, median of 10 after 2 warm-ups), the host ms per replay, each
    key's warm-up and capture seconds and the graph pool's growth, the
    peak memory of both modes, and one step of each mode under the
    profiler."""
    import dataclasses

    from hidegs_tpu_torch.raster.api import round_budget
    from hidegs_tpu_torch.train import compiled
    from hidegs_tpu_torch.train import loop as tl
    from hidegs_tpu_torch.train.geometric import MultiViewBatch, sample_pixels

    dev = scene.means3d.device
    cell = train_cell(scene, cams, cfg)
    ts0, tcfg, batches = cell["ts"], cell["tcfg"], cell["batches"]
    del cell
    N = scene.means3d.shape[0]
    mv_cfg = dataclasses.replace(tcfg, multi_view_from=0)
    gray = [b.image.mean(0) for b in batches]

    def mv_batch(i):
        j = i ^ 1  # the view beside it on its grid row
        return batches[i]._replace(multi_view=MultiViewBatch(src_image_gray=gray[j], src_cam=batches[j].cam))

    # the compaction budget: the trainer's rule (+25%, quarter-octave) over
    # the views' visible rows
    peak = max(int(tl.train_step(ts0, b, tcfg)[1]["num_visible"]) for b in batches)
    ccfg = dataclasses.replace(tcfg, raster=dataclasses.replace(tcfg.raster, max_visible=round_budget(int(peak * 1.25))))
    row_budget = -(-N // 4096) * 4096
    variants = [
        ("single-view", tcfg, False, 0, [batches[k % 4] for k in range(COMPILED_STEPS)]),
        ("multi-view", mv_cfg, False, 0, [mv_batch(k % 4) for k in range(COMPILED_STEPS)]),
        ("exposure", tcfg, True, 0, [batches[k % 4] for k in range(COMPILED_SHORT)]),
        ("row budget", tcfg, False, row_budget, [batches[k % 4] for k in range(COMPILED_SHORT)]),
        ("compaction", ccfg, False, 0, [batches[k % 4] for k in range(COMPILED_SHORT)]),
    ]
    print(f"[compiled] train cell: capacity {ts0.gaussians.capacity}, {N} alive rows; row budget {row_budget}; "
          f"compaction budget {ccfg.raster.max_visible} (peak visible {peak}); {COMPILED_STEPS} single- and "
          f"multi-view steps, {COMPILED_SHORT} of each other variant")
    step = compiled.CompiledTrainStep()
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    results = {}
    for name, vcfg, use_exposure, rb, vbatches in variants:
        eager = comp = ts0
        per_step = 2 if vbatches[0].multi_view is not None else 1
        gen = torch.Generator(device=dev).manual_seed(7)
        diverged, mv_valid = None, 0
        for k, batch in enumerate(vbatches):
            uv = None
            if batch.multi_view is not None:
                uv = sample_pixels(gen, vcfg.multi_view_sample_num, batch.cam.height, batch.cam.width,
                                   vcfg.multi_view_patch_half)
            eager, em = tl.train_step(eager, batch, vcfg, use_exposure, rb, uv=uv)
            sync(dev)
            direct, replayed, n_captures = direct_counts(), replay_counts(), len(step.captures)
            if k > 0:
                torch.cuda.set_sync_debug_mode("error")
            try:
                comp, cm = step(comp, batch, vcfg, use_exposure, rb, uv=uv)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sync(dev)
            d = tuple(b - a for a, b in zip(direct, direct_counts()))
            r = tuple(b - a for a, b in zip(replayed, replay_counts()))
            captured = len(step.captures) > n_captures
            check(captured == (k == 0), f"compiled {name} step {k}: captured {captured}")
            want = per_kernel(per_step, per_step, 1)
            check(r == want and d == (want if captured else per_kernel(0, 0)),
                  f"compiled {name} step {k}: replayed launches {r}, the launchers' {d}")
            for j, key in enumerate(launches):
                launches[key] += d[j] + r[j]
            bad = [m for m in em if not torch.equal(em[m], cm[m])]
            diff = first_difference(comp, eager)
            if (bad or diff) and diverged is None:
                diverged = (k, bad, diff)
            mv_valid += int(batch.multi_view is not None and float(cm["mv_geo"]) > 0)
            check(float(cm["step_ok"]) == 1.0 and bool(torch.isfinite(cm["total"])), f"compiled {name} step {k}")
        check(diverged is None, f"compiled {name}: the compiled and eager states part at step {diverged[0] if diverged else None}: "
                                f"metrics {diverged[1] if diverged else None}, state tensor {diverged[2] if diverged else None}")
        info = step.captures[-1]
        print(f"[compiled] {name}: {len(vbatches)} steps, compiled and eager states and metrics bitwise equal after "
              f"every step; replays made no host sync; {per_step} of each kernel's launches per replay"
              + (f"; {mv_valid} steps with valid multi-view samples" if per_step == 2 else "")
              + f"; warm-up {info['warmup_s']:.3f} s, capture {info['capture_s']:.3f} s, graph pool +"
              f"{info['pool_reserved_bytes'] / 2**30:.3f} GiB reserved")

        # times of both modes from the same state, the batch of step 0
        batch = vbatches[0]
        uv = None if batch.multi_view is None else sample_pixels(gen, vcfg.multi_view_sample_num, batch.cam.height,
                                                                 batch.cam.width, vcfg.multi_view_patch_half)
        eager_ms = time_ms(lambda: tl.train_step(ts0, batch, vcfg, use_exposure, rb, uv=uv))
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        tl.train_step(ts0, batch, vcfg, use_exposure, rb, uv=uv)
        sync(dev)
        eager_peak = torch.cuda.max_memory_allocated(dev) - base
        compiled_ms = time_ms(lambda: step(comp, batch, vcfg, use_exposure, rb, uv=uv))
        host = []
        for _ in range(ITERS):
            sync(dev)
            t0 = time.perf_counter()
            step(comp, batch, vcfg, use_exposure, rb, uv=uv)
            host.append(1e3 * (time.perf_counter() - t0))
        sync(dev)
        results[name] = dict(eager_ms=eager_ms, compiled_ms=compiled_ms, host_ms=statistics.median(host),
                             capture_s=info["capture_s"], warmup_s=info["warmup_s"],
                             pool_gib=info["pool_reserved_bytes"] / 2**30, eager_peak_gib=eager_peak / 2**30)
        print(f"[compiled] {name}: ms per step (CUDA events, median of {ITERS} after {WARMUP}) eager {eager_ms:.3f}, "
              f"compiled {compiled_ms:.3f} ({eager_ms / compiled_ms:.2f}x); host ms per replay (copy-in and "
              f"launch, median of {ITERS}) {statistics.median(host):.3f}; an eager step allocates "
              f"{eager_peak / 2**30:.3f} GiB at its peak above what was allocated before it (the new state "
              f"included); a replay allocates nothing: its memory is the graph pool")
        if name in ("single-view", "multi-view"):
            for mode, fn in (("eager", lambda: tl.train_step(ts0, batch, vcfg, use_exposure, rb, uv=uv)),
                             ("compiled", lambda: step(comp, batch, vcfg, use_exposure, rb, uv=uv))):
                results[name][f"{mode}_profile"] = profile_device(fn, f"compiled-{name}-{mode}")
        del eager, comp
    pool = sum(c["pool_reserved_bytes"] for c in step.captures) / 2**30
    print(f"[compiled] {len(step.captures)} captures, {step.replays} replays in one CompiledTrainStep; the graph "
          f"pool grew by {pool:.3f} GiB over its captures (reserved after each capture less before it); "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB reserved by this process; launches on the compiled "
          f"path (replays and warm-ups of the gated steps): {launches}")
    return dict(launches=launches, results=results, pool_gib=pool)


def trainer_timing_plan(n_iters, check_every):
    """Which trainer iterations each timed window counts, and where the
    host clock is read (after a synchronise) at the start of a train step.
    An iteration's time runs from the start of its train step to the start
    of the next; the windows leave out the iterations whose time holds a
    checkpoint save, the densify round or the next iteration's read of the
    budget counters (one every `check_every` steps)."""
    excluded = set(TRAINER_SAVES) | {TRAINER_DENSIFY_AT}
    excluded |= {it - 1 for it in range(2, n_iters + 2) if (it - 1) % check_every == 0}
    counted = {name: [it for it in range(lo, hi + 1) if it not in excluded]
               for name, (lo, hi) in TRAINER_WINDOWS.items()}
    every = set().union(*counted.values())
    stamps = {it for it in range(1, n_iters + 1) if (it in every) != (it - 1 in every)}
    check(max(every) < n_iters, "the last iteration of a window needs the next step's start as its end")
    return counted, stamps


def window_ms(counted, stamps_at):
    """Mean ms per iteration over the runs of consecutive counted
    iterations, each run timed between the stamps at its two ends."""
    total, runs = 0.0, []
    start = None
    for it in counted:
        if start is None or it - 1 not in counted:
            start = it
        if it + 1 not in counted:
            total += stamps_at[it + 1] - stamps_at[start]
            runs.append((start, it))
            start = None
    return 1e3 * total / len(counted), runs


# the per-step metrics the trainer phase reads (cloned after each step: the
# compiled step's metrics live until its next replay)
TRAINER_KEYS = ("total", "photo", "single_view", "mv_ncc", "mv_geo", "step_ok", "overflow", "block_overflow",
                "visible_overflow")


def run_trainer(args, dev, stamp_its, eager=False):
    """`trainer.main(args)` (what `python -m hidegs_tpu_torch.train` runs)
    with each train step watched: the host clock (synchronised) at the
    iterations in `stamp_its`, the launches of each step, split into the
    launchers' own (the eager step, a capture's warm-up) and the replays',
    whether it captured a graph, and its metrics. On the card the trainer
    runs the compiled step; `eager=True` hands it `loop.train_step`
    instead, for the comparison of one run with the other."""
    from hidegs_tpu_torch.data import scene as scene_io
    from hidegs_tpu_torch.train import loop as tl
    from hidegs_tpu_torch.train import trainer

    stamps, steps, timers, made = {}, [], {}, []

    def timed(key):
        def wrap(fn):
            def call(*args, **kwargs):
                sync(dev)
                t = time.perf_counter()
                res = fn(*args, **kwargs)
                sync(dev)
                timers[key] = time.perf_counter() - t
                return res
            return call
        return wrap

    def spy_step(step_fn):
        def call(ts, batch, tcfg, *args, **kwargs):
            it = len(steps) + 1
            if it in stamp_its or it == 1:
                sync(dev)
                stamps[it] = time.perf_counter()
            direct, replayed = direct_counts(), replay_counts()
            n_captures = len(getattr(step_fn, "captures", ()))
            ts, metrics = step_fn(ts, batch, tcfg, *args, **kwargs)
            if it == 1:
                sync(dev)
                timers["first_step"] = time.perf_counter() - stamps[1]
            steps.append(dict(direct=tuple(b - a for a, b in zip(direct, direct_counts())),
                              replayed=tuple(b - a for a, b in zip(replayed, replay_counts())),
                              captured=len(getattr(step_fn, "captures", ())) > n_captures,
                              metrics={k: metrics[k].clone() for k in TRAINER_KEYS if k in metrics},
                              mv=batch.multi_view is not None, batch=batch, tcfg=tcfg))
            return ts, metrics
        return call

    def step_factory(compiled_step):
        def make():
            made.append(tl.train_step if eager else compiled_step())
            return spy_step(made[-1])
        return make

    with contextlib.ExitStack() as stack:
        for obj, name, wrapper in ((scene_io, "load_scene", timed("load_scene")),
                                   (trainer, "init_gaussians_from_scene", timed("init")),
                                   (trainer, "CompiledTrainStep", step_factory)):
            stack.enter_context(patched(obj, name, wrapper))
        reset_counts()
        t0 = time.perf_counter()
        ts = trainer.main(args)
        sync(dev)
        t_main = time.perf_counter() - t0
        launches = read_counts()
    check(len(made) == 1 and len(steps) == TRAINER_ITERS,
          f"trainer: {len(steps)} train steps of {len(made)} step functions, expected {TRAINER_ITERS} of one")
    return dict(ts=ts, steps=steps, stamps=stamps, timers=timers, t_main=t_main, launches=launches,
                captures=getattr(made[0], "captures", []))


def phase_trainer(scene, cams, cfg):
    """The trainer at full width, as a user runs it: the render cell's four
    views written as a COLMAP scene, then `trainer.main` (what `python -m
    hidegs_tpu_torch.train` runs) for TRAINER_ITERS iterations with the
    multi-view terms from TRAINER_MV_FROM on, on the compiled step; then
    `evaluate.main` on the first and the last checkpoint; then the same
    run on the eager step, for the times of both in one call. Launch counts
    are read around each of the trainer's train steps alone."""
    from hidegs_tpu_torch import evaluate
    from hidegs_tpu_torch.data import scene as scene_io
    from hidegs_tpu_torch.data.synthetic import write_synthetic_colmap_scene
    from hidegs_tpu_torch.raster.api import RasterConfig
    from hidegs_tpu_torch.train import trainer

    dev = scene.means3d.device
    work = ROOT / "build" / "trainer_smoke"
    shutil.rmtree(work, ignore_errors=True)
    src, model = work / "scene", work / "model"
    t0 = time.perf_counter()
    write_synthetic_colmap_scene(str(src), scene, cams, point_stride=4,
                                 render_config=RasterConfig(tile=cfg.tile, max_instances=cfg.max_instances))
    t_write = time.perf_counter() - t0
    loaded = scene_io.load_scene(str(src))
    n_views = len(loaded.train_cameras)
    check(n_views == len(cams) and all(loaded.neighbors.get(i) for i in range(n_views)),
          f"trainer: every training view needs a neighbour, got {loaded.neighbors}")
    print(f"[trainer] wrote the COLMAP scene ({n_views} views {FULL_W}x{FULL_H}, {len(loaded.info.points)} sparse "
          f"points) in {t_write:.2f} s; neighbours {loaded.neighbors}")
    del loaded

    counted, stamp_its = trainer_timing_plan(TRAINER_ITERS, trainer.OVERFLOW_CHECK_EVERY)

    def args_for(model_dir):
        return ["--source_path", str(src), "--model_path", str(model_dir), "--iterations", str(TRAINER_ITERS),
                "--freq_warmup_iterations", "0", "--single_view_weight_from_iter", "0",
                "--multi_view_weight_from_iter", str(TRAINER_MV_FROM), "--densify_from_iter", "1",
                "--densify_until_iter", str(TRAINER_DENSIFY_AT), "--densification_interval", str(TRAINER_DENSIFY_AT),
                "--save_iterations", *map(str, TRAINER_SAVES), "--device", str(dev)]

    run = run_trainer(args_for(model), dev, stamp_its)
    steps, launches, timers = run["steps"], run["launches"], run["timers"]
    mv = [s["mv"] for s in steps]
    check(mv == [False] * (TRAINER_MV_FROM - 1) + [True] * (TRAINER_ITERS - TRAINER_MV_FROM + 1),
          f"trainer: multi-view steps at {[i + 1 for i, m in enumerate(mv) if m]}")
    for i, s in enumerate(steps):
        want = per_kernel(2, 2, 1) if s["mv"] else per_kernel(1, 1, 1)
        check(s["replayed"] == want and s["direct"] == (want if s["captured"] else per_kernel(0, 0)),
              f"trainer iteration {i + 1}: replayed launches {s['replayed']}, the launchers' {s['direct']} "
              f"(captured: {s['captured']}), expected {want} replayed and the warm-up's on a capture")
    names = list(launches)
    in_steps = {k: sum(s["replayed"][j] for s in steps) for j, k in enumerate(names)}
    warmups = {k: sum(s["direct"][j] for s in steps) for j, k in enumerate(names)}
    renders = (TRAINER_MV_FROM - 1) + 2 * (TRAINER_ITERS - TRAINER_MV_FROM + 1)
    want = kernel_dict(per_kernel(renders, renders, TRAINER_ITERS))
    check(in_steps == want, f"trainer: replayed launches in the train steps {in_steps}, expected {want}")
    vals = torch.stack([torch.stack([s["metrics"].get(k, torch.zeros((), device=dev)).to(torch.float64)
                                     for k in TRAINER_KEYS]) for s in steps]).cpu().numpy()
    check(bool(np.isfinite(vals).all()), "trainer: a non-finite loss or metric")
    check(bool((vals[:, TRAINER_KEYS.index("step_ok")] == 1.0).all()),
          "trainer: a step was skipped by the finite-step gate")
    overflow = vals[:, TRAINER_KEYS.index("overflow"):].sum()
    others = {k: launches[k] - in_steps[k] - warmups[k] for k in names}
    captured_at = [i + 1 for i, s in enumerate(steps) if s["captured"]]
    print(f"[trainer] {TRAINER_ITERS} iterations on the compiled step in {run['t_main']:.2f} s host wall "
          f"(trainer.main: load, init, train, 2 checkpoint saves); launches on the trainer path {launches}: replayed "
          f"in the train steps {in_steps} ({TRAINER_MV_FROM - 1} single-view steps x 1 + "
          f"{TRAINER_ITERS - TRAINER_MV_FROM + 1} multi-view steps x 2), the captures' warm-up steps {warmups}, "
          f"outside the steps (probe and save renders) {others}; budget overflow summed over steps {overflow:.0f}")
    for c, it in zip(run["captures"], captured_at):
        print(f"[trainer] capture at iteration {it}: {'multi-view' if c['multi_view'] else 'single-view'}, row "
              f"budget {c['row_budget']}, max_instances {c['max_instances']}, max_visible {c['max_visible']}: "
              f"warm-up {c['warmup_s']:.3f} s, capture {c['capture_s']:.3f} s, graph pool "
              f"{c['pool_reserved_bytes'] / 2**30:.3f} GiB reserved")
    for i in (0, TRAINER_MV_FROM - 2, TRAINER_MV_FROM - 1, TRAINER_DENSIFY_AT - 1, TRAINER_ITERS - 1):
        print(f"[trainer] iteration {i + 1}: " + ", ".join(f"{k} {vals[i, j]:.6g}"
                                                          for j, k in enumerate(TRAINER_KEYS[:5])))
    print(f"[trainer] init: load_scene {timers['load_scene']:.3f} s, init_gaussians_from_scene (KNN init) "
          f"{timers['init']:.3f} s, first train step (warm-up, capture, replay) {timers['first_step']:.3f} s "
          f"(host clock, synchronised)")

    # the final state lies on the card
    ts = run["ts"]
    leaves = train_leaves(ts) + [ts.gaussians.protected, ts.gaussians.active_sh_degree, ts.exposure_m,
                                 ts.exposure_v]
    check(all(x.device == dev for x in leaves) and ts.mv_generator.device == dev,
          "trainer: a tensor of the final state is off the card")

    # evaluate reads the model directory: the last checkpoint beats the first
    psnr = {}
    for it in TRAINER_SAVES:
        report = evaluate.main(["--model_path", str(model), "--source_path", str(src), "--iteration", str(it),
                                "--skip_test", "--no_images", "--device", str(dev)])
        psnr[it] = report["train"]["mean"]["psnr"]
        check(np.isfinite(report["train"]["mean"]["lpips"]), f"trainer: LPIPS at iteration {it}")
    print(f"[trainer] evaluate.main: train-view PSNR iteration {TRAINER_SAVES[0]} {psnr[TRAINER_SAVES[0]]:.4f} dB, "
          f"iteration {TRAINER_SAVES[1]} {psnr[TRAINER_SAVES[1]]:.4f} dB")
    check(psnr[TRAINER_SAVES[1]] > psnr[TRAINER_SAVES[0]], "trainer: PSNR did not rise over the run")
    # the grid's views overlap across x on one row only (the image's
    # footprint is 15.6 scene units wide, 8.8 high, the cameras 18 apart):
    # a pair without overlap has no valid sample, and both terms are 0
    geo = vals[:, TRAINER_KEYS.index("mv_geo")]
    overlapping = [i for i, s in enumerate(steps) if s["mv"] and geo[i] > 0]
    n_mv = TRAINER_ITERS - TRAINER_MV_FROM + 1
    check(len(overlapping) >= TRAINER_MIN_OVERLAP_SHARE * n_mv,
          f"trainer: {len(overlapping)} of {n_mv} multi-view steps had a valid sample "
          f"(at least {TRAINER_MIN_OVERLAP_SHARE} of them expected)")
    ncc = vals[overlapping, TRAINER_KEYS.index("mv_ncc")]
    print(f"[trainer] multi-view steps whose pair overlaps (valid samples, mv_geo > 0): {len(overlapping)} of "
          f"{n_mv} (iterations {[i + 1 for i in overlapping]}); over them mv_ncc "
          f"{ncc.min():.4f}-{ncc.max():.4f}, mv_geo {geo[overlapping].min():.4f}-{geo[overlapping].max():.4f}")
    held = steps[overlapping[-1]]
    stamps = run["stamps"]
    del run, steps

    # the same run on the eager step: the times of both in one call
    eager = run_trainer(args_for(work / "model_eager"), dev, stamp_its, eager=True)
    for i, s in enumerate(eager["steps"]):
        want = per_kernel(2, 2, 1) if s["mv"] else per_kernel(1, 1, 1)
        check(s["direct"] == want and s["replayed"] == per_kernel(0, 0),
              f"eager trainer iteration {i + 1}: launches {s['direct']}, expected {want}")
    check(all(bool(torch.isfinite(s["metrics"]["total"])) for s in eager["steps"]), "eager trainer: a non-finite loss")
    window = {}
    for name, its in counted.items():
        ms, runs = window_ms(its, stamps)
        eager_ms, _ = window_ms(its, eager["stamps"])
        window[name] = dict(compiled_ms=ms, eager_ms=eager_ms)
        inside = [it for it in captured_at if it in its]
        print(f"[trainer] ms per trainer iteration, {name} window: compiled step {ms:.3f}, eager step "
              f"{eager_ms:.3f} (the eager run in the same call) over {len(its)} iterations (runs "
              f"{', '.join(f'{a}-{b}' for a, b in runs)}; host clock synchronised at each run's ends; left out: "
              f"saves {TRAINER_SAVES}, densify @{TRAINER_DENSIFY_AT}, the iterations before a counter fetch; "
              f"captures inside the window: {inside or 'none'})")
    shutil.rmtree(work, ignore_errors=True)
    return dict(ts=ts, batch=held["batch"], tcfg=held["tcfg"], launches=launches, window=window)


def hold_node_forward(g, what, tag="trainer-hold"):
    """The forward kernel of one blend node against the plain blend on the
    node's own packed rows and binning, at phase 4's gates: the tile planes
    the node saved (and its backward read) within atol 3e-4 / rtol 1e-3 of
    the plain planes, the observe counts equal on all but 0.1% of the
    gaussians; the kernel run again on the same inputs gives the saved
    planes bitwise. Returns the max abs error of the planes."""
    from hidegs_tpu_torch.raster import blend_plain, cuda_blend

    attrs, tb, saved = g["attrs"], g["tb"], g["tile_out"]
    ty, tx, tile, max_blocks, _bf16 = g["args"]
    k_out, k_obs = cuda_blend.blend_tile_out(attrs, tb, g["count"], ty, tx, tile)
    check(torch.equal(k_out, saved), f"{what}: the node's saved tile planes are not the forward kernel's output")
    p_out, p_obs = blend_plain.blend_tile_out(blend_plain.unpack_attrs(attrs), tb, ty, tx, tile, max_blocks)
    assert_close(saved, p_out, f"{what}, forward tile planes")
    err = max_abs_err(saved, p_out)
    N = attrs.shape[0]
    n_diff = int((k_obs != p_obs).sum())
    check(n_diff <= N // 1000, f"{what}: out_observe differs on {n_diff} of {N} gaussians (> 0.1%)")
    print(f"[{tag}] {what}: forward kernel vs plain blend on the node's rows and binning: max abs err "
          f"{err:.3e} (atol 3e-4 / rtol 1e-3 holds), out_observe differs on {n_diff} of {N} gaussians; the saved "
          f"planes are bitwise the kernel's")
    return err


def phase_trainer_hold(trainer_run):
    """On the trained state, with the view pair of the last multi-view
    iteration that had valid samples: both blend nodes (reference and
    source view), forward, backward and fold, held against the plain
    versions on the node's own rows and binning; two steps
    from one state and generator bitwise equal; a step with the chunk box
    under torch.cuda.set_sync_debug_mode("error"); times of a multi-view
    and a single-view step, and one multi-view step under the profiler."""
    import dataclasses

    from hidegs_tpu_torch.train import compiled
    from hidegs_tpu_torch.train import loop as tl

    ts, batch, tcfg = trainer_run["ts"], trainer_run["batch"], trainer_run["tcfg"]
    check(batch.multi_view is not None, "trainer hold: the last iteration is not a multi-view step")
    uv, _ = tl.draw_step_pixels(ts, batch, tcfg)
    loss, _, inputs = tl.step_forward(ts, batch, tcfg, uv=uv)
    nodes = find_nodes(loss.grad_fn, "BlendPackedBackward")
    check(len(nodes) == 2, f"trainer hold: {len(nodes)} blend nodes in a multi-view step, expected 2")
    got = [{}, {}]
    handles = [h for node, g in zip(nodes, got) for h in keep_backward_inputs(node, g)]
    tl.step_backward(loss, inputs)
    for h in handles:
        h.remove()
    errs, fwd_err = [], 0.0
    for g in got:
        check(bool(g), "trainer hold: a blend backward did not run")
        ty, tx, tile, max_blocks, _bf16 = g["args"]
        fwd_err = max(fwd_err, hold_node_forward(g, f"trainer, multi-view step, blend node {len(errs)}"))
        nz = int((g["g_tiles"].abs().amax(dim=(0, 1)) > 0).sum())
        h = hold_backward(g["attrs"], g["tb"], g["count"], g["tile_out"], g["g_tiles"], ty, tx, tile, max_blocks,
                          f"trainer, multi-view step, blend node {len(errs)}")
        check(torch.equal(g["d_attrs"], h["got"]), "trainer hold: the node's d_attrs are not bitwise the launchers'")
        errs.append(h)
        print(f"[trainer-hold] blend node {len(errs) - 1} ({nz} of 16 cotangent channels non-zero, "
              f"{int(g['tb'].num_instances)} instances): backward + fold kernels vs blend_tiles_bwd + plain fold: "
              f"{hold_report(h)}")
    del got, nodes, loss, inputs

    a, ma = tl.train_step(ts, batch, tcfg)
    b, mb = tl.train_step(ts, batch, tcfg)
    for i, (x, y) in enumerate(zip(train_leaves(a), train_leaves(b))):
        check(torch.equal(x, y), f"two multi-view steps from one state differ in leaf {i}")
    check(torch.equal(ma["total"], mb["total"]) and torch.equal(a.mv_generator.get_state(), b.mv_generator.get_state()),
          "two multi-view steps from one state differ in the loss or the generator")
    print("[trainer-hold] two multi-view steps from one state and generator: params, moments, stats, loss bitwise equal")
    del a, b

    lo = ts.gaussians.params.xyz[ts.gaussians.alive].amin(0).tolist()
    hi = ts.gaussians.params.xyz[ts.gaussians.alive].amax(0).tolist()
    box = ((lo[0] * 0.5, lo[1] * 0.5, -1e9), (hi[0] * 0.5, hi[1] * 0.5, 1e9))
    bcfg = dataclasses.replace(tcfg, chunk_box=box)
    warm, _ = tl.train_step(ts, batch, bcfg)
    sync(ts.step.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        boxed, mbox = tl.train_step(warm, batch, bcfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(float(mbox["step_ok"]) == 1.0 and bool(torch.isfinite(mbox["total"])), "chunk-box step: not finite")
    print(f"[trainer-hold] a multi-view step with the chunk box {box} ran under set_sync_debug_mode('error'): no host "
          f"sync; visible {int(mbox['num_visible'])} rows (without the box {int(ma['num_visible'])})")
    del warm, boxed

    single = tl.ViewBatch(**{**batch._asdict(), "multi_view": None})
    mv_ms = time_ms(lambda: tl.train_step(ts, batch, tcfg))
    sv_ms = time_ms(lambda: tl.train_step(ts, single, tcfg))
    step = compiled.CompiledTrainStep()
    state, _ = step(ts, batch, tcfg)  # the trained state copied in; `ts` stays as it is
    mv_compiled_ms = time_ms(lambda: step(state, batch, tcfg))
    state, _ = step(state, single, tcfg)
    sv_compiled_ms = time_ms(lambda: step(state, single, tcfg))
    print(f"[trainer-times] train step on the trained state (full capacity rows, CUDA events, median of {ITERS}): "
          f"multi-view {mv_ms:.3f} ms eager, {mv_compiled_ms:.3f} ms compiled; single-view {sv_ms:.3f} ms eager, "
          f"{sv_compiled_ms:.3f} ms compiled")
    profile_device(lambda: tl.train_step(ts, batch, tcfg), "trainer-mv-breakdown")
    profile_device(lambda: step(state, batch, tcfg), "trainer-mv-compiled-breakdown")
    del step, state
    return dict(fwd_err=fwd_err, err=max(h["err"] for h in errs), fold_err=max(h["fold_err"] for h in errs),
                mv_ms=mv_ms, sv_ms=sv_ms, mv_compiled_ms=mv_compiled_ms, sv_compiled_ms=sv_compiled_ms)

DP_STEPS = 10  # view-parallel steps (V = 4) per run at full width (phase 15)
DP_RANK_STEPS = 3  # steps of each two-rank run on the card
DP_LEAF_TOL = 1e-2  # tests/test_torch_train.py: parameters within 1e-2·lr on the elements with a gradient
DP_WIRE_M_TOL = 5e-3  # tests/test_torch_train.py: the first step's Adam m within 5e-3 of its max


def nccl_pair_probe(rank, world, init_method):
    """A rank of a two-rank NCCL group on card 0 (phase 15 asks whether
    NCCL takes two ranks on one card)."""
    from hidegs_tpu_torch.parallel import distributed as pdist

    pdist.initialize_distributed(backend="nccl", device=torch.device("cuda", 0), init_method=init_method,
                                 world_size=world, rank=rank)
    try:
        x = torch.ones(4, device="cuda")
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
    finally:
        pdist.shutdown_distributed()


def leaf_lr(tcfg, spatial_lr_scale):
    lr = tcfg.lr
    return {"xyz": lr.position_lr_init * spatial_lr_scale, "sh_dc": lr.feature_lr,
            "sh_rest": lr.feature_lr / lr.feature_rest_div, "scaling": lr.scaling_lr,
            "rotation": lr.rotation_lr, "opacity": lr.opacity_lr}


def hold_params(got, kept, start, tcfg, what):
    """tests/test_torch_train.py's parameter check after len(kept) steps:
    within DP_LEAF_TOL·lr of the reference on the elements whose gradient
    (Adam's m) stood above 1e-1 of its leaf's largest on every reference
    step, unmoved where the reference had none. `got`: numpy params;
    `kept`: the reference's states after each step; `start`: its state
    before them. Returns the largest departure in units of lr."""
    lrs = leaf_lr(tcfg, float(start.gaussians.spatial_lr_scale))
    worst = 0.0
    for f, lr in lrs.items():
        ms = [getattr(k.opt.m, f).abs() for k in kept]
        signal = torch.stack([m > 1e-1 * m.max() for m in ms]).all(0)
        still = torch.stack([m == 0 for m in ms]).all(0)
        want = getattr(kept[-1].gaussians.params, f)
        g = torch.as_tensor(got[f], device=want.device)
        if bool(signal.any()):
            d = float((g[signal] - want[signal]).abs().max()) / lr
            worst = max(worst, d)
            check(d <= DP_LEAF_TOL, f"{what}: param {f} departs {d:.3e} lr on the elements with a gradient")
        first = getattr(start.gaussians.params, f)
        check(torch.equal(g[still], first[still]), f"{what}: param {f} moved where no step had a gradient")
    return worst


def hold_compiled_dp(estep, cstep, ts, batch, n, what):
    """`n` steps of the eager view-parallel step `estep` and the compiled
    `cstep` side by side from `ts` on `batch`. Gates: after every step the
    two states and the metrics bitwise equal; the compiled step's first
    call captures (its warm-up launches V of each render kernel and one
    masked Adam through the launchers), every later one is a replay under
    set_sync_debug_mode("error") that adds as many to the replay count and
    none to the launchers'. Returns the compiled path's launches
    and the last compiled state and metrics."""
    from hidegs_tpu_torch.parallel import sharded

    V = sharded.num_views(batch)
    dev = ts.gaussians.alive.device
    eager = comp = ts
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for k in range(n):
        eager, em = estep(eager, batch)
        sync(dev)
        direct, replayed, n_captures = direct_counts(), replay_counts(), len(cstep.captures)
        if k > 0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            comp, cm = cstep(comp, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sync(dev)
        d = tuple(b - a for a, b in zip(direct, direct_counts()))
        r = tuple(b - a for a, b in zip(replayed, replay_counts()))
        captured = len(cstep.captures) > n_captures
        check(captured == (k == 0), f"{what} step {k}: captured {captured}")
        check(r == per_kernel(V, V, 1) and d == per_kernel(*(V, V, 1) if captured else (0, 0)),
              f"{what} step {k}: replayed launches {r}, the launchers' {d}, expected {V} of each render "
              f"kernel and one masked Adam a replay")
        for j, key in enumerate(launches):
            launches[key] += d[j] + r[j]
        diff = first_difference(comp, eager)
        bad = [m for m in em if not torch.equal(em[m], cm[m])]
        check(diff is None and not bad, f"{what} step {k}: the compiled and eager steps part: metrics {bad}, "
                                        f"state tensor {diff}")
    return dict(launches=launches, ts=comp, metrics=cm)


def phase_view_parallel(scene, cams, cfg):
    """15. The view-parallel trainer (parallel/sharded.py) on the train cell,
    and its compiled step (parallel/compiled.py) beside the eager one."""
    import dataclasses

    import torch.distributed as dist

    from hidegs_tpu_torch.model.adam import masked_adam_plain, masked_adam_update
    from hidegs_tpu_torch.model.schedules import lr_tree
    from hidegs_tpu_torch.parallel import distributed as pdist
    from hidegs_tpu_torch.parallel import compiled as pc
    from hidegs_tpu_torch.parallel import dryrun, sharded
    from hidegs_tpu_torch.parallel.mesh import make_mesh
    from hidegs_tpu_torch.train import loop as tl
    from hidegs_tpu_torch.utils import profiling

    dev = scene.means3d.device
    t0 = time.perf_counter()
    cell = train_cell(scene, cams, cfg)
    ts0, tcfg, views, targets, pcfg = cell["ts"], cell["tcfg"], cell["batches"], cell["targets"], cell["pcfg"]
    del cell
    V = len(views)
    batch = sharded.stack_view_batches(views)
    work = ROOT / "build" / "dp_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    psnr0, _ = mean_psnr(ts0, cams, targets, pcfg)
    print(f"[dp] train cell: capacity {ts0.gaussians.capacity}, V = {V} views of {cams[0].width}x{cams[0].height} "
          f"a step, mean PSNR before {psnr0:.4f} dB (set-up {time.perf_counter() - t0:.1f} s)")

    # (a) one rank: no process group, then a one-rank NCCL group
    runs = {}
    for wire in (None, torch.bfloat16):
        step, _ = sharded.make_dp_train_step(tcfg, None, grad_reduce_dtype=wire)
        reset_counts()
        ts, kept, losses = ts0, [], []
        for k in range(DP_STEPS):
            ts, m = step(ts, batch)
            losses.append(m["loss"])
            if k < DP_RANK_STEPS:
                kept.append(ts)
        launches = read_counts()
        losses = [float(x) for x in losses]
        name = "f32" if wire is None else "bf16"
        print(f"[dp] no group, {name} wire: {DP_STEPS} steps, losses {', '.join(f'{x:.5f}' for x in losses)}; "
              f"launches {launches}")
        check(launches == kernel_dict(per_kernel(V * DP_STEPS, V * DP_STEPS, DP_STEPS)),
              f"view-parallel {name}: launches {launches}, expected {V} of each render kernel and one masked "
              f"Adam per step")
        check(all(np.isfinite(losses)), f"view-parallel {name}: non-finite losses {losses}")
        runs[name] = dict(ts=ts, kept=kept, losses=losses, launches=launches)
    # the compiled step beside the eager one, from the same state
    comp = {}
    comp_launches = dict.fromkeys(KERNEL_NAMES, 0)
    for wire in (None, torch.bfloat16):
        name = "f32" if wire is None else "bf16"
        estep, _ = sharded.make_dp_train_step(tcfg, None, grad_reduce_dtype=wire)
        cstep, _ = pc.compile_dp_train_step(tcfg, None, grad_reduce_dtype=wire)
        held = hold_compiled_dp(estep, cstep, ts0, batch, DP_STEPS, f"compiled view-parallel {name}")
        check(float(held["metrics"]["loss"]) == runs[name]["losses"][-1]
              and all(torch.equal(x, y) for x, y in zip(train_leaves(held["ts"]), train_leaves(runs[name]["ts"]))),
              f"compiled view-parallel {name}: its last step is not the eager run's")
        for key in comp_launches:
            comp_launches[key] += held["launches"][key]
        info = cstep.captures[0]
        print(f"[dp-compiled] no group, {name} wire: {DP_STEPS} compiled steps bitwise the eager ones after every "
              f"step; replays made no host sync; {V} of each render kernel's launches and one masked Adam per "
              f"replay, as many per warm-up; "
              f"warm-up {info['warmup_s']:.3f} s, capture {info['capture_s']:.3f} s, graph pool +"
              f"{info['pool_reserved_bytes'] / 2**30:.3f} GiB reserved")
        comp[name] = dict(step=cstep, ts=held["ts"], info=info)
        del estep, held
    del comp["bf16"]
    torch.cuda.empty_cache()
    psnr1, views1 = mean_psnr(runs["f32"]["ts"], cams, targets, pcfg)
    print(f"[dp] mean PSNR {psnr0:.4f} -> {psnr1:.4f} dB after {DP_STEPS} steps "
          f"(views {', '.join(f'{v:.3f}' for v in views1)})")
    check(psnr1 > psnr0, f"view-parallel: mean PSNR did not rise ({psnr0:.4f} -> {psnr1:.4f})")
    a1, b1 = runs["f32"]["kept"][0], runs["bf16"]["kept"][0]
    np.testing.assert_allclose(runs["bf16"]["losses"][0], runs["f32"]["losses"][0], rtol=1e-4)
    da, db = a1.gaussians.params.xyz - ts0.gaussians.params.xyz, b1.gaussians.params.xyz - ts0.gaussians.params.xyz
    moved = (da.abs().amax(1) > 0) | (db.abs().amax(1) > 0)
    cos = float((da[moved] * db[moved]).sum() / (da[moved].norm() * db[moved].norm() + 1e-12))
    m_dep = float((a1.opt.m.xyz - b1.opt.m.xyz).abs().max() / a1.opt.m.xyz.abs().max())
    print(f"[dp] bf16 wire vs float32, first step: loss {runs['bf16']['losses'][0]:.7f} vs "
          f"{runs['f32']['losses'][0]:.7f} (rtol 1e-4 holds), xyz update cosine {cos:.6f} over {int(moved.sum())} "
          f"rows (> 0.99), Adam m of xyz departs {m_dep:.3e} of its max (in (0, {DP_WIRE_M_TOL}))")
    check(cos > 0.99, f"bf16 wire: first update cosine {cos}")
    check(0 < m_dep < DP_WIRE_M_TOL, f"bf16 wire: the first step's Adam m of xyz departs {m_dep:.3e} of its max "
          f"from the float32 wire's (want above 0, the wire rounded, and below {DP_WIRE_M_TOL})")

    step32, _ = sharded.make_dp_train_step(tcfg, None)
    a, ma = step32(ts0, batch)
    b, mb = step32(ts0, batch)
    for i, (x, y) in enumerate(zip(train_leaves(a), train_leaves(b))):
        check(torch.equal(x, y), f"two view-parallel steps from one state differ in leaf {i}")
    check(torch.equal(ma["loss"], mb["loss"]), "two view-parallel steps from one state differ in the loss")
    one = sharded.stack_view_batches(views[:1])
    a, ma = step32(ts0, one)
    b, mb = tl.train_step(ts0, views[0], tcfg)
    check(float(mb["step_ok"]) == 1.0, "the single-view step is not finite")
    for i, (x, y) in enumerate(zip(train_leaves(a), train_leaves(b))):
        check(torch.equal(x, y), f"a V = 1 view-parallel step differs from train_step in leaf {i}")
    print("[dp] two steps from one state bitwise equal; a V = 1 step on view 0 bitwise train_step's")
    del a, b, ma, mb

    pdist.initialize_distributed(backend="nccl", device=dev, init_method=dryrun.file_init_method(str(work)),
                                 world_size=1, rank=0)
    try:
        mesh = make_mesh(1, device_type="cuda")
        for wire in (None, torch.bfloat16):
            name = "f32" if wire is None else "bf16"
            step, place = sharded.make_dp_train_step(tcfg, mesh, grad_reduce_dtype=wire)
            ts, b = place(ts0, batch)
            losses = []
            for _ in range(DP_STEPS):
                ts, m = step(ts, b)
                losses.append(float(m["loss"]))
            check(losses == runs[name]["losses"], f"one-rank NCCL {name}: losses differ from the no-group run")
            for i, (x, y) in enumerate(zip(train_leaves(ts), train_leaves(runs[name]["ts"]))):
                check(torch.equal(x, y), f"one-rank NCCL {name}: leaf {i} differs from the no-group run")
            print(f"[dp] one-rank NCCL group, {name} wire: {DP_STEPS} steps bitwise the no-group run")
            # the compiled step records the group's collectives into its graph
            cstep, _ = pc.compile_dp_train_step(tcfg, mesh, grad_reduce_dtype=wire)
            ts, _ = place(ts0, batch)
            held = hold_compiled_dp(step, cstep, ts, b, DP_STEPS, f"compiled one-rank NCCL {name}")
            for i, (x, y) in enumerate(zip(train_leaves(held["ts"]), train_leaves(runs[name]["ts"]))):
                check(torch.equal(x, y), f"compiled one-rank NCCL {name}: leaf {i} differs from the no-group run")
            for key in comp_launches:
                comp_launches[key] += held["launches"][key]
            info = cstep.captures[0]
            print(f"[dp-compiled] one-rank NCCL group, {name} wire: {DP_STEPS} compiled steps (the all-reduces in "
                  f"the graph) bitwise the eager ones after every step and the no-group run at the end; replays "
                  f"made no host sync; warm-up {info['warmup_s']:.3f} s, capture {info['capture_s']:.3f} s, "
                  f"graph pool +{info['pool_reserved_bytes'] / 2**30:.3f} GiB reserved")
            if wire is None:
                cts = held["ts"]
                nccl_compiled_ms = time_ms(lambda: cstep(cts, b))
            del cstep, held, ts
            sync(dev)
        step, place = sharded.make_dp_train_step(tcfg, mesh)
        ts, b = place(runs["f32"]["ts"], batch)
        sync(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            ts, m = step(ts, b)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(bool(torch.isfinite(m["loss"])), "the NCCL step under sync debug: non-finite loss")
        print("[dp] a one-rank NCCL step ran under set_sync_debug_mode('error'): no host sync")
        grp = mesh.get_group(0)
        flat_len = sum(p.numel() for p in ts.gaussians.params) + len(m)
        times = {}
        for wdt in (torch.float32, torch.bfloat16):
            buf = torch.zeros(flat_len, dtype=wdt, device=dev)
            times[wdt] = (time_ms(lambda: dist.all_reduce(buf, group=grp)), buf.numel() * buf.element_size())
        nccl_ms = time_ms(lambda: step(ts, b))
    finally:
        sync(dev)  # no graph of the group's is still running when it goes
        pdist.shutdown_distributed()
    ar32, ar16 = times[torch.float32], times[torch.bfloat16]

    # the last step's four blend nodes, held against the plain versions
    got = []

    def hooking(compute_losses):
        def hooked(*args, **kwargs):
            total, aux = compute_losses(*args, **kwargs)
            for node in find_nodes(total.grad_fn, "BlendPackedBackward"):
                got.append({})
                keep_backward_inputs(node, got[-1])
            return total, aux

        return hooked

    with patched(sharded, "compute_losses", hooking):
        step32(runs["f32"]["ts"], batch)
    check(len(got) == V, f"view-parallel hold: {len(got)} blend nodes in a V = {V} step")
    fwd_err, holds = 0.0, []
    for j, g in enumerate(got):
        check(bool(g), f"view-parallel hold: view {j}'s blend backward did not run")
        ty, tx, tile, max_blocks, _bf16 = g["args"]
        fwd_err = max(fwd_err, hold_node_forward(g, f"view-parallel step, view {j}", tag="dp-hold"))
        h = hold_backward(g["attrs"], g["tb"], g["count"], g["tile_out"], g["g_tiles"], ty, tx, tile, max_blocks,
                          f"view-parallel step, view {j}")
        check(torch.equal(g["d_attrs"], h["got"]), "view-parallel hold: a node's d_attrs are not the launchers'")
        holds.append(h)
        print(f"[dp-hold] view {j}: backward + fold kernels vs blend_tiles_bwd + plain fold: {hold_report(h)}")
    hold = dict(fwd_err=fwd_err, err=max(h["err"] for h in holds), fold_err=max(h["fold_err"] for h in holds))
    del got, holds

    # times
    ts = runs["f32"]["ts"]
    step_ms = time_ms(lambda: step32(ts, batch))

    def local_fwd_bwd():
        out = None
        for view in views:
            loss, _aux, inputs = tl.step_forward(ts, view, tcfg)
            out = tl.step_backward(loss / V, inputs)
        return out

    fb_ms = time_ms(local_fwd_bwd)
    grads = type(ts.gaussians.params)(*local_fwd_bwd()[:len(ts.gaussians.params)])
    visible = ts.gaussians.alive
    lrs = lr_tree(ts.step, tcfg.lr, ts.gaussians.spatial_lr_scale)
    upd_ms = time_ms(lambda: masked_adam_update(ts.gaussians.params, grads, ts.opt, lrs, visible))  # alive rows
    # the kernel on the step's own gradients (the SH bands split out of one
    # gradient) against the plain body
    got = adam_leaves(*masked_adam_update(ts.gaussians.params, grads, ts.opt, lrs, visible))
    want = adam_leaves(*masked_adam_plain(ts.gaussians.params, grads, ts.opt, lrs, visible))
    adam_err = max(max_abs_err(x, y) for x, y in zip(got, want))
    check(all(torch.equal(x, y) for x, y in zip(got, want)),
          f"view-parallel: the masked Adam kernel on the step's gradients departs {adam_err:.3e} from "
          f"masked_adam_plain")
    print(f"[dp-times] the masked Adam kernel on the step's gradients ({int(visible.sum())} alive rows) bitwise "
          f"masked_adam_plain")
    del grads, got, want
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    step32(ts, batch)
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    eager_peak = peak - base
    print(f"[dp-times] view-parallel step, V = {V} at {cams[0].width}x{cams[0].height}, CUDA events, median of "
          f"{ITERS} after {WARMUP} warm-ups: no group {step_ms:.3f} ms, one-rank NCCL group {nccl_ms:.3f} ms; "
          f"local forward + backward of the {V} views {fb_ms:.3f} ms; the gradient all-reduce alone (one-rank "
          f"NCCL) {ar32[0]:.3f} ms for {ar32[1]:,} bytes (float32), {ar16[0]:.3f} ms for {ar16[1]:,} bytes "
          f"(bf16); the masked Adam update {upd_ms:.3f} ms; peak memory {peak / 2**30:.2f} GiB")
    eager_prof = profile_device(lambda: step32(ts, batch), "dp-breakdown")

    # the compiled step's times, from the state its last replay returned
    cstep, cts = comp["f32"]["step"], comp["f32"]["ts"]
    compiled_ms = time_ms(lambda: cstep(cts, batch))
    host = []
    for _ in range(ITERS):
        sync(dev)
        t0 = time.perf_counter()
        cstep(cts, batch)
        host.append(1e3 * (time.perf_counter() - t0))
    sync(dev)
    comp_prof = profile_device(lambda: cstep(cts, batch), "dp-compiled-breakdown")
    info = comp["f32"]["info"]
    pool = info["pool_reserved_bytes"] / 2**30
    busy = {mode: "not measured" if prof is None else f"{prof['busy_ms'] / prof['wall_ms']:.1%}"
            for mode, prof in (("eager", eager_prof), ("compiled", comp_prof))}
    print(f"[dp-compiled] V = {V} step, CUDA events, median of {ITERS} after {WARMUP}: eager {step_ms:.3f} ms, "
          f"compiled {compiled_ms:.3f} ms ({step_ms / compiled_ms:.2f}x); one-rank NCCL group eager {nccl_ms:.3f}, "
          f"compiled {nccl_compiled_ms:.3f} ms; host ms per replay (copy-in and launch, median of {ITERS}) "
          f"{statistics.median(host):.3f}; device busy under the profiler eager {busy['eager']}, compiled "
          f"{busy['compiled']}; capture {info['capture_s']:.3f} s after a {info['warmup_s']:.3f} s warm-up; graph "
          f"pool {pool:.3f} GiB reserved, an eager step's peak {eager_peak / 2**30:.3f} GiB above what was "
          f"allocated before it")
    del cstep, cts, comp

    # (d) the trace
    tdir = work / "trace"
    with profiling.trace(str(tdir), device=dev):
        with profiling.span("dp_step"):
            step32(ts, batch)
    tfile = tdir / profiling.TRACE_FILE
    names = {e.get("name", "") for e in json.loads(tfile.read_text())["traceEvents"]}
    for want in ("blend_fwd_kernel", "blend_bwd_kernel", "fold_rows_kernel", "dp_step"):
        check(any(want in n for n in names), f"the trace of a view-parallel step names no {want}")
    print(f"[dp-trace] utils.profiling.trace of one V = {V} step: {tfile.stat().st_size:,} bytes, names the three "
          f"kernels and the 'dp_step' range")
    shutil.rmtree(tdir, ignore_errors=True)

    # (b) two ranks on the card
    t0 = time.perf_counter()
    try:
        dryrun.launch(nccl_pair_probe, 2, (dryrun.file_init_method(str(work / "nccl_pair")),), 120,
                      str(work / "nccl_pair_logs"))
        why = "NCCL took two ranks on one card, but the runs below use gloo as planned"
    except RuntimeError as e:
        lines = [ln.strip() for ln in str(e).splitlines() if "Duplicate GPU" in ln]
        why = ("NCCL refuses two ranks on one card: " + lines[0][:200] if lines else
               "NCCL did not form a two-rank group on one card: " + str(e).strip().splitlines()[0][:200])
    print(f"[dp-ranks] backend gloo (CUDA tensors): {why} ({time.perf_counter() - t0:.1f} s to find out)")
    rank_runs = [dict(name="replicated", data=2, model=1, steps=DP_RANK_STEPS, save_steps=[DP_RANK_STEPS],
                      save="params"),
                 dict(name="sharded", data=1, model=2, shard=True, steps=DP_RANK_STEPS, save_steps=[DP_RANK_STEPS],
                      save="params")]
    job = work / "job.pt"
    t0 = time.perf_counter()
    dryrun.save_dp_job(str(job), ts0, views, tcfg, rank_runs)
    logs = dryrun.launch(dryrun.dp_worker, 2, (dryrun.file_init_method(str(work / "ranks")), "gloo", "cuda",
                                               str(job), str(work)), 900, str(work / "rank_logs"))
    wall = time.perf_counter() - t0
    res = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    rank_ms = {}
    for run in rank_runs:
        n = run["name"]
        r0, r1 = res[0][n], res[1][n]
        check(np.array_equal(r0["digest"], r1["digest"]) and r0["losses"] == r1["losses"],
              f"two ranks, {n}: the ranks' states differ")
        np.testing.assert_allclose(r0["losses"], runs["f32"]["losses"][:DP_RANK_STEPS], rtol=1e-3)
        dep = hold_params(r0["states"][DP_RANK_STEPS], runs["f32"]["kept"], ts0, tcfg, f"two ranks, {n}")
        rank_ms[n] = 1e3 * float(np.median(r0["seconds"]))
        print(f"[dp-ranks] {n} ({run['data']}x{run['model']} mesh, {V // run['data']} views a rank): losses "
              f"{', '.join(f'{x:.5f}' for x in r0['losses'])} (the V = {V} run's within rtol 1e-3), params within "
              f"{dep:.3e} lr of it (tol {DP_LEAF_TOL}), the two ranks' states bitwise equal; "
              f"{rank_ms[n]:.1f} ms per step (median of {len(r0['seconds'])}, host clock)")
    print(f"[dp-ranks] two-rank runs: {wall:.1f} s with the job file and the spawn")
    del res

    # (c) the schedule leg
    for args in (["--nproc", "1", "--backend", "nccl"], ["--nproc", "4", "--backend", "gloo", "--device", "cuda"]):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "hidegs_tpu_torch.parallel", *args], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        ok_lines = [ln for ln in r.stdout.splitlines() if ln.startswith("dryrun_") and ln.endswith(" ok")]
        check(r.returncode == 0 and len(ok_lines) == 3,
              f"python -m hidegs_tpu_torch.parallel {' '.join(args)}: rc {r.returncode}\n{r.stdout[-3000:]}"
              f"\n{r.stderr[-3000:]}")
        print(f"[dp-dryrun] {' '.join(args)}: {time.perf_counter() - t0:.1f} s")
        for ln in ok_lines:
            print(f"[dp-dryrun]   {ln}")
    shutil.rmtree(work, ignore_errors=True)
    return dict(launches=runs["f32"]["launches"], compiled_launches=comp_launches, step_ms=step_ms, nccl_ms=nccl_ms,
                compiled_ms=compiled_ms, rank_ms=rank_ms, adam_err=adam_err, **hold)


LOD_TAUS = (0.0, 3.0, 6.0, 15.0)  # pixel granularities of the hierarchy phase
LOD_HOLD_TAU = 6.0  # the τ whose frame the forward kernel is held on
LOD_MIN_PSNR = 40.0  # τ=0 frame against the leaf render (tests/test_hier.py's bar)
SERVE_TAU = 6.0  # render_cli --hierarchy --tau on the serve phase's scene


def build_scene_hierarchy(scene):
    """The render cell's scene through the port's native builder (compiled
    from hidegs_tpu_torch/hier/native/hier_builder.cpp into build/hier/),
    written as a .hier file and read back."""
    from hidegs_tpu_torch.hier import build as hbuild
    from hidegs_tpu_torch.hier import io as hio

    host = [x.detach().cpu().numpy() for x in (scene.means3d, scene.quats, scene.scales, scene.opacities, scene.shs)]
    t0 = time.perf_counter()
    lib = hbuild.compile_native()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    h = hbuild.build_hierarchy(*host, use_native=True)
    t_hier = time.perf_counter() - t0
    work = ROOT / "build" / "hier_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    path = work / "scene.hier"
    t0 = time.perf_counter()
    hio.write_hier(str(path), h)
    back = hio.read_hier(str(path))
    t_io = time.perf_counter() - t0
    for name in hio.Hierarchy._fields:
        check(np.array_equal(getattr(back, name), getattr(h, name)), f"hierarchy: .hier read back differs in {name}")
    n_leaves = int((h.nodes[:, hio.DEPTH] == 0).sum())
    check(n_leaves == scene.means3d.shape[0], f"hierarchy: {n_leaves} leaf nodes for {scene.means3d.shape[0]} gaussians")
    print(f"[hier] built {lib.name} in {t_build:.2f} s; hierarchy of {scene.means3d.shape[0]} gaussians in "
          f"{t_hier:.2f} s on the host: {h.num_points} points, {h.num_nodes} nodes, {n_leaves} leaves, root depth "
          f"{int(h.nodes[0, hio.DEPTH])}; wrote and read back {path.name} ({path.stat().st_size / 2 ** 20:.1f} MiB) "
          f"in {t_io:.2f} s, equal")
    return back, path


@contextlib.contextmanager
def kept_blend(kept):
    """Keep the last call of the "blend" backend's blend_tiles: its
    arguments (pre, binning, tiles_y, tiles_x, tile, max_blocks, bf16) and
    its planes."""
    from hidegs_tpu_torch.raster import blend_autograd

    def keep(blend_tiles):
        def call(*args, **kwargs):
            res = blend_tiles(*args, **kwargs)
            kept.update(args=args, planes=res)
            return res
        return call

    with patched(blend_autograd, "blend_tiles", keep):
        yield


@contextlib.contextmanager
def frame_calls(calls):
    """Record the LOD frame calls: ("eager", 0) for each fused_lod_frame
    call (one forward blend), ("compiled", n) for each CompiledLodFrame
    call (one replay, one forward blend), n the captures it made (each
    warms up with one forward blend through the launcher). The
    fused_lod_frame calls of a compiled call's warm-up and capture are
    its own, not recorded."""
    from hidegs_tpu_torch.hier import interp

    inside = [0]

    def wrap_eager(fn):
        def call(*args, **kwargs):
            if not inside[0]:
                calls.append(("eager", 0))
            return fn(*args, **kwargs)
        return call

    def wrap_compiled(fn):
        def call(self, *args, **kwargs):
            n = len(self.captures)
            inside[0] += 1
            try:
                out = fn(self, *args, **kwargs)
            finally:
                inside[0] -= 1
            calls.append(("compiled", len(self.captures) - n))
            return out
        return call

    with patched(interp, "fused_lod_frame", wrap_eager), patched(interp.CompiledLodFrame, "__call__", wrap_compiled):
        yield


def check_frame_launches(calls, launches, replays, n_frames, mode, what):
    """The gate on a LOD path's launches: exactly one call per frame in
    `mode`, one forward blend and one interpolation forward per frame (a
    launch through the launcher per eager frame; a replayed launch per
    compiled frame, and the warm-up's launch per capture), nothing else."""
    captures = sum(n for _, n in calls)
    direct = {k: launches[k] - replays[k] for k in launches}
    n_direct = n_frames if mode == "eager" else captures
    n_replayed = 0 if mode == "eager" else n_frames
    want_direct = kernel_dict(per_kernel(n_direct, 0, 0, n_direct))
    want_replays = kernel_dict(per_kernel(n_replayed, 0, 0, n_replayed))
    check(len(calls) == n_frames and all(m == mode for m, _ in calls) and direct == want_direct
          and replays == want_replays,
          f"{what}: {len(calls)} {sorted(set(m for m, _ in calls))} cut-and-render calls, launches {direct} through "
          f"the launchers and {replays} replayed for {n_frames} frames, expected {n_frames} {mode} calls, "
          f"{want_direct} and {want_replays} ({captures} captures)")
    return captures


def lod_stages(r, cam, tau):
    """The LOD frame's four stages as separate calls, on the renderer's
    current budgets: count, select, interpolate, render."""
    from hidegs_tpu_torch.hier import lod
    from hidegs_tpu_torch.hier.interp import interpolate_cut
    from hidegs_tpu_torch.raster.api import RasterConfig, render

    target = r.target_size(cam, tau)
    vp = cam.camera_center
    cfg = RasterConfig(backend=r.backend, tile=r.tile, depth_sort_bits=-1, max_instances=r._max_inst)
    cut = lod.expand_packed(r._packed, target, vp, budget=r._budget, num_points=r.num_points)
    ig = interpolate_cut(cut, *r.arrays, attrs=r._attrs)
    return {
        "count": lambda: lod.cut_size_packed(r._packed, target, vp),
        "select": lambda: lod.expand_packed(r._packed, target, vp, budget=r._budget, num_points=r.num_points),
        "interpolate": lambda: interpolate_cut(cut, *r.arrays, attrs=r._attrs),
        "render": lambda: render(*ig, cam, config=cfg),
    }


def int_bits(x):
    """The float32 tensor `x` as its int32 bit patterns (tells -0 from +0)."""
    return x.contiguous().view(torch.int32)


def interp_bytes(ri, pi, W):
    """(forward, backward) bytes the interpolation kernels need on the
    slots (ri, pi) of a (P, W) attribute matrix: every distinct row of ri
    and pi read once (the forward all W floats, the backward the
    quaternion and opacity columns, 5 floats); per slot ri, pi, t, kids and
    valid read; per slot the forward's W output floats written, the
    backward's W output-gradient floats read and its two W-float gradient
    rows written."""
    B = ri.shape[0]
    rows = int(torch.unique(torch.cat([ri, pi])).numel())
    slot = 8 + 8 + 4 + 4 + 1
    return rows * 4 * W + B * (slot + 4 * W), rows * 4 * 5 + B * (slot + 3 * 4 * W)


def hold_interp(slots, grads, what, rows_grad=None):
    """The interpolation kernels (hier/csrc/interp.cu) on one cut's slots
    (attrs, ri, pi, ts, kids, valid, sh_shape) and its outputs' gradients
    `grads`: launch_interp_fwd bitwise interpolate_plain and
    launch_interp_bwd bitwise interp_plain_bwd, one launch a call;
    `rows_grad` (the InterpolateRows node's gradient of attrs), where
    given, bitwise the two accumulate_rows of interp_plain_bwd's rows,
    summed. Then both kernels in turns with their plain versions (CUDA
    events, two turns, the order reversed on the second), beside their
    bytes bounds (`interp_bytes`)."""
    from hidegs_tpu_torch.hier import interp_autograd as ia

    attrs, ri, pi = slots[:3]
    B, W = ri.shape[0], attrs.shape[1]
    want = ia.interpolate_plain(*slots)
    out = [torch.empty_like(x) for x in want]
    grad_c, grad_p = (torch.empty(B, W, device=attrs.device) for _ in range(2))
    n0 = (ia.FWD_LAUNCHES, ia.BWD_LAUNCHES)
    ia.launch_interp_fwd(*slots[:6], out)
    ia.launch_interp_bwd(*slots[:6], grads, grad_c, grad_p)
    check((ia.FWD_LAUNCHES - n0[0], ia.BWD_LAUNCHES - n0[1]) == (1, 1),
          f"{what}: {ia.FWD_LAUNCHES - n0[0]} forward and {ia.BWD_LAUNCHES - n0[1]} backward interpolation launches "
          f"for one call of each")
    want_c, want_p = ia.interp_plain_bwd(*slots[:6], *grads)
    names = ("means", "scales", "quats", "opacity", "sh", "grad_c", "grad_p")
    pairs = list(zip(names, (*out, grad_c, grad_p), (*want, want_c, want_p), strict=True))
    err = max(max_abs_err(x, y) for _, x, y in pairs)
    bad = [n for n, x, y in pairs if not torch.equal(int_bits(x), int_bits(y))]
    check(not bad, f"{what}: the interpolation kernels differ from the plain versions in {bad} (max abs err {err:.3e})")
    if rows_grad is not None:
        rows = ia.accumulate_rows(attrs, ri, want_c).add_(ia.accumulate_rows(attrs, pi, want_p))
        check(torch.equal(int_bits(rows_grad), int_bits(rows)),
              f"{what}: the InterpolateRows node's gradient of attrs is not bitwise the plain rows' sums")
        del rows
    del want, want_c, want_p
    fwd_bytes, bwd_bytes = interp_bytes(ri, pi, W)
    fns = {"fwd": lambda: ia.launch_interp_fwd(*slots[:6], out), "fwd_plain": lambda: ia.interpolate_plain(*slots),
           "bwd": lambda: ia.launch_interp_bwd(*slots[:6], grads, grad_c, grad_p),
           "bwd_plain": lambda: ia.interp_plain_bwd(*slots[:6], *grads)}
    turns = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            turns[k].append(time_ms(fns[k]))
            torch.cuda.empty_cache()
    t = {f"{k}_ms": statistics.median(v) for k, v in turns.items()}
    t.update(fwd_bound_ms=fwd_bytes / HBM_BYTES_S * 1e3, bwd_bound_ms=bwd_bytes / HBM_BYTES_S * 1e3, err=err,
             B=B, P=attrs.shape[0], valid=int(slots[5].sum()))
    print(f"[interp] {what}: B = {B:,} slots ({t['valid']:,} valid), P = {t['P']:,} rows: both kernels bitwise the "
          f"plain versions (outputs, both gradient rows" + (", the rows' sums" if rows_grad is not None else "")
          + f"), one launch each; CUDA events, median of {ITERS} after {WARMUP}, two turns: forward "
          f"{t['fwd_ms']:.4f} ms ({t['fwd_bound_ms'] / t['fwd_ms']:.1%} of its {t['fwd_bound_ms']:.4f} ms bytes "
          f"bound), plain {t['fwd_plain_ms']:.3f} ms; backward {t['bwd_ms']:.4f} ms "
          f"({t['bwd_bound_ms'] / t['bwd_ms']:.1%} of {t['bwd_bound_ms']:.4f} ms), plain {t['bwd_plain_ms']:.3f} ms")
    return t


def phase_hierarchy(scene, cams, h):
    """The LOD hierarchy path at full width: AdaptiveHierRenderer on the
    card (the scene's hierarchy, tile 32, depth_sort_bits -1), every view at
    every τ of LOD_TAUS through `render`, eager (`compiled` None) and then
    compiled (the default on a card: each frame a CompiledLodFrame
    replay), with counts read around each run; the compiled frames cloned
    and held bitwise against the eager ones; then the checks and the times
    of both."""
    from hidegs_tpu_torch.hier import lod
    from hidegs_tpu_torch.hier.interp import AdaptiveHierRenderer
    from hidegs_tpu_torch.raster import blend_plain
    from hidegs_tpu_torch.raster.api import RasterConfig, render
    from hidegs_tpu_torch.train.losses import psnr

    dev = scene.means3d.device
    e = AdaptiveHierRenderer.from_hierarchy(h, dev)
    e.compiled = None  # the eager frame loop
    r = AdaptiveHierRenderer.from_hierarchy(h, dev)
    check(r.compiled is not None and e.compiled is None, "hierarchy: the renderer on the card is not compiled")
    n_frames = len(LOD_TAUS) * len(cams)
    frames, cuts, launches, captures = {}, {}, {}, {}
    for mode, renderer in (("eager", e), ("compiled", r)):
        calls, kept = [], {}
        reset_counts()
        with torch.no_grad(), frame_calls(calls):
            for tau in LOD_TAUS:
                for i, cam in enumerate(cams):
                    out = renderer.render(cam, tau)
                    kept[tau, i] = {k: v.clone() for k, v in out.items()}  # the next frame overwrites a replay's
                    cuts[mode, tau, i] = (int(out["num_selected"]), renderer._budget, int(out["num_instances"]))
        launches[mode] = read_counts()
        replays = dict(zip(launches[mode], replay_counts()))
        captures[mode] = check_frame_launches(calls, launches[mode], replays, n_frames, mode,
                                              f"hierarchy path ({mode})")
        frames[mode] = kept
        print(f"[hier] launches on the {mode} hierarchy path: {launches[mode]} for {n_frames} frames ({len(calls)} "
              f"cut-and-render calls, {replays['blend_fwd']} replayed launches, {captures[mode]} captures; a call "
              f"past one per frame would be a re-expansion or an instance regrow)")
    for tau in LOD_TAUS:
        for i in range(len(cams)):
            check(cuts["compiled", tau, i] == cuts["eager", tau, i],
                  f"hierarchy view {i} tau {tau}: compiled cut / budget / instances {cuts['compiled', tau, i]}, eager "
                  f"{cuts['eager', tau, i]}")
            got, want = frames["compiled"][tau, i], frames["eager"][tau, i]
            bad = [k for k in want if not torch.equal(got[k], want[k])]
            check(got.keys() == want.keys() and not bad, f"hierarchy view {i} tau {tau}: the compiled frame differs "
                                                         f"from the eager one in {bad}")
    print(f"[hier] compiled frames bitwise the eager frames: {n_frames} frames, every key of the render dict")
    frames = frames["compiled"]
    cuts = {key[1:]: val for key, val in cuts.items() if key[0] == "compiled"}
    for (tau, i), f in frames.items():
        check(int(f["overflow"]) == 0, f"hierarchy view {i} tau {tau}: overflow {int(f['overflow'])}")
        check(bool(torch.isfinite(f["render"]).all()), f"hierarchy view {i} tau {tau}: render not finite")
        n = int(lod.cut_size(r.nodes, r.boxes, r.target_size(cams[i], tau), cams[i].camera_center))
        check(n == cuts[tau, i][0], f"hierarchy view {i} tau {tau}: num_selected {cuts[tau, i][0]} != count {n}")
    N = scene.means3d.shape[0]
    for i in range(len(cams)):
        sizes = [cuts[tau, i][0] for tau in LOD_TAUS]
        check(sizes[0] == N, f"hierarchy view {i}: the tau=0 cut has {sizes[0]} gaussians, not the {N} leaves")
        check(all(a >= b for a, b in zip(sizes, sizes[1:])), f"hierarchy view {i}: cut sizes rise with tau: {sizes}")
        print(f"[hier] view {i}: cut / budget / instances at tau " + ", ".join(
            f"{tau:g}: {cuts[tau, i][0]} / {cuts[tau, i][1]} / {cuts[tau, i][2]}" for tau in LOD_TAUS))

    # tau=0 is the leaf cut: against the leaf render of the scene
    worst = float("inf")
    with torch.no_grad():
        r.render(cams[0], 0.0)  # the budgets of tau 0
        leaf_cfg = RasterConfig(tile=32, depth_sort_bits=-1, max_instances=r._max_inst)
        for i, cam in enumerate(cams):
            leaf = render(*scene, cam, config=leaf_cfg)
            check(int(leaf["overflow"]) == 0, f"leaf render view {i} overflows")
            p = float(psnr(torch.clamp(frames[0.0, i]["render"], 0, 1), torch.clamp(leaf["render"], 0, 1)))
            worst = min(worst, p)
    check(worst >= LOD_MIN_PSNR, f"hierarchy: the tau=0 frame is {worst:.2f} dB from the leaf render (< {LOD_MIN_PSNR})")
    print(f"[hier] tau=0 frames against the leaf render of the same scene: PSNR >= {worst:.4f} dB (bar {LOD_MIN_PSNR})")
    del frames

    # the forward kernel on the eager tau=6 frame's own rows and binning
    # (the compiled frames are bitwise the eager ones), and a repeat of each
    kept = {}
    with torch.no_grad(), kept_blend(kept):
        a = e.render(cams[0], LOD_HOLD_TAU)
        b = e.render(cams[0], LOD_HOLD_TAU)
    for key, val in a.items():
        check(torch.equal(val, b[key]), f"two eager tau={LOD_HOLD_TAU:g} frames differ in {key}")
    with torch.no_grad():
        ca = {k: v.clone() for k, v in r.render(cams[0], LOD_HOLD_TAU).items()}
        cb = r.render(cams[0], LOD_HOLD_TAU)
    for key, val in ca.items():
        check(torch.equal(val, cb[key]) and torch.equal(val, a[key]),
              f"two compiled tau={LOD_HOLD_TAU:g} frames differ in {key}, or from the eager frame")
    pre, tb, ty, tx, tile, max_blocks, bf16 = kept["args"]
    check(not bf16, "hierarchy: the frame blended the bf16 stream")
    p = blend_plain.blend_tiles(pre, tb, ty, tx, tile, max_blocks)
    err = 0.0
    for key in PLANE_KEYS:
        assert_close(kept["planes"][key], p[key], f"hierarchy tau={LOD_HOLD_TAU:g} frame {key}")
        err = max(err, max_abs_err(kept["planes"][key], p[key]))
    n_rows = pre.mean2d.shape[0]
    n_diff = int((kept["planes"]["out_observe"] != p["out_observe"]).sum())
    check(n_diff <= n_rows // 1000, f"hierarchy: out_observe differs on {n_diff} of {n_rows} rows (> 0.1%)")
    print(f"[hier] tau={LOD_HOLD_TAU:g} frame, view 0 ({n_rows} interpolated rows, {int(tb.num_instances)} instances): "
          f"forward kernel vs plain blend: max abs err {err:.3e} (atol 3e-4 / rtol 1e-3 holds), out_observe differs "
          f"on {n_diff} of {n_rows} rows; two eager and two compiled frames bitwise equal")
    del kept, pre, tb, p, a, b, ca, cb

    # the interpolation forward kernel on the same frame's cut, through
    # interpolate_cut, against the plain expression
    from hidegs_tpu_torch.hier import interp as hi
    from hidegs_tpu_torch.hier import interp_autograd as ia

    with torch.no_grad():
        cut = lod.expand_packed(e._packed, e.target_size(cams[0], LOD_HOLD_TAU), cams[0].camera_center,
                                budget=e._budget, num_points=e.num_points)
        got = hi.interpolate_cut(cut, *e.arrays, attrs=e._attrs)
        want = ia.interpolate_plain(e._attrs, *hi.slot_rows(cut, e.num_points), cut.ts, cut.kids, cut.valid,
                                    e.arrays[4].shape[1:])
    interp_err = max(max_abs_err(x, y) for x, y in zip(got, want, strict=True))
    check(all(torch.equal(int_bits(x), int_bits(y)) for x, y in zip(got, want)),
          f"hierarchy tau={LOD_HOLD_TAU:g}: interpolate_cut's kernel differs from interpolate_plain "
          f"(max abs err {interp_err:.3e})")
    print(f"[hier] tau={LOD_HOLD_TAU:g} cut, view 0 ({int(cut.valid.sum())} of {cut.valid.shape[0]} slots valid): "
          f"interpolate_cut's forward kernel bitwise interpolate_plain")
    del cut, got, want

    # ms per LOD frame of both renderers and the four stages, view 0; the
    # device busy share of both at tau 0 and 6
    times = {}
    for tau in LOD_TAUS:
        with torch.no_grad():
            eager_ms = time_ms(lambda: e.render(cams[0], tau))
            frame_ms = time_ms(lambda: r.render(cams[0], tau))
            host = []
            for _ in range(ITERS):
                sync(dev)
                t0 = time.perf_counter()
                r.render(cams[0], tau)
                host.append(1e3 * (time.perf_counter() - t0))
            parts = {name: time_ms(fn) for name, fn in lod_stages(e, cams[0], tau).items()}
        times[tau] = dict(eager_ms=eager_ms, frame_ms=frame_ms, host_ms=statistics.median(host), **parts)
        print(f"[hier-times] tau {tau:g}: ms per LOD frame (CUDA events, median of {ITERS}) eager {eager_ms:.3f}, "
              f"compiled {frame_ms:.3f} ({eager_ms / frame_ms:.2f}x); host ms per compiled frame (the viewpoint "
              f"read, copy-in, replay, the counter read; median of {ITERS}) {times[tau]['host_ms']:.3f}; stages "
              f"alone: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
              + f" ms; cut {cuts[tau, 0][0]}, budget {cuts[tau, 0][1]}, instances {cuts[tau, 0][2]}")
        if tau in (0.0, LOD_HOLD_TAU):
            with torch.no_grad():
                for mode, renderer in (("eager", e), ("compiled", r)):
                    times[tau][f"{mode}_profile"] = profile_device(lambda: renderer.render(cams[0], tau),
                                                                   f"hier-{mode}-tau{tau:g}")
    for c in r.compiled.captures:
        print(f"[hier] capture: budget {c['budget']}, max_instances {c['max_instances']}: warm-up "
              f"{c['warmup_s']:.3f} s, capture {c['capture_s']:.3f} s, graph pool "
              f"+{c['pool_reserved_bytes'] / 2**30:.3f} GiB reserved")
    pool = sum(c["pool_reserved_bytes"] for c in r.compiled.captures) / 2**30
    print(f"[hier] {len(r.compiled.captures)} captures, {r.compiled.replays} replays in the renderer's "
          f"CompiledLodFrame; the graph pool grew by {pool:.3f} GiB over its captures")
    result = dict(launches=launches["eager"], compiled_launches=launches["compiled"], err=err, times=times, cuts=cuts,
                  captures=len(r.compiled.captures), pool_gib=pool, interp_err=interp_err)
    del r, e
    torch.cuda.empty_cache()
    return result


def serve_hierarchy(src, hier_path, dev):
    """`render_cli --hierarchy <file> --tau SERVE_TAU` on the serve phase's
    COLMAP scene: launches and ms per view."""
    from hidegs_tpu_torch import render_cli
    from hidegs_tpu_torch.utils import png

    out = src.parent / "render_cli_hier"
    calls = []
    reset_counts()
    t0 = time.perf_counter()
    with frame_calls(calls):
        render_cli.main(["--source_path", str(src), "--hierarchy", str(hier_path), "--tau", str(SERVE_TAU),
                         "--resolution", "1", "--output_path", str(out), "--device", str(dev)])
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    pngs = sorted(out.glob("*.png"))
    replays = dict(zip(launches, replay_counts()))
    check(len(pngs) >= 1, "render_cli --hierarchy wrote no PNG")
    # on the card render_cli's renderer replays its frames
    captures = check_frame_launches(calls, launches, replays, len(pngs), "compiled", "render_cli --hierarchy")
    img = png.read_image(str(pngs[0]))
    check(img.shape == (FULL_H, FULL_W, 3) and img.std() > 1, "render_cli --hierarchy: a blank or misshapen view")
    print(f"[serve] render_cli --hierarchy {hier_path.name} --tau {SERVE_TAU:g}: {len(pngs)} views in {wall:.2f} s "
          f"({1e3 * wall / len(pngs):.1f} ms per view, the .hier read, the renderer's set-up, {captures} captures and "
          f"the PNG writes included); launches {launches}, of which {replays['blend_fwd']} replayed")
    return launches


BF16_IMAGE_TOL = 0.03  # tests/test_pallas.py's bf16 test: the image against float32
BF16_GRAD_TOL = 5e-2  # and the gradients, of each array's max |grad|, with its loss mean(render²)
# the cotangent planes of the geometric (depth-normal) terms: invdepth,
# normal and distance (blend_plain.tiles_to_planes)
GEO_PLANES = slice(3, 8)
DISTANCE_PLANE = 7


def render_grads(scene, cam, cfg):
    """render() of `scene` (render_geo on) and the loss of the JAX package's
    bf16 test, mean(render²), backpropagated to the means and opacities;
    hooks on the blend node keep what its backward is given and returns,
    and the blend_tiles call its arguments."""
    from hidegs_tpu_torch.raster.api import render

    leaves = [x.detach().clone().requires_grad_(i in (0, 3)) for i, x in enumerate(scene)]
    kept, got = {}, {}
    with kept_blend(kept):
        out = render(*leaves, cam, render_geo=True, config=cfg)
    handles = keep_backward_inputs(find_node(out["render"].grad_fn, "BlendPackedBackward"), got)
    out["render"].square().mean().backward()
    for h in handles:
        h.remove()
    check(bool(got), "the blend's backward did not run")
    return dict(render=out["render"].detach(), overflow=int(out["overflow"]), kept=kept, node=got,
                grads=(leaves[0].grad, leaves[3].grad))


def hold_bf16_node(node, kept, what):
    """A bf16 blend node of the real path (RasterConfig.bf16_stream) against
    the plain bf16 versions on its own packed rows, binning and cotangents:
    the rows it saved are bf16_rows of the float32 packed rows, its planes
    and observe counts at phase 4's gates, its d_attrs with `hold_backward`;
    and its planes and d_attrs bitwise what the launchers give."""
    from hidegs_tpu_torch.raster import blend_plain, cuda_blend

    pre, tb, ty, tx, tile, max_blocks, bf16 = kept["args"]
    check(bf16 and node["args"][-1], f"{what}: bf16_stream=True did not reach the blend")
    attrs = blend_plain.pack_gaussian_attrs(pre).detach()
    rows, tile_out, count = node["attrs"], node["tile_out"], node["count"]
    # compared as bits: columns 0:4 carry the float32 mean2d's bytes, which may read as bf16 NaNs
    check(rows.dtype == torch.bfloat16
          and torch.equal(rows.view(torch.int16), blend_plain.bf16_rows(attrs).view(torch.int16)),
          f"{what}: the node's saved rows are not bf16_rows of the packed rows")
    p_out, p_obs = blend_plain.blend_tile_out(blend_plain.unpack_attrs(attrs), tb, ty, tx, tile, max_blocks, bf16=True)
    assert_close(tile_out, p_out, f"{what}: forward vs plain bf16")
    fwd_err = max_abs_err(tile_out, p_out)
    observe = kept["planes"]["out_observe"]
    n_diff = int((observe != p_obs).sum())
    check(n_diff <= attrs.shape[0] // 1000, f"{what}: out_observe differs on {n_diff} of {attrs.shape[0]} (> 0.1%)")
    k_out, k_obs = cuda_blend.blend_tile_out(rows, tb, count, ty, tx, tile)
    check(torch.equal(k_out, tile_out) and torch.equal(k_obs, observe),
          f"{what}: the node's planes are not bitwise the launcher's")
    h = hold_backward(attrs, tb, count, tile_out, node["g_tiles"], ty, tx, tile, max_blocks, f"{what}: backward",
                      bf16=True)
    check(torch.equal(node["d_attrs"], h["got"]), f"{what}: the node's d_attrs are not bitwise the launchers'")
    print(f"[bf16] {what}: rows of {rows.shape[1] * 2} bytes (not 64); forward vs plain bf16 max abs err "
          f"{fwd_err:.3e} (atol 3e-4 / rtol 1e-3 holds), out_observe differs on {n_diff} of {attrs.shape[0]}; "
          f"backward + fold vs plain bf16: {hold_report(h)}; planes and d_attrs bitwise the launchers'")
    return dict(h, pre=pre, tb=tb, ty=ty, tx=tx, tile=tile, max_blocks=max_blocks, rows=rows, fwd_err=fwd_err,
                tile_out=tile_out, g_tiles=node["g_tiles"])


def grad_departures(a16, a32):
    """Per column, max |bf16 − float32| over the float32 column's max |grad|."""
    return [float((a16[:, c] - a32[:, c]).abs().max()) / max(float(a32[:, c].abs().max()), 1e-30)
            for c in range(a32.shape[1])]


def phase_bf16(scene, cams, cfg, train):
    """B3, the bf16 attribute stream of both blends, through the path a user
    turns on: RasterConfig(bf16_stream=True) in render() on the render
    cell's view 0 (JAX's test loss, rgb only) and in train_step's forward
    and backward on the train cell's trained state (the full loss stack).
    Each blend node is held against the plain bf16 versions and bitwise
    against the launchers (`hold_bf16_node`). bf16 against float32 at the
    JAX tolerances on the render cell: image within 0.03, the means' and
    opacities' gradients within 5e-2 of their max. On the train cell the
    packed gradients of both modes on the same cotangents, per column
    within 5e-2 of the float32 column's max with the distance plane's
    cotangent zeroed and with all geometric planes' zeroed; with the whole
    cotangents printed, not gated (the distance plane's cotangent turns
    the rounding of a splat's plane distance into gradient). Both modes
    timed one launch at a time, in turns."""
    import dataclasses

    from hidegs_tpu_torch.raster import blend_plain, cuda_blend

    # render(): forward and backward with bf16_stream=True, and float32
    reset_counts()
    r16 = render_grads(scene, cams[0], dataclasses.replace(cfg, bf16_stream=True))
    launches = read_counts()
    check(launches == kernel_dict(per_kernel(1, 1)),
          f"bf16 render and backward launched {launches}, expected one of each render kernel")
    r32 = render_grads(scene, cams[0], cfg)
    check(r16["overflow"] == 0 and r32["overflow"] == 0, "bf16 render: overflow")
    a = hold_bf16_node(r16["node"], r16["kept"], "render(), bf16_stream=True, render cell view 0, loss mean(render²)")
    img_err = max_abs_err(r16["render"], r32["render"])
    grad_errs = {}
    for name, g16, g32 in zip(("means3d", "opacities"), r16["grads"], r32["grads"]):
        check(bool(torch.isfinite(g16).all()), f"bf16 render: non-finite {name} gradients")
        grad_errs[name] = float((g16 - g32).abs().max()) / (float(g32.abs().max()) + 1e-8)
    print(f"[bf16] render cell view 0, bf16 against float32 (JAX's tolerances): rgb max abs err {img_err:.4e} "
          f"(tol {BF16_IMAGE_TOL}); gradients of mean(render²), max |bf16 − f32| over the float32 max |grad|: "
          + ", ".join(f"{k} {v:.4e}" for k, v in grad_errs.items()) + f" (tol {BF16_GRAD_TOL})")
    check(img_err < BF16_IMAGE_TOL, f"bf16 render: the image is {img_err:.4f} from float32's (tol {BF16_IMAGE_TOL})")
    for name, e in grad_errs.items():
        check(e <= BF16_GRAD_TOL, f"bf16 render: {name} gradients {e:.4e} of the max from float32's "
                                  f"(tol {BF16_GRAD_TOL})")
    del r16, r32

    # train_step with bf16_stream=True on the train cell's trained state
    ts, tcfg, batch = train["ts"], train["tcfg"], train["batches"][0]
    kept = {}
    with kept_blend(kept):
        node = blend_backward_inputs(
            ts, batch, dataclasses.replace(tcfg, raster=dataclasses.replace(tcfg.raster, bf16_stream=True)))
    b = hold_bf16_node(node, kept, "train_step, bf16_stream=True, train cell view 0, full loss stack")
    battrs, btb, bcount, btx, tile = b["attrs"], b["tb"], b["count"], b["tx"], b["tile"]
    t32, _ = cuda_blend.blend_tile_out(battrs, btb, bcount, b["ty"], btx, tile)
    g_tiles = b["g_tiles"]
    variants = {"full": g_tiles}
    for name, planes in (("distance zeroed", DISTANCE_PLANE), ("geometric planes zeroed", GEO_PLANES)):
        g = g_tiles.clone()
        g[..., planes] = 0.0
        variants[name] = g
    deps = {}
    for name, g in variants.items():
        g16 = cuda_blend.grad_attrs(b["rows"], btb, bcount, blend_plain.augment_cotangents(b["tile_out"], g), btx, tile)
        g32 = cuda_blend.grad_attrs(battrs, btb, bcount, blend_plain.augment_cotangents(t32, g), btx, tile)
        deps[name] = grad_departures(g16, g32)
        print(f"[bf16] train cell, bf16 against float32 packed gradients on the same cotangents ({name}), per "
              "column max |bf16 − f32| over the float32 column's max: "
              + ", ".join(f"c{c} {d:.3e}" for c, d in enumerate(deps[name])))
        if name == "full":  # printed: the distance plane's cotangent turns its rounding into gradient
            bf16_departures(battrs, btb, g16, g32, g_tiles)
        else:
            check(max(deps[name]) <= BF16_GRAD_TOL, f"bf16 train cell ({name}): a packed gradient column departs "
                                                    f"{max(deps[name]):.4e} of its max from float32's "
                                                    f"(tol {BF16_GRAD_TOL})")

    # times, both modes in turns (f32, bf16, bf16, f32), one launch at a time
    with torch.no_grad():
        pre, tb, tx, ftile = a["pre"], a["tb"], a["tx"], a["tile"]
        attrs, rows, count = a["attrs"], a["rows"], a["count"]
        P, T = ftile * ftile, a["ty"] * tx
        out = torch.empty((T, P, cuda_blend.OUT_CH), device=attrs.device)
        obs = torch.zeros((attrs.shape[0],), dtype=torch.int32, device=attrs.device)

        def fwd(r):
            def launch():
                obs.zero_()
                cuda_blend.launch_blend_fwd(r, tb.gauss_id, tb.tile_start, count, tx, ftile, out, obs)
            return launch

        turns = [time_ms(fwd(x)) for x in (attrs, rows, rows, attrs)]
        view = blend_plain.unpack_attrs(attrs)
        plain16_ms = time_ms(lambda: blend_plain.blend_tile_out(view, tb, a["ty"], tx, ftile, a["max_blocks"],
                                                                bf16=True))
        post_cull = int(count.sum())
        unique_rows = int(torch.unique(tb.gauss_id[:post_cull]).numel())
        bytes16 = post_cull * 4 + 2 * T * 4 + unique_rows * 32 + T * P * 64 + post_cull * 4
        counts = blend_plain.pair_counts(pre, tb, tx, ftile, a["max_blocks"], bf16=True)
        bound = blend_bound(bytes16, counts, ftile, OPS_PER_LIVE_PAIR, OPS_PER_KEPT_PAIR, SFU_PER_KEPT_PAIR)
        ms16 = statistics.median(turns[1:3])
        print(f"[bf16-times] forward kernel, render cell view 0, in turns (f32, bf16, bf16, f32), one launch at a "
              f"time: {', '.join(f'{t:.4f}' for t in turns)} ms; plain bf16 {plain16_ms:.3f} ms; bf16 "
              f"{bound['text']}; bf16 kernel at {bound['bound_ms'] / ms16:.1%} of its bound")
        fwd16 = dict(ms=ms16, f32_ms_in_turns=statistics.median([turns[0], turns[3]]), plain_ms=plain16_ms,
                     bound_ms=bound["bound_ms"], bound_by=bound["bound_by"], max_abs_err=a["fwd_err"],
                     image_err=img_err)
        del out, obs

        brows_out = torch.zeros((btb.gauss_id.shape[0], cuda_blend.ATTR), device=battrs.device)
        slot_s = btb.slot_s.contiguous()
        g_aug32 = blend_plain.augment_cotangents(t32, g_tiles)

        def bwd(r, g):
            def launch():
                brows_out.zero_()
                cuda_blend.launch_blend_bwd(r, btb.gauss_id, btb.tile_start, bcount, btx, tile, slot_s, g, brows_out)
            return launch

        bturns = [time_ms(bwd(*x)) for x in ((battrs, g_aug32), (b["rows"], b["g_aug"]), (b["rows"], b["g_aug"]),
                                               (battrs, g_aug32))]
        bview = blend_plain.unpack_attrs(battrs)
        bplain_ms = time_ms(lambda: blend_plain.blend_tiles_bwd(bview, btb, b["g_aug"], b["ty"], btx, tile,
                                                                b["max_blocks"], bf16=True))
        bpost = int(bcount.sum())
        bunique = int(torch.unique(btb.gauss_id[:bpost]).numel())
        bI, bT = btb.gauss_id.shape[0], b["ty"] * btx
        bbytes = bpost * 4 + 2 * bT * 4 + bunique * 32 + bT * tile * tile * 48 + bI * 4 + bI * 64
        bcounts = blend_plain.pair_counts(bview, btb, btx, tile, b["max_blocks"], bf16=True)
        bbound = blend_bound(bbytes, bcounts, tile, BWD_OPS_PER_LIVE_PAIR, BWD_OPS_PER_KEPT_PAIR,
                             BWD_SFU_PER_KEPT_PAIR)
        bms16 = statistics.median(bturns[1:3])
        print(f"[bf16-times] backward kernel, train cell view 0, in turns (f32, bf16, bf16, f32), one launch at a "
              f"time: {', '.join(f'{t:.4f}' for t in bturns)} ms; plain bf16 {bplain_ms:.3f} ms; bf16 "
              f"{bbound['text']}; bf16 kernel at {bbound['bound_ms'] / bms16:.1%} of its bound")
    bwd16 = dict(ms=bms16, f32_ms_in_turns=statistics.median([bturns[0], bturns[3]]), plain_ms=bplain_ms,
                 bound_ms=bbound["bound_ms"], bound_by=bbound["bound_by"], max_abs_err=max(a["err"], b["err"]),
                 grad_err_vs_f32=grad_errs, train_grad_err_vs_f32={k: max(v) for k, v in deps.items()})
    return dict(fwd=fwd16, bwd=bwd16)


def bf16_departures(attrs, tb, g16, g32, g_tiles, top=4):
    """Where bf16 gradients depart from float32 ones: the gaussians whose
    mean2d and conic gradients (columns 0-4) depart most, normalised by each
    float32 column's max, with their conic's determinant before and after
    bf16 rounding, and the count of touched gaussians whose rounded conic
    is no longer positive definite; for the worst, both gradient rows and
    the largest cotangent in its tiles against the largest anywhere."""
    from hidegs_tpu_torch.raster import blend_plain

    scale = g32[:, :5].abs().amax(dim=0).clamp(min=1e-30)
    dep = ((g16[:, :5] - g32[:, :5]).abs() / scale).amax(dim=1)
    con, conr = attrs[:, 2:5], blend_plain.round_bf16(attrs[:, 2:5])
    det = con[:, 0] * con[:, 2] - con[:, 1] ** 2
    detr = conr[:, 0] * conr[:, 2] - conr[:, 1] ** 2
    touched = torch.diff(tb.g_start.long()) > 0
    flips = int(((detr <= 0) & (det > 0) & touched).sum())
    print(f"[bf16] {int(touched.sum())} gaussians have instances; {flips} of them have a conic that bf16 rounding "
          f"leaves not positive definite (det <= 0); {int((dep > 5e-2).sum())} depart above 5e-2 of a column's max")
    for g in torch.argsort(dep, descending=True)[:top].tolist():
        print(f"[bf16]   gaussian {g}: departure {float(dep[g]):.3e}, conic {[round(x, 6) for x in con[g].tolist()]}, "
              f"det {float(det[g]):.3e} -> {float(detr[g]):.3e} rounded, opacity {float(attrs[g, 5]):.4f}, "
              f"instances {int(tb.g_start[g + 1] - tb.g_start[g])}, mean2d {[round(x, 1) for x in attrs[g, 0:2].tolist()]}")
    worst = int(torch.argmax(dep))
    tiles = tb.tile_id[tb.gauss_id == worst].long()
    local = g_tiles[tiles].abs().amax(dim=(0, 1))[:10]
    print(f"[bf16]   worst gaussian {worst}: float32 row {[f'{x:.3e}' for x in g32[worst, :6].tolist()]}, bf16 row "
          f"{[f'{x:.3e}' for x in g16[worst, :6].tolist()]}; tiles {tiles.tolist()}; max |cotangent| per plane there "
          f"{[f'{x:.2e}' for x in local.tolist()]} against anywhere "
          f"{[f'{x:.2e}' for x in g_tiles.abs().amax(dim=(0, 1))[:10].tolist()]}")


POST_OPT_ITERS = 30  # post-optimization steps at full width
POST_OPT_TAU = 6.0  # the pixel granularity of the cut the steps train
POST_OPT_SH_SCALE = 0.7  # the start state: the hierarchy with every SH coefficient scaled
POST_OPT_BUDGET = 1 << 21  # post_optimize's default budget for 2,020,479 points


def post_opt_leaves(ts):
    """The tensors a post-opt step writes."""
    return list(ts.params) + list(ts.opt.m) + list(ts.opt.v) + [ts.opt.step, ts.step, ts.exposure, ts.exposure_m,
                                                                 ts.exposure_v]


def phase_post_opt(h, cams, targets):
    """The hierarchy post-optimizer at full width: phase 6a's hierarchy with
    every SH coefficient scaled by POST_OPT_SH_SCALE, `post_optimize` for
    POST_OPT_ITERS steps on the four views (targets: phase 4's leaf
    renders, clipped) at the τ=6 cut, exposure trained as the pipeline runs
    it, tile 32, an instance budget from a probe of the τ-cut frames
    (`pipeline.lod_sweep`, the pipeline's LOD evaluation) with 1.12x
    slack. On the card post_optimize runs the compiled step
    (CompiledHierTrainStep: a cut replay and a step replay per iteration);
    every iteration is held against the eager `select_cut` and
    `hier_train_step` on the same inputs (the cut, then the state and the
    metrics, bitwise), with the launches of both counted around each call
    and every replay but the first under set_sync_debug_mode("error"); the
    budget counters are the graph's outputs. Then: the τ-cut PSNR against
    the perturbed start; the last step's blend node held against the plain
    versions; two eager steps from one state bitwise equal; eager and
    compiled steps under set_sync_debug_mode("error"); the optimized
    hierarchy written as .hier and read back equal; ms per step of both
    modes with the eager stages, the host ms per replay, the device busy
    share of both and the peak memory."""
    from hidegs_tpu_torch.hier import io as hio
    from hidegs_tpu_torch.hier.lod import tau_to_target_size
    from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
    from hidegs_tpu_torch.pipeline import lod_sweep
    from hidegs_tpu_torch.raster.api import RasterConfig, round_budget
    from hidegs_tpu_torch.train import hier_trainer as ht
    from hidegs_tpu_torch.train import loop as tl
    from hidegs_tpu_torch.utils import graphs

    dev = targets[0].device
    target = tau_to_target_size(POST_OPT_TAU, float(cams[0].fx))
    start = h._replace(shs=(h.shs * POST_OPT_SH_SCALE).astype(np.float32))
    probe_cfg = RasterConfig(tile=32, max_instances=1 << 24)
    (before,) = lod_sweep(start, cams, targets, [POST_OPT_TAU], probe_cfg)
    psnr_before, cut_sizes, inst = before["psnr"], before["cuts"], before["instances"]
    check(before["overflow"] == 0, "post-opt: the probe of the τ-cut frames overflowed")
    cfg = RasterConfig(tile=32, max_instances=round_budget(int(max(inst) * 1.12)))
    print(f"[post-opt] hierarchy {h.num_points} points / {h.num_nodes} nodes, SH x{POST_OPT_SH_SCALE}; τ={POST_OPT_TAU:g} "
          f"cut per view {cut_sizes} (budget {POST_OPT_BUDGET}), instances {inst} → max_instances {cfg.max_instances}")

    from hidegs_tpu_torch.train.budgets import COUNTERS

    OVERFLOWS = ("overflow", "block_overflow", "visible_overflow")
    losses, counters, last, owner, diverged = [], [], {}, {}, []
    path = {"eager": per_kernel(0, 0), "compiled": per_kernel(0, 0)}

    def hold_select(select):
        def call(self, ts, cam, target_size, budget):
            want = ht.select_cut(ts, cam, target_size, budget)
            cut = select(self, ts, cam, target_size, budget)
            bad = [f for f in cut._fields if not torch.equal(getattr(cut, f), getattr(want, f))]
            if bad and not diverged:
                diverged.append((len(losses), f"the cut's {bad}"))
            return cut
        return call

    def hold_step(step):
        def call(self, ts, cut, cam, gt, lrs, rcfg, **kwargs):
            owner["step"] = self
            k = len(losses)
            if k == POST_OPT_ITERS - 1:  # the last step's inputs, for the node hold
                last.update(ts=graphs._map(torch.clone, ts), cut=graphs._map(torch.clone, cut), cam=cam, gt=gt,
                            lrs=lrs, kwargs=kwargs)
            sync(dev)
            d0 = direct_counts()
            want, wm = ht.hier_train_step(ts, cut, cam, gt, lrs, rcfg, **kwargs)
            sync(dev)
            d1, r1, n_caps = direct_counts(), replay_counts(), len(self.captures)
            if k > 0:
                torch.cuda.set_sync_debug_mode("error")
            try:
                new, m = step(self, ts, cut, cam, gt, lrs, rcfg, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sync(dev)
            eager = tuple(b - a for a, b in zip(d0, d1))
            d = tuple(b - a for a, b in zip(d1, direct_counts()))
            r = tuple(b - a for a, b in zip(r1, replay_counts()))
            captured = [c["kind"] for c in self.captures[n_caps:]]
            check(eager == per_kernel(1, 1, 1, 1, 1), f"post-opt step {k}: the eager step launched {eager}")
            check(r == per_kernel(1, 1, 1, 1, 1) and d == per_kernel(*(1,) * 5 if "step" in captured else (0, 0)),
                  f"post-opt step {k}: replayed launches {r}, the launchers' {d} (captured {captured})")
            path["eager"] = tuple(a + b for a, b in zip(path["eager"], eager))
            path["compiled"] = tuple(a + b + c for a, b, c in zip(path["compiled"], d, r))
            bad = [n for n, (x, y) in enumerate(zip(post_opt_leaves(new), post_opt_leaves(want)))
                   if not torch.equal(x, y)] + [key for key in wm if not torch.equal(m[key], wm[key])]
            if bad and not diverged:
                diverged.append((k, f"state leaves and metrics {bad}"))
            losses.append(m["loss"].clone())
            counters.append(torch.stack([m["counters"][COUNTERS.index(key)] for key in OVERFLOWS]))
            return new, m
        return call

    torch.cuda.reset_peak_memory_stats()
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    with patched(ht.CompiledHierTrainStep, "__call__", hold_step), \
            patched(ht.CompiledHierTrainStep, "select", hold_select):
        ts = ht.post_optimize(start, cams, targets, iterations=POST_OPT_ITERS, target_size=target,
                              raster_cfg=cfg, log_every=10, optimize_exposure=True, device=dev)
    sync(dev)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = read_counts()
    comp = owner["step"]
    h_opt = ht.hierarchy_from_state(ts, start)  # before a replay overwrites the buffers
    losses = torch.stack(losses).tolist()
    counters = torch.stack(counters).sum(0).tolist()
    n_step_captures = sum(c["kind"] == "step" for c in comp.captures)
    want_compiled = per_kernel(*(POST_OPT_ITERS + n_step_captures,) * 5)
    print(f"[post-opt] launches: {path['compiled']} on the compiled path ({POST_OPT_ITERS} steps: replays and "
          f"{n_step_captures} capture's warm-up), {path['eager']} of the eager steps held beside them; losses "
          f"{losses[0]:.4f} → {losses[-1]:.4f}; budget counters (overflow, block, visible; the graph's outputs) "
          f"summed {counters}; {1e3 * wall / POST_OPT_ITERS:.1f} ms per held iteration on the host clock (an eager "
          f"and a compiled step, the checks), peak device memory {peak_gb:.2f} GiB")
    check(diverged == [], f"post-opt: the compiled and eager steps part: {diverged}")
    check(path["eager"] == per_kernel(*(POST_OPT_ITERS,) * 5)
          and path["compiled"] == want_compiled
          and tuple(launches.values()) == tuple(a + b for a, b in zip(path["eager"], want_compiled)),
          f"post-opt launches {path}, {launches} in all; expected one of each kernel per eager step and per replay, "
          f"and one per capture's warm-up")
    check(len(losses) == POST_OPT_ITERS and all(np.isfinite(losses)), f"post-opt: losses {losses}")
    check(counters == [0] * len(OVERFLOWS), f"post-opt: a step overflowed its budgets {counters}")
    print(f"[post-opt] compiled and eager steps bitwise equal after each of the {POST_OPT_ITERS} steps (the cut, "
          f"params, moments, row steps, step, exposure and its moments, loss, n_visible); replays made no host sync")

    (after,) = lod_sweep(h_opt, cams, targets, [POST_OPT_TAU], cfg)
    psnr_after = after["psnr"]
    check(after["overflow"] == 0 and after["cuts"] == cut_sizes,
          "post-opt: the optimized hierarchy's cuts differ or overflow")
    print(f"[post-opt] τ={POST_OPT_TAU:g} cut PSNR, mean of the four views against the leaf renders: perturbed start "
          f"{psnr_before:.4f} dB, after {POST_OPT_ITERS} steps {psnr_after:.4f} dB")
    check(psnr_after > psnr_before, f"post-opt: the τ-cut PSNR did not rise ({psnr_before:.4f} → {psnr_after:.4f})")

    # the last step's blend node against the plain versions
    s_ts, cut, cam, gt, lrs, kw = (last[k] for k in ("ts", "cut", "cam", "gt", "lrs", "kwargs"))
    loss, inputs = ht.hier_step_forward(s_ts, cut, cam, gt, cfg, image_idx=kw["image_idx"],
                                        use_exposure=kw["use_exposure"])
    node = find_node(loss.grad_fn, "BlendPackedBackward")
    got = {}
    handles = keep_backward_inputs(node, got)
    inode, igot = find_node(loss.grad_fn, "InterpolateRowsBackward"), {}

    def keep_interp(grad_outputs):
        igot.update(slots=tuple(x.detach() for x in inode.saved_tensors),
                    grads=[None if g is None else g.contiguous() for g in grad_outputs])

    def keep_interp_result(grad_inputs, _grad_outputs):
        igot.update(rows=grad_inputs[0])

    handles += (inode.register_prehook(keep_interp), inode.register_hook(keep_interp_result))
    tl.step_backward(loss, inputs)
    for hd in handles:
        hd.remove()
    check(all(g is not None for g in igot["grads"]), "post-opt: an interpolated array had no gradient")
    interp_k = hold_interp((*igot["slots"], igot["grads"][4].shape[1:]), igot["grads"], "post-opt, last step's cut",
                           rows_grad=igot["rows"])
    del inode, igot
    ty, tx, tile, max_blocks, _ = got["args"]
    fwd_err = hold_node_forward(got, "post-opt, last step", tag="post-opt-hold")
    held = hold_backward(got["attrs"], got["tb"], got["count"], got["tile_out"], got["g_tiles"], ty, tx, tile,
                         max_blocks, "post-opt, last step")
    check(torch.equal(got["d_attrs"], held["got"]), "post-opt: the node's d_attrs are not bitwise the launchers'")
    print(f"[post-opt-hold] last step ({int(got['tb'].num_instances)} instances, {got['attrs'].shape[0]} interpolated "
          f"rows): backward + fold kernels vs blend_tiles_bwd + plain fold: {hold_report(held)}")
    del got, node, loss, inputs

    a, ma = ht.hier_train_step(s_ts, cut, cam, gt, lrs, cfg, **kw)
    b, mb = ht.hier_train_step(s_ts, cut, cam, gt, lrs, cfg, **kw)
    for i, (x, y) in enumerate(zip(post_opt_leaves(a), post_opt_leaves(b))):
        check(torch.equal(x, y), f"post-opt: two steps from one state differ in leaf {i}")
    check(torch.equal(ma["loss"], mb["loss"]), "post-opt: two steps from one state differ in the loss")
    print("[post-opt-hold] two steps from one state: params, moments, row steps, exposure and its moments bitwise equal")
    del a, b, s_ts

    def step(state):
        c = ht.select_cut(state, cam, target, POST_OPT_BUDGET)
        return ht.hier_train_step(state, c, cam, gt, lr_tree(state.step, LRConfig(), 1.0), cfg, **kw)

    def cstep(state):
        c = comp.select(state, cam, target, POST_OPT_BUDGET)
        return comp(state, c, cam, gt, lr_tree(state.step, LRConfig(), 1.0), cfg, **kw)

    ts0 = graphs._map(torch.clone, ts)  # the post-optimized state, kept from the replays that follow
    warm, _ = step(ts0)
    sync(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        stepped, m = step(warm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bool(torch.isfinite(m["loss"])) and int(stepped.step) == POST_OPT_ITERS + 2, "post-opt: unsynced step")
    del warm, stepped
    n_caps = len(comp.captures)
    state, _ = cstep(ts)  # the steady loop: each replay consumes the state the last one returned
    sync(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state, m = cstep(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bool(torch.isfinite(m["loss"])) and int(state.step) == POST_OPT_ITERS + 4 and len(comp.captures) == n_caps,
          "post-opt: unsynced compiled steps")
    print(f"[post-opt-hold] an eager step (select_cut, learning rates, forward, backward, Adam, exposure Adam) and "
          f"three compiled iterations (cut and step replays, learning rates) ran under set_sync_debug_mode('error'): "
          f"no host sync; {int(m['n_visible'])} visible rows")

    work = ROOT / "build" / "post_opt_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    hio.write_hier(str(work / "opt.hier"), h_opt)
    back = hio.read_hier(str(work / "opt.hier"))
    for name in hio.Hierarchy._fields:
        check(np.array_equal(getattr(back, name), getattr(h_opt, name)), f"post-opt: .hier read back differs in {name}")
    check(all(np.isfinite(getattr(back, f)).all() for f in ("pos", "rot", "scale", "alpha", "shs")),
          "post-opt: the optimized hierarchy is not finite")
    shutil.rmtree(work, ignore_errors=True)
    print("[post-opt] hierarchy_from_state written as .hier and read back equal, finite")

    i = kw["image_idx"]
    steady = [state]

    def replayed():
        steady[0], _ = cstep(steady[0])

    step_ms = time_ms(lambda: step(ts0))
    compiled_ms = time_ms(replayed)
    host = []
    for _ in range(ITERS):
        sync(dev)
        t0 = time.perf_counter()
        replayed()
        host.append(1e3 * (time.perf_counter() - t0))
    host_ms = statistics.median(host)

    def stages():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        c = ht.select_cut(ts0, cam, target, POST_OPT_BUDGET)
        ev[1].record()
        loss, inputs = ht.hier_step_forward(ts0, c, cam, gt, cfg, image_idx=i, use_exposure=True)
        ev[2].record()
        grads = tl.step_backward(loss, inputs)
        ev[3].record()
        ht.hier_step_update(ts0, c, grads, lrs, use_exposure=True, optimize_exposure=True)
        ev[4].record()
        ev[4].synchronize()
        return [ev[k].elapsed_time(ev[k + 1]) for k in range(4)]

    for _ in range(WARMUP):
        stages()
    split = [statistics.median(x) for x in zip(*(stages() for _ in range(ITERS)))]
    print(f"[post-opt-times] post-opt step (cut, learning rates, step; CUDA events, median of {ITERS} after {WARMUP} "
          f"warm-ups): eager {step_ms:.3f} ms, compiled {compiled_ms:.3f} ms ({step_ms / compiled_ms:.2f}x); host ms "
          f"per compiled iteration (copy-in and both replays, median of {ITERS}) {host_ms:.3f}; eager stages: select "
          f"{split[0]:.3f} ms, forward (interpolate + render + loss) {split[1]:.3f} ms, backward {split[2]:.3f} ms, "
          f"update (visible mask, Adam, exposure Adam) {split[3]:.3f} ms; peak device memory of the held run "
          f"{peak_gb:.2f} GiB")
    for c in comp.captures:
        print(f"[post-opt] capture of the {c['kind']}: warm-up {c['warmup_s']:.3f} s, capture {c['capture_s']:.3f} s, "
              f"graph pool +{c['pool_reserved_bytes'] / 2**30:.3f} GiB reserved, launches {c['launches']}")
    profiles = {"eager": profile_device(lambda: step(ts0), "post-opt-breakdown"),
                "compiled": profile_device(replayed, "post-opt-compiled-breakdown")}
    pool = sum(c["pool_reserved_bytes"] for c in comp.captures) / 2**30
    del comp, steady, state, ts, ts0
    torch.cuda.empty_cache()
    return dict(launches=dict(zip(launches, path["eager"])), compiled_launches=dict(zip(launches, path["compiled"])),
                fwd_err=fwd_err, err=held["err"], fold_err=held["fold_err"], interp=interp_k, step_ms=step_ms,
                compiled_ms=compiled_ms, host_ms=host_ms, split=split, psnr=(psnr_before, psnr_after), profiles=profiles, pool_gib=pool)


PIPE_SCENE = dict(n_ground=60_000, n_structs=96, seed=7, extent_xy=24.0)  # benchmarks/largescene_run.py:21-40
PIPE_GRID, PIPE_RES, PIPE_ALTITUDE = (8, 6), 256, 16.0
PIPE_CHUNKS = 9
PIPE_TAUS = (0.0, 3.0, 6.0, 15.0)
PIPE_COARSE, PIPE_ITERS, PIPE_POST = 200, 200, 100  # the JAX r5 record ran 1,200 / 5,000 / 1,200
PIPE_EVAL_VIEWS = 8  # evaluate_lod's max_views
PIPE_ARGS = ["--chunk_size", "18", "--min_n_cams", "4", "--capacity", "65536", "--max_instances", "524288",
             "--resolution", "1", "--coarse_iterations", str(PIPE_COARSE), "--iterations", str(PIPE_ITERS),
             "--post_opt_iterations", str(PIPE_POST), "--workers", "3",
             "--eval_taus", *(f"{t:g}" for t in PIPE_TAUS)]


def phase_pipeline(dev):
    """The large-scene pipeline at the JAX package's r5 layout, depth cut:
    make_uav_gaussians(60,000 ground, 96 structures, seed 7, extent 24)
    written as a COLMAP scene from an 8x6 nadir grid at altitude 16 (48
    views, 256x256, tile 32, point_stride 2, jitter 0.02), then
    `pipeline.main` (what `python -m hidegs_tpu_torch.pipeline` runs) with
    PIPE_ARGS and --device: chunking, a coarse model (the scaffold, so the
    chunk-box cull is on), the chunks in three worker processes (their
    output to one log each), merge, post-opt, the τ sweep. Seconds and
    parent-process launches per stage are read around each stage. Then the
    hierarchy tools on the result: `hier.cli merge` bitwise merged.hier,
    `hier.cli create --cameras` on chunk 0's model, and ChunkStreamer over
    the chunks."""
    import types

    from hidegs_tpu_torch import pipeline
    from hidegs_tpu_torch.data.synthetic import make_uav_gaussians, nadir_grid_camera, write_synthetic_colmap_scene
    from hidegs_tpu_torch.hier import cli as hier_cli
    from hidegs_tpu_torch.hier import io as hio
    from hidegs_tpu_torch.hier.streaming import ChunkStreamer
    from hidegs_tpu_torch.raster.api import RasterConfig, round_budget
    from hidegs_tpu_torch.utils import graphs

    # the chunk workers share the card with this process: hand back what
    # the earlier phases' caching allocator holds
    torch.cuda.empty_cache()
    work = ROOT / "build" / "pipeline_smoke"
    shutil.rmtree(work, ignore_errors=True)
    src, out, logs = work / "scene", work / "out", work / "logs"
    logs.mkdir(parents=True)
    t0 = time.perf_counter()
    scene = make_uav_gaussians(**PIPE_SCENE, device=dev)
    nx, ny = PIPE_GRID
    cams = [nadir_grid_camera(ix, iy, nx, ny, extent_xy=PIPE_SCENE["extent_xy"], altitude=PIPE_ALTITUDE,
                              height=PIPE_RES, width=PIPE_RES, device=dev) for iy in range(ny) for ix in range(nx)]
    write_synthetic_colmap_scene(str(src), scene, cams, point_stride=2, jitter_points=0.02,
                                 render_config=RasterConfig(tile=32, max_instances=round_budget(1 << 20),
                                                            depth_sort_bits=-1))
    print(f"[pipeline] wrote the scene: {scene.means3d.shape[0]} gaussians, {len(cams)} views {PIPE_RES}x{PIPE_RES} "
          f"({time.perf_counter() - t0:.2f} s)")
    del scene, cams

    seconds, launches, replayed, commands, captures = {}, {}, {}, [], []

    def counts():
        return direct_counts() + replay_counts()

    def stage(name):
        def wrap(fn):
            def call(*args, **kwargs):
                sync(dev)
                before, t = counts(), time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    sync(dev)
                    seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
                    delta = [b - a for a, b in zip(before, counts())]
                    n = len(KERNEL_NAMES)
                    prev = launches.get(name, per_kernel(0, 0))
                    launches[name] = tuple(p + d + r for p, d, r in zip(prev, delta[:n], delta[n:]))
                    replayed[name] = tuple(p + r for p, r in zip(replayed.get(name, per_kernel(0, 0)), delta[n:]))
            return call
        return wrap

    def record_capture(capture):
        def call(self, *args, **kwargs):
            g = capture(self, *args, **kwargs)
            captures.append(self.captures[-1])
            return g
        return call

    def popen(cmd, **kwargs):
        i = cmd.index("--chunk")
        commands.append(cmd)
        with open(logs / f"chunk_{cmd[i + 1]}_{cmd[i + 2]}.log", "ab") as log:
            return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, **kwargs)

    argv = ["--source_path", str(src), "--output_path", str(out), *PIPE_ARGS, "--device", str(dev)]
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for obj, name, key in ((pipeline.chunking, "compute_chunks", "chunking"),
                               (pipeline.chunking, "write_chunks", "chunking"), (pipeline, "train", "coarse"),
                               (pipeline, "_fanout_chunks", "chunk fan-out"), (pipeline, "merge_hierarchies", "merge"),
                               (pipeline, "post_optimize", "post-opt"), (pipeline, "evaluate_lod", "eval")):
            stack.enter_context(patched(obj, name, stage(key)))
        stack.enter_context(patched(pipeline, "subprocess", lambda _: types.SimpleNamespace(Popen=popen)))
        stack.enter_context(patched(graphs.GraphSet, "capture", record_capture))
        try:
            pipeline.main(argv)
        except BaseException:
            for log in sorted(logs.glob("*.log")):
                print(f"[pipeline] {log.name}, last lines:\n" + "\n".join(log.read_text().splitlines()[-15:]))
            raise
    wall = time.perf_counter() - t0
    total = read_counts()

    meta = json.loads((out / "pipeline.json").read_text())
    chunks = meta["chunks"]
    check(len(chunks) == PIPE_CHUNKS, f"pipeline: {len(chunks)} chunks, expected {PIPE_CHUNKS}")
    check(len(commands) >= PIPE_CHUNKS and all(c[1:3] == ["-m", "hidegs_tpu_torch.pipeline"]
                                               and c[c.index("--device") + 1] == str(dev) for c in commands),
          f"pipeline: the chunk workers' command lines {commands}")

    def finite(h):
        return all(np.isfinite(getattr(h, f)).all() for f in ("pos", "rot", "scale", "alpha", "shs"))

    skipped, sizes, trained = {}, {}, {}
    for i, j in chunks:
        name = f"chunk_{i}_{j}"
        h = hio.read_hier(str(out / "chunks" / name / "hierarchy.hier"))
        check(finite(h), f"pipeline: {name}'s hierarchy is not finite")
        sizes[name] = h.num_points
        text = (logs / f"{name}.log").read_text()
        found = re.findall(r"run summary: (\d+) steps skipped by the finite-step gate", text)
        skipped[name] = int(found[-1]) if found else 0
        cfg = json.loads((out / "chunks" / name / "trained" / "cfg_args.json").read_text())
        check(cfg["pipeline"]["chunk_box_cull"] is True
              and cfg["model"]["scaffold_file"].endswith(f"iteration_{PIPE_COARSE}"),
              f"pipeline: {name} trained without the coarse scaffold and the chunk-box cull")
        # the trainer's log line at the last iteration: alive rows, seconds of its train loop
        last = re.findall(rf"\[{PIPE_ITERS}/{PIPE_ITERS}\] loss=\S+ photo=\S+ alive=(\d+) \(([\d.]+)s\)", text)
        trained[name] = (int(last[-1][0]), float(last[-1][1])) if last else None
    merged = hio.read_hier(str(out / "merged.hier"))
    check(finite(merged) and finite(hio.read_hier(str(out / "merged_opt.hier"))),
          "pipeline: merged.hier or merged_opt.hier is not finite")
    check(merged.num_points == meta["num_points"] and merged.num_nodes == meta["num_nodes"], "pipeline: pipeline.json")

    hier_cli.main(["merge", "--chunks", str(out / "chunks"), "--out", str(work / "cli_merged.hier")])
    check((work / "cli_merged.hier").read_bytes() == (out / "merged.hier").read_bytes(),
          "pipeline: hier.cli merge is not bitwise merged.hier")
    c0 = out / "chunks" / f"chunk_{chunks[0][0]}_{chunks[0][1]}"
    os.symlink(src / "images", c0 / "images")  # the chunk's views, for load_scene
    ply = c0 / "trained" / "point_cloud" / f"iteration_{PIPE_ITERS}" / "point_cloud.ply"
    (work / "create").mkdir()
    hier_cli.main(["create", "--ply", str(ply), "--out", str(work / "create" / "hierarchy.hier"), "--cameras",
                   str(c0), "--device", str(dev)])
    created = hio.read_hier(str(work / "create" / "hierarchy.hier"))
    anchors = hio.read_anchors(str(work / "create" / "anchors.bin"))
    check(created.num_points > 0 and finite(created) and len(anchors) > 0, "pipeline: hier.cli create")
    streamer = ChunkStreamer(str(out / "chunks"), device=dev)
    check(len(streamer.chunks) == PIPE_CHUNKS and streamer.get(0).num_points > 0, "pipeline: ChunkStreamer")

    rows = meta["lod_eval"]
    cuts = [r["mean_cut"] for r in rows]
    check([r["tau"] for r in rows] == list(PIPE_TAUS) and all(np.isfinite(r["psnr"]) for r in rows),
          f"pipeline: lod_eval {rows}")
    check(all(a >= b for a, b in zip(cuts, cuts[1:])), f"pipeline: the mean cut rises with τ: {cuts}")
    n_eval = len(PIPE_TAUS) * PIPE_EVAL_VIEWS
    # the coarse model and the post-optimizer train on compiled steps: one
    # replayed launch of each kernel per step, and each capture's warm-up
    # step launches them once more (the post-opt cut's graph launches none,
    # nor do the graphs of the coarse trainer's densify rounds and scrubs)
    kinds = {"coarse": "the train step", "post-opt": "the post-opt step"}
    check({c["what"] for c in captures} == set(kinds.values()) | {"the densify round"}
          and all(c["launches"] == c["warmup_launches"] for c in captures),
          f"pipeline: captures {[(c['what'], c['launches'], c['warmup_launches']) for c in captures]}")
    warm = {stage: tuple(sum(c["warmup_launches"][k] for c in captures if c["what"] == what)
                         for k in KERNEL_NAMES) for stage, what in kinds.items()}
    # (the post-opt step interpolates its cut, forward and backward; the
    # coarse step renders no cut)
    steps = {"coarse": per_kernel(*(PIPE_COARSE,) * 3), "post-opt": per_kernel(*(PIPE_POST,) * 5)}
    for stage, want_replayed in steps.items():
        check(replayed.get(stage) == want_replayed,
              f"pipeline: the {stage} stage replayed {replayed.get(stage)} launches, expected {want_replayed}")
    want = {stage: tuple(n + w for n, w in zip(steps[stage], warm[stage])) for stage in steps}
    want["eval"] = per_kernel(n_eval, 0, 0, n_eval)  # a cut interpolated and rendered per (τ, view)
    for key, expect in want.items():
        check(launches.get(key) == expect, f"pipeline: {key} launched {launches.get(key)}, expected {expect}")
    by_stage = [sum(v[k] for v in launches.values()) for k in range(len(KERNEL_NAMES))]
    check(list(total.values()) == by_stage
          and by_stage == [sum(v[k] for v in want.values()) for k in range(len(KERNEL_NAMES))],
          f"pipeline: {total} launches in the parent process, {launches} by stage; expected only {want}")

    print(f"[pipeline] {len(chunks)} chunks {chunks}; chunk hierarchy points {sizes}; merged {merged.num_points} "
          f"points, {merged.num_nodes} nodes")
    print(f"[pipeline] seconds per stage: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"; pipeline.main {wall:.2f} s (pipeline.json: {meta['seconds']:.2f} s)")
    print(f"[pipeline] τ sweep (evaluate_lod, {PIPE_EVAL_VIEWS} views): " + ", ".join(
        f"τ={r['tau']:g}: PSNR {r['psnr']:.4f} dB, mean cut {r['mean_cut']:.0f}" for r in rows))
    print(f"[pipeline] steps skipped by the finite-step gate per chunk: {skipped}")
    print(f"[pipeline] each worker's train loop (alive rows, seconds of {PIPE_ITERS} iterations, its log): {trained}")
    print(f"[pipeline] the coarse model and the post-optimizer on compiled steps: {len(captures)} captures ("
          + ", ".join(f"{c['what']}, {c['max_instances'] if 'max_instances' in c else c['kind']}: warm-up "
                      f"{c['warmup_s']:.3f} s, capture {c['capture_s']:.3f} s" for c in captures)
          + f"), {PIPE_COARSE} + {PIPE_POST} step replays, warm-up launches {warm}")
    print(f"[pipeline] launches in the parent process per stage (fwd, bwd, fold): {launches}; post-opt "
          f"{1e3 * seconds['post-opt'] / PIPE_POST:.2f} ms per step ({PIPE_POST} steps, host clock, the state's "
          f"upload included); hier.cli merge bitwise merged.hier; hier.cli create --cameras: {created.num_points} "
          f"points, {len(anchors)} anchors; ChunkStreamer read {len(streamer.chunks)} chunks")
    shutil.rmtree(work, ignore_errors=True)
    return dict(launches=total, seconds=seconds, lod=rows)


def phase_viewer(scene, cams, max_instances):
    """Both viewers serve one full-width frame of the render scene over
    localhost, through the render function `python -m
    hidegs_tpu_torch.viewer` builds: HttpViewer on port 0 fetched with
    urllib, NetworkGUI with a socket client speaking the SIBR protocol.
    Each frame's pixels must equal render()'s image of the same camera,
    clipped and quantised. The render function replays a CompiledRender:
    the HTTP server's first frame captures it in a handler thread, a second
    HTTP frame (another yaw) and the SIBR frame replay it. Counts are read
    around the three frames: one replayed forward launch per frame and the
    warm-up's per capture."""
    import socket
    import struct
    import threading
    import urllib.request

    from hidegs_tpu_torch.core.camera_math import focal_to_fov
    from hidegs_tpu_torch.raster.api import RasterConfig, render
    from hidegs_tpu_torch.raster.compiled import CompiledRender
    from hidegs_tpu_torch.utils import png
    from hidegs_tpu_torch.viewer import __main__ as viewer_main
    from hidegs_tpu_torch.viewer.http_viewer import HttpViewer, orbit_camera
    from hidegs_tpu_torch.viewer.network_gui import NetworkGUI, camera_from_message, image_bytes

    dev = scene.means3d.device
    cfg = RasterConfig(max_instances=max_instances)  # the viewer's defaults but --max_instances
    render_fn = viewer_main.make_render_fn(scene, cfg)
    comp = render_fn.compiled
    check(isinstance(comp, CompiledRender), f"viewer: the render function replays {type(comp)}, not CompiledRender")
    capture_threads = []

    def note_thread(capture):
        def call(*args, **kwargs):
            g = capture(*args, **kwargs)
            capture_threads.append(threading.current_thread().name)
            return g
        return call

    xyz = scene.means3d.cpu().numpy()
    center = np.median(xyz, axis=0)
    view = (0.6, 1.2, 16.0)  # yaw, pitch, dist: the scene seen from above and aside
    http = HttpViewer(render_fn, center=center, dist=view[2], host="127.0.0.1", port=0, width=FULL_W,
                      height=FULL_H, info={"n_gaussians": int(xyz.shape[0])}, device=dev)
    gui = NetworkGUI("127.0.0.1", 0, device=dev)
    cam0 = cams[0]
    R, t = cam0.R.cpu().numpy(), cam0.t.cpu().numpy()
    Rt = np.eye(4, dtype=np.float32)
    Rt[:3, :3], Rt[:3, 3] = R, t
    wire = Rt.T.copy()
    wire[:, 1] *= -1
    wire[:, 2] *= -1
    msg = {"resolution_x": FULL_W, "resolution_y": FULL_H, "train": False,
           "fov_x": focal_to_fov(float(cam0.fx), FULL_W), "fov_y": focal_to_fov(float(cam0.fy), FULL_H),
           "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False, "keep_alive": True,
           "scaling_modifier": 1.0, "view_matrix": [float(x) for x in wire.reshape(-1)],
           "view_projection_matrix": [float(x) for x in wire.reshape(-1)]}
    got = {}

    def client():
        with socket.create_connection(("127.0.0.1", gui.listener.getsockname()[1]), timeout=120) as sk:
            payload = json.dumps(msg).encode()
            sk.sendall(struct.pack("<I", len(payload)) + payload)
            buf = b""
            while len(buf) < FULL_W * FULL_H * 3 + 4:
                chunk = sk.recv(1 << 20)
                check(bool(chunk), "viewer: the GUI closed the socket early")
                buf += chunk
            got["gui"] = np.frombuffer(buf[:FULL_W * FULL_H * 3], np.uint8).reshape(FULL_H, FULL_W, 3)

    http.serve_background()
    yaw2 = view[0] + 0.3  # the second HTTP frame: another yaw, a cache miss
    try:
        reset_counts()
        with patched(comp, "capture", note_thread):
            url, frames, http_s = {}, {}, []
            for yaw in (view[0], yaw2):
                t0 = time.perf_counter()
                url[yaw] = (f"http://127.0.0.1:{http.port}/frame?yaw={yaw}&pitch={view[1]}&dist={view[2]}"
                            f"&cx={center[0]:.2f}&cy={center[1]:.2f}&cz={center[2]:.2f}&w={FULL_W}&h={FULL_H}")
                frames[yaw] = urllib.request.urlopen(url[yaw], timeout=300).read()
                http_s.append(time.perf_counter() - t0)
            frame = frames[view[0]]
            th = threading.Thread(target=client)
            th.start()
            t0 = time.perf_counter()
            deadline = time.monotonic() + 120
            while gui.poll(render_fn, verify="smoke") is None:
                check(time.monotonic() < deadline, "viewer: the GUI never served its client")
                time.sleep(0.002)
            th.join(timeout=120)
            gui_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        http.shutdown()
        gui.close()
    n_captures = len(comp.captures)
    check(replay_counts() == per_kernel(3, 0) and direct_counts() == per_kernel(n_captures, 0) and comp.replays == 3,
          f"viewer path launches {launches}, expected one replayed forward blend per served frame (3) and the "
          f"warm-up's per capture ({n_captures})")
    check(bool(capture_threads) and capture_threads[0] != threading.main_thread().name,
          f"viewer: the first capture ran in {capture_threads or 'no thread'}, not in the HTTP server's handler "
          "thread")
    gcam = camera_from_message(msg, dev)
    for yaw, data in frames.items():
        arr = png.decode_png(data)
        hcam = orbit_camera(yaw, view[1], view[2], tuple(float(f"{c:.2f}") for c in center), FULL_H, FULL_W,
                            device=dev)
        with torch.no_grad():
            want_http = image_bytes(torch.clamp(render(*scene, hcam, config=cfg)["render"], 0, 1))
        check(arr.shape == (FULL_H, FULL_W, 3) and np.array_equal(arr, want_http) and arr.std() > 1,
              f"viewer: the HTTP frame at yaw {yaw} is not render()'s image, clipped and quantised")
    with torch.no_grad():
        want_gui = image_bytes(torch.clamp(render(*scene, gcam, config=cfg)["render"], 0, 1))
    check(np.array_equal(got["gui"], want_gui), "viewer: the SIBR frame is not render()'s image, clipped and quantised")
    check(got["gui"].std() > 1, "viewer: a blank frame")
    info = comp.captures[0]
    print(f"[viewer] HttpViewer: {FULL_W}x{FULL_H} frames over localhost in {1e3 * http_s[0]:.1f} ms (the first: "
          f"warm-up and capture of the render in thread {capture_threads[0]!r}, {info['warmup_s']:.3f} + "
          f"{info['capture_s']:.3f} s, pool +{info['pool_reserved_bytes'] / 2**30:.3f} GiB) and {1e3 * http_s[1]:.1f} "
          f"ms (a replay; render, PNG encode of {len(frames[yaw2]) / 2 ** 20:.2f} MiB, HTTP), pixels equal "
          f"render()'s; NetworkGUI: one frame in {1e3 * gui_s:.1f} ms (accept, replay, "
          f"{FULL_W * FULL_H * 3 / 2 ** 20:.2f} MiB of RGB), pixels equal render()'s; {n_captures} capture(s) in "
          f"threads {capture_threads}; launches {launches} ({comp.replays} replayed)")
    return dict(launches=launches)




def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    phase_environment()
    adam_k = phase_adam(dev)
    phase_small(dev)
    phase_small_backward(dev)
    scene, cams, cfg = full_width_setup(dev)
    render_launches, outs = phase_full_width(scene, cams, cfg)
    pre, tb, err = phase_hold_full_width(scene, cams, cfg, outs)
    times = phase_times(scene, cams[0], cfg, pre, tb)
    pre_fwd = phase_preprocess(scene, cams, cfg)
    phase_breakdown(scene, cams[0], cfg, pre, tb)
    rcomp = phase_render_compiled(scene, cams, cfg)
    leaf_renders = [torch.clamp(out["render"], 0, 1) for out in outs]
    del outs
    hier, hier_path = build_scene_hierarchy(scene)
    lod = phase_hierarchy(scene, cams, hier)
    post_opt = phase_post_opt(hier, cams, leaf_renders)
    del hier, leaf_renders
    serve = phase_serve(scene, cams, cfg, hier_path)
    shutil.rmtree(hier_path.parent, ignore_errors=True)
    viewer = phase_viewer(scene, cams, serve["cli_budget"])
    train = phase_train(scene, cams, cfg)
    held = phase_hold_train(train)
    pre_bwd = phase_preprocess_backward(train)
    train_launches = train["launches"]
    bf16 = phase_bf16(scene, cams, cfg, train)
    del pre, tb
    ttimes = phase_train_times(train, held)
    comp = phase_compiled(scene, cams, cfg)
    trainer_run = phase_trainer(scene, cams, cfg)
    trainer_run_launches = trainer_run["launches"]
    del train
    trainer_hold = phase_trainer_hold(trainer_run)
    del trainer_run
    pipe = phase_pipeline(dev)
    vp = phase_view_parallel(scene, cams, cfg)
    del scene
    launches = train_launches
    by_path = {name: {"render": render_launches[name], "render_compiled": rcomp["launches"][name],
                      "serve": serve["launches"][name],
                      "train": train_launches[name], "train_compiled": comp["launches"][name],
                      "trainer": trainer_run_launches[name],
                      "hierarchy": lod["launches"][name],
                      "hierarchy_compiled": lod["compiled_launches"][name] + serve["hier_launches"][name],
                      "viewer": viewer["launches"][name], "post_opt": post_opt["launches"][name],
                      "post_opt_compiled": post_opt["compiled_launches"][name],
                      "pipeline": pipe["launches"][name], "view_parallel": vp["launches"][name],
                      "view_parallel_compiled": vp["compiled_launches"][name]}
               for name in launches}
    kernels = [{
        "name": "blend_fwd",
        "route": "cuda",
        "source": "hidegs_tpu_torch/raster/csrc/blend_fwd.cu",
        "replaces": "hidegs_tpu/raster/pallas_blend.py:326",
        "launches": launches["blend_fwd"],
        "launches_by_path": by_path["blend_fwd"],
        "max_abs_err": max(err, trainer_hold["fwd_err"], lod["err"], post_opt["fwd_err"], vp["fwd_err"]),
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this blend
        "bf16": bf16["fwd"],  # the bf16-stream mode on the same view
    }, {
        "name": "blend_bwd",
        "route": "cuda",
        "source": "hidegs_tpu_torch/raster/csrc/blend_bwd.cu",
        "replaces": "hidegs_tpu/raster/pallas_vjp.py:61",
        "launches": launches["blend_bwd"],
        "launches_by_path": by_path["blend_bwd"],
        "max_abs_err": max(held["err"], trainer_hold["err"], post_opt["err"], vp["err"]),
        "ms": ttimes["bwd"]["ms"],
        "plain_ms": ttimes["bwd"]["plain_ms"],
        "bound_ms": ttimes["bwd"]["bound_ms"],
        "bound_by": ttimes["bwd"]["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this backward
        "bf16": bf16["bwd"],  # the bf16-stream mode on the same state
    }, {
        "name": "fold_rows",
        "route": "cuda",
        "source": "hidegs_tpu_torch/raster/csrc/blend_bwd.cu",
        # the instance-to-gaussian segment sum after the TPU backward kernel
        "replaces": "hidegs_tpu/raster/pallas_vjp.py:455",
        "launches": launches["fold_rows"],
        "launches_by_path": by_path["fold_rows"],
        "max_abs_err": max(held["fold_err"], trainer_hold["fold_err"], post_opt["fold_err"], vp["fold_err"]),
        "ms": ttimes["fold"]["ms"],
        "plain_ms": ttimes["fold"]["plain_ms"],
        "bound_ms": ttimes["fold"]["bound_ms"],
        "bound_by": ttimes["fold"]["bound_by"],
        "library_ms": ttimes["fold"]["library_ms"],  # index_add_ (atomics: not deterministic)
    }, {
        "name": "preprocess_fwd",
        "route": "cuda",
        "source": "hidegs_tpu_torch/raster/csrc/preprocess.cu",
        # no Pallas kernel: XLA's fusion of the JAX preprocess (with core/ewa.py, core/sh.py)
        "replaces": "hidegs_tpu/raster/preprocess.py:37",
        "launches": launches["preprocess_fwd"],
        "launches_by_path": by_path["preprocess_fwd"],
        "max_abs_err": pre_fwd["err"],  # phase 5p: the render cell's four views
        "radius_flips": [pre_fwd["flips"], pre_fwd["rows"]],
        "ms": pre_fwd["ms"],
        "plain_ms": pre_fwd["plain_ms"],
        "bound_ms": pre_fwd["bound_ms"],
        "bound_by": pre_fwd["bound_by"],
        "library_ms": None,  # no single PyTorch call computes it
    }, {
        "name": "preprocess_bwd",
        "route": "cuda",
        "source": "hidegs_tpu_torch/raster/csrc/preprocess.cu",
        "replaces": "hidegs_tpu/raster/preprocess.py:37",  # its jax.vjp
        "launches": launches["preprocess_bwd"],
        "launches_by_path": by_path["preprocess_bwd"],
        "max_abs_err": pre_bwd["err"],  # phase 10p: the train cell's step, against autograd of the plain forward
        "grad_err_of_max": pre_bwd["rel_err"],
        "ms": pre_bwd["ms"],
        "plain_ms": pre_bwd["plain_ms"],
        "bound_ms": pre_bwd["bound_ms"],
        "bound_by": pre_bwd["bound_by"],
        "library_ms": None,
    }, {
        "name": "masked_adam",
        "route": "cuda",
        "source": "hidegs_tpu_torch/model/csrc/masked_adam.cu",
        # no Pallas kernel: XLA's fusion of the JAX masked Adam
        "replaces": "hidegs_tpu/model/adam.py:45",
        "launches": launches["masked_adam"],
        "launches_by_path": by_path["masked_adam"],
        "max_abs_err": max(adam_k["err"], vp["adam_err"]),  # phase 1a and the train cell's state in phase 15
        "ms": adam_k["ms"],  # the post-opt cell's 2,020,479 rows, every row in the mask, out of place
        "in_place_ms": adam_k["in_place_ms"],
        "train_ms": adam_k["train_ms"],  # the train step's row budget, 2^21 rows
        "train_plain_ms": adam_k["train_plain_ms"],
        "plain_ms": adam_k["plain_ms"],
        "bound_ms": adam_k["bound_ms"],
        "bound_by": adam_k["bound_by"],
        "library_ms": None,  # no PyTorch call computes a masked Adam with per-row steps
    }] + [{
        "name": f"interp_{way}",
        "route": "cuda",
        "source": "hidegs_tpu_torch/hier/csrc/interp.cu",
        # no Pallas kernel: XLA's fusion of the JAX interpolation's gathers and lerps (and their jax.vjp)
        "replaces": "hidegs_tpu/hier/interp.py:32",
        "launches": launches[f"interp_{way}"],
        "launches_by_path": by_path[f"interp_{way}"],
        # phase 6b's last post-opt step (both ways) and phase 6a's τ=6 frame (forward): bitwise, so 0
        "max_abs_err": max([post_opt["interp"]["err"], *((lod["interp_err"],) if way == "fwd" else ())]),
        "ms": post_opt["interp"][f"{way}_ms"],  # phase 6b's last cut: B = 2^21 slots, P = 2,020,479 rows
        "plain_ms": post_opt["interp"][f"{way}_plain_ms"],
        "bound_ms": post_opt["interp"][f"{way}_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes the interpolation
    } for way in ("fwd", "bwd")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
