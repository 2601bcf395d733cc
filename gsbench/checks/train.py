"""The trainer cell's check: the plain reference follows the window's own
steps from the program's state and the numbers are held to the cell's
limits.

The reference (gsbench/reference, plain PyTorch, nothing of the program)
works the start out again from the benchmark's inputs (the KNN scales,
the initial state, the compaction, the capacity and the train config of
the program's default flags with the configuration's schedule) and holds
the program's initial parameters to it. It can only follow the window
from the program's own state: from the state cloned before the compared
stretch (three window steps and the densify round they lead into) it runs
the frozen `train_step` (plain preprocess, binning with an instance
budget it grows until nothing overflows and no visible-row compaction,
the plain blend forward and its closed-form backward with the fold, the
whole loss stack, masked sparse Adam) on the same views and sources, its
multi-view pixels drawn from the same generator state, with the row
budget it fits to the alive count itself, and then the frozen densify
round on the same split draws. The round is also run on its own, from
the program's state before it: its decisions are thresholds (split score,
prune opacity), which the rounding of three steps moves a few rows to
tens of rows across on a sound run, as far as the control does (PERF.md),
so the round is held from the program's own input.

Numbers, each a gap between the program's norm of a leaf and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger, taken at the worst leaf:
  * `init`: the parameters before step 1;
  * `grad_colour`: the stretch's first gradient, as Adam's first moment
    holds it, on the colour leaves;
  * `change`: the parameters' change over the three steps, over the leaves
    whose reference gradient is at least 1e-3 of the median leaf's;
  * `round_params`: the alive rows of each leaf after the round, the
    reference's round run on the program's state before it;
and `terms`, the relative gap of the first step's loss terms that are
continuous in the state, and `round_rows`, the gap of the alive count
after the round, in rows, the reference's round run as for
`round_params`. The stretch's own round (the reference's three steps and
its round) is noted, not compared. The multi-view NCC term is not compared: it
averages over the samples whose reprojection error is under one pixel, and
rounding moves a few samples across that threshold, which moves the term
(and the geometric leaves' gradient) by up to a few percent (PERF.md).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from gsbench.drivers.train import LEAVES, TERMS, alive_norms, change_norms, grad_norms
from gsbench.harness import Check, Context

GRAD_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median leaf's are left out
# the loss terms that are continuous in the state: the multi-view NCC term
# is not (its mean is over the samples under a reprojection threshold)
SMOOTH_TERMS = ("photo", "depth_l1", "freq", "single_view", "mv_geo")
# the leaves the multi-view NCC term does not reach (it reads the targets'
# grey images and the rendered geometry, not the colours)
COLOUR_LEAVES = ("sh_dc", "sh_rest")
OPT_KEYS = ("iterations", "densify_from_iter", "densify_until_iter", "densification_interval",
            "opacity_reset_interval", "depth_from_iter", "single_view_weight_from_iter",
            "multi_view_weight_from_iter", "max_all_points", "freq_warmup_iterations")


def reference_setup(cfg: dict, scene, device):
    """The reference's train config, capacity and initial parameters' norms."""
    from gsbench.reference.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gsbench.reference.model.gaussians import compact_gaussians, init_from_points
    from gsbench.reference.model.knn import initial_scales
    from gsbench.reference.train import trainer_setup
    from gsbench.reference.train.loop import init_train_state

    dev = torch.device(device)
    opt = OptimizationConfig(**{k: cfg[k] for k in OPT_KEYS})
    model = ModelConfig()
    assert model.skybox_num == 0 and not model.scaffold_file
    pts = torch.as_tensor(scene.info.points, device=dev)
    cols = torch.as_tensor(scene.info.colors, device=dev)
    n_init = pts.shape[0]
    capacity = trainer_setup.capacity_for(n_init, opt)
    tcfg = trainer_setup.train_config_from_opt(opt, PipelineConfig(), n_init)
    state = init_from_points(pts, cols, capacity=capacity, spatial_lr_scale=scene.info.nerf_norm_radius,
                             knn_scale=initial_scales(pts))
    state = state._replace(active_sh_degree=torch.full_like(state.active_sh_degree, cfg["initial_sh_degree"]))
    ts = init_train_state(state, num_images=len(scene.train_cameras))
    g0, _ = compact_gaussians(ts.gaussians, ts.opt)
    p0 = [float(torch.linalg.vector_norm(getattr(g0.params, f).double())) for f in LEAVES]
    return tcfg, capacity, p0


def as_reference(ts):
    """The program's train state as the reference's types, field by field
    by name: tensors cloned, generators forked."""
    from gsbench.drivers.train import clone_state
    from gsbench.reference.model.adam import AdamState
    from gsbench.reference.model.gaussians import GaussianParams, GaussianState
    from gsbench.reference.train.loop import TrainState

    def conv(x, cls, **given):
        return cls(**{f: given[f] if f in given else clone_state(getattr(x, f)) for f in cls._fields})
    g, o = ts.gaussians, ts.opt
    gaussians = conv(g, GaussianState, params=conv(g.params, GaussianParams))
    opt = conv(o, AdamState, m=conv(o.m, GaussianParams), v=conv(o.v, GaussianParams))
    return conv(ts, TrainState, gaussians=gaussians, opt=opt)


def reference_stretch(cfg: dict, scene, prog: Dict, device) -> Dict:
    """The reference's readings of the stretch from the program's state
    before it."""
    from gsbench.reference.train import trainer_setup
    from gsbench.reference.train.geometric import MultiViewBatch
    from gsbench.reference.train.loop import ViewBatch, maybe_host_side_schedule, train_step

    from gsbench.checks.common import ref_camera

    dev = torch.device(device)
    tcfg, capacity, p0 = reference_setup(cfg, scene, dev)
    start = as_reference(prog["start"])
    R = trainer_setup.fit_row_budget(int(start.gaussians.alive.sum()), capacity)
    vs = scene.train_cameras.views
    ts, out = start, dict(p0_norms=p0, terms=[], budgets=[])
    for k, st in enumerate(prog["stretch"]):
        v = vs[st["view"]]
        inv = torch.as_tensor(v.invdepth, device=dev)
        mv = None
        if st["src"] is not None:
            mv = MultiViewBatch(src_image_gray=vs[st["src"]].gray, src_plane_depth=None,
                                src_cam=ref_camera(vs[st["src"]].pose, dev))
        batch = ViewBatch(cam=ref_camera(v.pose, dev), image=v.image,
                          image_idx=torch.full((), st["view"], dtype=torch.int64, device=dev), invdepth=inv,
                          depth_mask=(inv > 0).to(torch.float32), alpha_mask=None, multi_view=mv)
        budget = max(tcfg.raster.max_instances, st["max_instances"])
        while True:
            raster = dataclasses.replace(tcfg.raster, max_instances=budget, max_blocks=0, max_visible=0)
            new, metrics = train_step(ts, batch, dataclasses.replace(tcfg, raster=raster), row_budget=R)
            if int(metrics["overflow"]) == 0:
                break
            budget *= 2
        out["budgets"].append(budget)
        out["terms"].append({t: float(x) for t, x in metrics.items() if t in TERMS})
        if k == 0:
            out["g_norms"] = grad_norms(ts.opt, new.opt).tolist()
        ts = new
    out["dp_norms"] = change_norms(ts.gaussians.params, start.gaussians.params).tolist()
    out["tcfg"], out["extent"] = tcfg, scene.extent
    ts, info = maybe_host_side_schedule(ts, tcfg, scene.extent, step=prog["round_at"])
    out["after_round"] = alive_norms(ts.gaussians).tolist()
    out["round_info"] = round_counts(info)
    del ts, start
    out["round_alone"], out["round_alone_info"] = reference_round(tcfg, scene.extent, prog)
    return out


def round_counts(info) -> Dict[str, int]:
    return {k: int(info[k]) for k in ("n_clone", "n_split", "n_pruned", "n_dropped")} if info else {}


def reference_round(tcfg, extent: float, prog: Dict):
    """The reference's densify round on the program's state before it (the
    same split draws: the generator is forked): the alive count and the
    alive rows' norms, and the round's counts."""
    from gsbench.reference.train.loop import maybe_host_side_schedule

    ts, info = maybe_host_side_schedule(as_reference(prog["pre_round"]), tcfg, extent, step=prog["round_at"])
    return alive_norms(ts.gaussians).tolist(), round_counts(info)
    return out


def leaf_gaps(prog: List[float], ref: List[float]) -> np.ndarray:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return np.abs(p - r) / np.maximum(np.maximum(np.abs(r), np.median(np.abs(r))), 1e-30)


def term_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    return {k: abs(prog[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in ref if k in prog}


def compare(prog: Dict, ref: Dict, limits: Dict, note=None) -> List[Check]:
    """The cell's numbers, each beside its limit."""
    if prog.get("after_round") is None or prog.get("pre_round") is None or prog.get("p0_norms") is None \
            or len(prog["terms"]) < 3:
        return [Check("stretch_read", 1.0, 0.0)]
    g_ref = np.asarray(ref["g_norms"])
    use = g_ref >= GRAD_FLOOR * np.median(g_ref)
    grad = leaf_gaps(prog["g_norms"], ref["g_norms"])
    change = leaf_gaps(prog["dp_norms"], ref["dp_norms"])
    terms = term_gaps(prog["terms"][0], ref["terms"][0])
    a_p, a_r, a_o = prog["after_round"], ref["after_round"], ref["round_alone"]
    alive = abs(a_p[0] - a_o[0])
    kept = leaf_gaps(a_p[1:], a_o[1:])
    if note is not None:
        note("first gradient's gap by leaf: " + ", ".join(f"{k} {v:.3g}" for k, v in zip(LEAVES, grad)))
        note("change's gap by leaf: " + ", ".join(f"{k} {v:.3g}" for k, v in zip(LEAVES, change)))
        note("first step's gap by term: " + ", ".join(f"{k} {v:.3g}" for k, v in terms.items()))
        note(f"after the round: alive {a_p[0]:.0f}; the reference's round from the program's state before it "
             f"{a_o[0]:.0f}; gap by leaf: " + ", ".join(f"{k} {v:.3g}" for k, v in zip(LEAVES, kept)))
        note(f"not compared: after the reference's own stretch and round, alive {a_r[0]:.0f} (gap "
             f"{abs(a_p[0] - a_r[0]):.0f} rows); gap by leaf: "
             + ", ".join(f"{k} {v:.3g}" for k, v in zip(LEAVES, leaf_gaps(a_p[1:], a_r[1:]))))

    def finite(x):
        return float(x) if math.isfinite(x) else float("inf")
    return [
        Check("init", finite(leaf_gaps(prog["p0_norms"], ref["p0_norms"]).max()), limits["init"]),
        Check("terms", finite(max(terms[k] for k in SMOOTH_TERMS)), limits["terms"]),
        Check("grad_colour", finite(max(g for k, g in zip(LEAVES, grad) if k in COLOUR_LEAVES)),
              limits["grad_colour"]),
        Check("change", finite(change[use].max()), limits["change"]),
        Check("round_rows", finite(alive), limits["round_rows"]),
        Check("round_params", finite(kept.max()), limits["round_params"]),
    ]


def check(ctx: Context, state: Dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog = state["readings"]
    if prog.get("start") is None:
        ctx.checks = [Check("stretch_read", 1.0, 0.0)]
        return
    ref = reference_stretch(ctx.cell.config, state["scene"], prog, ctx.device)
    state["reference"] = ref
    ctx.checks = compare(prog, ref, ctx.cell.traffic["limits"], ctx.note)
    ctx.note(f"the reference's round at {prog['round_at']}: after its own stretch {ref['round_info']}; "
             f"from the program's state {ref['round_alone_info']}")
    for k, (a, b) in enumerate(zip(prog["terms"], ref["terms"])):
        st = prog["stretch"][k]
        ctx.note(f"iteration {st['iteration']} views {st['view'], st['src']} row budget {st['row_budget']} "
                 f"max_visible {st['max_visible']}: program {a}; reference {b}")
    if ctx.trace and prog.get("yard") is not None:
        yardstick(ctx, state)


def yardstick(ctx: Context, state: Dict) -> None:
    """The traced run's readings of one profiled step (drawn from the seed):
    the backward blends' bound and kernel time, and the step's counted work
    (gsbench/yardstick.py) beside its device span."""
    from gsbench import yardstick as ys
    from gsbench.checks import common

    y = state["readings"]["yard"]
    views = state["scene"].train_cameras.views
    p = y["params"]
    alive = y["alive"]
    arrays = (p.xyz, torch.exp(p.scaling), torch.nn.functional.normalize(p.rotation, dim=-1),
              torch.where(alive, torch.sigmoid(p.opacity), torch.zeros_like(p.opacity)),
              torch.cat([p.sh_dc[:, None], p.sh_rest], dim=1))
    renders = [y["view"]] + ([y["src"]] if y["src"] is not None else [])
    bins = [common.ref_binning(arrays, views[i].pose, y["raster"], y["sh_degree"], ctx.device, render_geo=True)
            for i in renders]
    bwd = [common.bwd_bound(b) for b in bins]
    fwd = [common.fwd_bound(b) for b in bins]
    ctx.yardstick["blend_bwd_bound_ms"] = sum(b["bound_ms"] for b in bwd)
    s = y["iteration"] - state["readings"]["profile_from"]
    per_step = len(renders)
    traced = ctx.yardstick.get("trace_blend_bwd_ms") or []
    n_steps = state["readings"]["profile_to"] - state["readings"]["profile_from"]
    if len(traced) == ctx.yardstick.get("launched_blend_bwd") == n_steps * per_step:
        ctx.yardstick["blend_bwd_ms"] = sum(traced[s * per_step:(s + 1) * per_step])
        ctx.yardstick["blend_bwd_source"] = "trace"
    else:
        ctx.yardstick["blend_bwd_ms"] = blend_bwd_alone(ctx, y, views, renders)
        ctx.yardstick["blend_bwd_source"] = "alone"
        ctx.note(f"blend_bwd: the profiler saw {len(traced)} launches, the program counted "
                 f"{ctx.yardstick.get('launched_blend_bwd')} over {n_steps} steps; timed alone")
    H, W = views[0].height, views[0].width
    R = y["rows"]
    work = [ys.pre_fwd(R), ys.pre_bwd(R), ys.loss_stack_ops(H, W), ys.adam(R),
            ys.multi_view_ops(y["samples"], y["patch_half"]) if y["src"] is not None else {"ops": 0, "bytes": 0}]
    work += [ys.pre_fwd(R), ys.pre_bwd(R)] if y["src"] is not None else []
    work += fwd + bwd
    ops, nbytes = sum(w["ops"] for w in work), sum(w["bytes"] for w in work)
    ctx.yardstick["step_bound_ms"] = max(ops / ys.FP32_FLOP_S, nbytes / ys.HBM_BYTES_S) * 1e3
    ctx.yardstick["step_ops"], ctx.yardstick["step_bytes"] = ops, nbytes
    steps = ctx.spans.get("profiled.step", [])
    if 0 <= s < len(steps):
        ctx.yardstick["step_device_ms"] = steps[s]


def blend_bwd_alone(ctx: Context, y: Dict, views, renders) -> float:
    """The backward blends of the yardstick's step, each timed alone on the
    inputs the program's eager render and backward give it (the rows of the
    step's state, the photometric and inverse-depth L1 as the cotangents'
    source)."""
    from hidegs_tpu_torch.raster import cuda_blend
    from hidegs_tpu_torch.raster.api import render

    p, alive = y["params"], y["alive"]

    def run():
        for i in renders:
            v = views[i]
            cam = v.cam_params(ctx.device)
            leaves = [x.detach().requires_grad_(True) for x in p]
            xyz, dc, rest, scaling, rotation, opacity = leaves
            out = render(xyz, torch.exp(scaling), torch.nn.functional.normalize(rotation, dim=-1),
                         torch.where(alive, torch.sigmoid(opacity), torch.zeros_like(opacity)),
                         torch.cat([dc[:, None], rest], dim=1), cam, active_sh_degree=y["sh_degree"],
                         render_geo=True, config=y["raster"])
            inv = torch.as_tensor(v.invdepth, device=ctx.device)
            loss = (out["render"] - v.image).abs().mean() + (out["invdepth"] - inv).abs().mean()
            loss.backward()
    return sum(common.kernel_ms(cuda_blend, "launch_blend_bwd", run, 8))
