"""The post-optimizer cell's check: the plain reference works the compared
stretch out again from the program's state before it, and the numbers are
held to the cell's limits.

The reference (gsbench/reference/train/hier_trainer.py, plain PyTorch in
float32 with TF32 off, nothing of the program) takes the hierarchy's
topology from the benchmark's own arrays (the frozen builder's output) and
the parameters, Adam moments, step and exposure from the program's state
cloned before the stretch. For each of the three steps it selects the cut
of the same view at the same target size and budget, and runs the frozen
`hier_train_step` (plain preprocess, binning with an instance budget it
grows until nothing overflows, the plain blend and its closed-form
backward, autograd of the interpolation's gathers, masked sparse Adam and
the exposure's Adam) on the same view, learning rates and exposure row.

Numbers:
  * `cut`: the entries of the three cuts (indices, owning nodes,
    interpolation weights, child counts, validity, the cut's size) that
    differ from the reference's;
  * `terms`: the first step's loss, relative;
  * `grad`: the first step's gradient, as Adam's first moment holds it,
    each leaf's norm over the rows the cut renders (children) and over the
    rows that are only the parents of its interpolating slots (parents),
    at the worst of the twelve, each half's gaps over its own norms;
  * `change`: the change of each leaf and of the exposure over the three
    steps, at the worst of the seven;
  * `overflow`: the compared steps whose render overflowed its budget.
A norm's gap is taken over the reference's norm or the median one of its
group, whichever is larger (checks/train.py:leaf_gaps).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from gsbench.checks.common import ref_camera
from gsbench.checks.train import leaf_gaps
from gsbench.drivers.postopt import change_norms, grad_norms, row_masks
from gsbench.harness import Check, Context


def reference_state(fields: Dict, start, device):
    """The reference's post-opt state: the topology packed from the
    benchmark's arrays, the fields a step writes from the program's state
    `start`."""
    from gsbench.reference.hier.io import Hierarchy
    from gsbench.reference.model.adam import AdamState
    from gsbench.reference.model.gaussians import GaussianParams
    from gsbench.reference.train.hier_trainer import state_from_hierarchy

    ts = state_from_hierarchy(Hierarchy(**fields), num_images=int(start.exposure.shape[0]), device=device)
    opt = start.opt
    return ts._replace(params=GaussianParams(*(p.clone() for p in start.params)),
                       opt=AdamState(m=GaussianParams(*(x.clone() for x in opt.m)),
                                     v=GaussianParams(*(x.clone() for x in opt.v)), step=opt.step.clone()),
                       step=start.step.clone(), exposure=start.exposure.clone(),
                       exposure_m=start.exposure_m.clone(), exposure_v=start.exposure_v.clone())


def cut_gaps(prog, ref) -> int:
    """Entries of the program's cut that differ from the reference's."""
    return sum(int((a.reshape(-1) != b.reshape(-1)).sum()) if a.shape == b.shape else max(a.numel(), b.numel())
               for a, b in zip(prog, ref))


def reference_stretch(fields: Dict, views, prog: Dict, target: float, device) -> Dict:
    from gsbench.reference.model.schedules import LRConfig, lr_tree
    from gsbench.reference.raster.api import RasterConfig
    from gsbench.reference.train.hier_trainer import hier_train_step, select_cut

    dev = torch.device(device)
    ts = start = reference_state(fields, prog["start"], dev)
    out = dict(losses=[], cut_gaps=0, budgets=[])
    P = int(ts.params.xyz.shape[0])
    for k, st in enumerate(prog["stretch"]):
        v = views[st["view"]]
        cam = ref_camera(v.pose, dev)
        with torch.no_grad():
            cut = select_cut(ts, cam, target, st["budget"])
        out["cut_gaps"] += cut_gaps(prog["cuts"][k], cut) if k < len(prog["cuts"]) else cut.valid.numel()
        lrs = lr_tree(ts.step, LRConfig(), 1.0)
        budget = st["max_instances"]
        while True:
            raster = RasterConfig(backend="blend", tile=st["tile"], antialias=st["antialias"],
                                  depth_sort_bits=st["depth_sort_bits"], max_instances=budget)
            new, m = hier_train_step(ts, cut, cam, v.image, lrs, raster, image_idx=st["view"], use_exposure=True,
                                     optimize_exposure=True)
            if int(m["overflow"]) == 0:
                break
            budget *= 2
        out["budgets"].append(budget)
        out["losses"].append(float(m["loss"]))
        if k == 0:
            out["g_norms"] = grad_norms(ts.opt, new.opt, row_masks(cut, P)).tolist()
        ts = new
    out["dp_norms"] = change_norms(ts, start).tolist()
    return out


def compare(prog: Dict, ref: Dict, limits: Dict, note=None) -> List[Check]:
    """The cell's numbers, each beside its limit."""
    if prog.get("start") is None or prog.get("g_norms") is None or prog.get("dp_norms") is None \
            or len(prog["stretch"]) < 3 or any(s.get("loss") is None for s in prog["stretch"]):
        return [Check("stretch_read", 1.0, 0.0)]

    def finite(x):
        return float(x) if math.isfinite(x) else float("inf")
    terms = abs(prog["stretch"][0]["loss"] - ref["losses"][0]) / max(abs(ref["losses"][0]), 1e-30)
    # each half against its own norms: the parents' gradient is smaller than the children's by
    # orders, and the median of both would hide a fault in it
    grad = np.concatenate([leaf_gaps(prog["g_norms"][h:h + 6], ref["g_norms"][h:h + 6]) for h in (0, 6)])
    change = leaf_gaps(prog["dp_norms"], ref["dp_norms"])
    overflowed = [s["overflow"] for s in prog["stretch"]]
    if note is not None:
        names = [f"{who} {f}" for who in ("children", "parents") for f in
                 ("xyz", "sh_dc", "sh_rest", "scaling", "rotation", "opacity")]
        note("first gradient's gap: " + ", ".join(f"{n} {g:.3g}" for n, g in zip(names, grad)))
        note("first gradient's norms, the reference's: " + ", ".join(f"{n} {g:.6g}" for n, g in
                                                                        zip(names, ref["g_norms"])))
        note("change's gap: " + ", ".join(f"{n} {g:.3g}" for n, g in
                                          zip(("xyz", "sh_dc", "sh_rest", "scaling", "rotation", "opacity",
                                               "exposure"), change)))
        note(f"losses: program {[s['loss'] for s in prog['stretch']]}, reference {ref['losses']}; cut entries "
             f"apart {ref['cut_gaps']}; overflowed {overflowed}")
    return [
        Check("cut", float(ref["cut_gaps"]), limits["cut"]),
        Check("terms", finite(terms), limits["terms"]),
        Check("grad", finite(float(np.max(grad))), limits["grad"]),
        Check("change", finite(float(np.max(change))), limits["change"]),
        Check("overflow", float(sum(1 for o in overflowed if o is None or o > 0)), limits["overflow"]),
    ]


def check(ctx: Context, state: Dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog = state["readings"]
    if prog.get("start") is None or len(prog["stretch"]) < 3:
        ctx.checks = [Check("stretch_read", 1.0, 0.0)]
        return
    ref = reference_stretch(state["fields"], state["views"], prog, state["target"], ctx.device)
    state["reference"] = ref
    ctx.checks = compare(prog, ref, ctx.cell.traffic["limits"], ctx.note)
    for st, b in zip(prog["stretch"], ref["budgets"]):
        ctx.note(f"iteration {st['iteration']} view {st['view']}: the program's max_instances {st['max_instances']}, "
                 f"the reference's {b}")
    if ctx.trace and prog.get("yard") is not None:
        yardstick(ctx, state)


def yardstick(ctx: Context, state: Dict) -> None:
    """The traced run's readings of one profiled step (drawn from the
    seed): the step's counted work (gsbench/yardstick_postopt.py) beside
    its device span, the gathers' backward bytes beside its traced
    kernels, and the backward blend's bound beside its traced kernel."""
    from gsbench import yardstick as ys
    from gsbench import yardstick_postopt as yp
    from gsbench.checks import common
    from gsbench.reference.hier.interp import interpolate_cut
    from gsbench.reference.hier.io import Hierarchy
    from gsbench.reference.raster.binning import tile_grid
    from gsbench.reference.raster.preprocess import preprocess_plain
    from gsbench.reference.train.hier_trainer import hierarchy_to_arrays, select_cut, state_from_hierarchy

    y = state["readings"]["yard"]
    fields, views = state["fields"], state["views"]
    v = views[y["view"]]
    dev = ctx.device
    raster = y["raster"]
    ts = state_from_hierarchy(Hierarchy(**fields), num_images=1, device=dev)
    cam = ref_camera(v.pose, dev)
    with torch.no_grad():
        cut = select_cut(ts, cam, state["target"], y["budget"])
        P = int(ts.params.xyz.shape[0])
        ig = interpolate_cut(cut, *hierarchy_to_arrays(y["params"]))
        ty, tx = tile_grid(cam.height, cam.width, raster.tile)
        pre = preprocess_plain(*ig, cam, active_sh_degree=3, antialias=raster.antialias,
                               screen_bounds=(tx * raster.tile, ty * raster.tile))
        slots = yp.slot_counts(cut.render_indices, cut.parent_indices, cut.ts, cut.valid, pre.visible)
    b = common.ref_binning(tuple(ig), v.pose, raster, 3, dev)
    blend_bwd = common.bwd_bound(b)
    work = yp.step_work(P, slots, v.height, v.width, common.fwd_bound(b), blend_bwd)
    ctx.yardstick["step_bound_ms"] = work["bound_ms"]
    ctx.yardstick["step_ops"], ctx.yardstick["step_bytes"] = work["ops"], work["bytes"]
    ctx.yardstick["step_slots"] = slots
    readings = state["readings"]
    s = y["iteration"] - readings["profile_from"]
    steps = ctx.spans.get("profiled.step", [])
    if 0 <= s < len(steps):
        ctx.yardstick["step_device_ms"] = steps[s]
    bwd = yp.backward(slots)
    ctx.yardstick["interp_bwd_bytes"] = bwd["bytes"]
    ctx.yardstick["interp_bwd_bound_ms"] = bwd["bytes"] / ys.HBM_BYTES_S * 1e3
    n_steps = readings["profile_to"] - readings["profile_from"]
    traced = ctx.yardstick.get("trace_interp_bwd_ms") or []
    if traced and len(traced) % n_steps == 0:
        per = len(traced) // n_steps
        ctx.yardstick["interp_bwd_ms"] = sum(traced[s * per:(s + 1) * per])
    elif traced:
        ctx.yardstick["interp_bwd_ms"] = sum(traced) / n_steps
        ctx.note(f"interp_bwd: {len(traced)} traced launches over {n_steps} steps; the mean step's time taken")
    # one backward blend a step: kept for a listing of the cell under
    # blend_bwd_roofline, which reads these two keys
    ctx.yardstick["blend_bwd_bound_ms"] = blend_bwd["bound_ms"]
    traced = ctx.yardstick.get("trace_blend_bwd_ms") or []
    if len(traced) == ctx.yardstick.get("launched_blend_bwd") == n_steps:
        ctx.yardstick["blend_bwd_ms"] = traced[s]
    ctx.note(f"yardstick step {y['iteration']} view {y['view']}: {int(cut.valid.shape[0])} slots, {slots}; "
             f"interp_bwd launches {len(ctx.yardstick.get('trace_interp_bwd_ms') or [])}, blend_bwd launches "
             f"{len(traced)} traced, {ctx.yardstick.get('launched_blend_bwd')} counted")
