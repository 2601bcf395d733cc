"""The LOD cells' check: the frames kept from the window against the plain
reference's LOD frame of the same poses, as 8-bit images.

The reference works the frame out again from the benchmark's hierarchy
(the arrays its own builder made, not the program's tensors): the cut at
the pose's target size with a budget that holds all of it (the frozen
`cut_size_packed` and `expand_packed` of hier/lod.py), the interpolation
(the frozen `interpolate_cut`) and the plain render, with an instance
budget that holds every instance; then the same clamp and quantisation.
Numbers: `frames_kept` and `share_over_1`, as the viewer cell's."""
from __future__ import annotations

import numpy as np
import torch

from gsbench import yardstick as ys
from gsbench.checks import common, view as view_check
from gsbench.harness import Check, Context


def reference_cut(fields, pose, tau: float, device):
    """(interpolated arrays, reference camera) of the LOD cut at `pose`."""
    from gsbench.reference.hier.interp import interpolate_cut
    from gsbench.reference.hier.lod import cut_size_packed, expand_packed, pack_hierarchy
    from gsbench.reference.raster.api import round_budget

    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    nodes, boxes = t(fields["nodes"]), t(fields["boxes"])
    means, scales, quats = t(fields["pos"]), torch.exp(t(fields["scale"])), t(fields["rot"])
    alphas, shs = t(fields["alpha"]), t(fields["shs"])
    cam = common.ref_camera(pose, device)
    ph = pack_hierarchy(nodes, boxes)
    if tau == 0:
        target = torch.zeros((), dtype=torch.float32, device=device)
    else:
        num = torch.full((), 2.0 * tau + 1.0, dtype=torch.float64, device=device)
        target = (num / cam.fx.to(torch.float64)).to(torch.float32)
    vp = cam.camera_center
    with torch.no_grad():
        n_cut = int(cut_size_packed(ph, target, vp))
        cut = expand_packed(ph, target, vp, budget=round_budget(max(n_cut, 1 << 10)), num_points=len(fields["pos"]))
        ig = interpolate_cut(cut, means, scales, quats, alphas, shs)
    return ig, cam, n_cut


def reference_image(fields, pose, tau: float, device) -> np.ndarray:
    from gsbench.reference.raster.api import RasterConfig, render

    ig, cam, _ = reference_cut(fields, pose, tau, device)
    budget = 1 << 22
    with torch.no_grad():
        while True:
            out = render(*ig, cam, config=RasterConfig(backend="blend", tile=32, depth_sort_bits=-1,
                                                       max_instances=budget))
            if int(out["overflow"]) == 0:
                break
            budget = 2 * int(out["num_instances"])
        u8 = (torch.clamp(out["render"], 0, 1) * 255).to(torch.uint8)
    return u8.permute(1, 2, 0).contiguous().cpu().numpy()


def check(ctx: Context, state) -> None:
    fields, poses, keep, tau = state["fields"], state["poses"], state["keep"], state["tau"]
    limits = ctx.cell.traffic["limits"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst, shares, missing = 0, [], 0
    for i, img in keep.items():
        if img is None:
            missing += 1
            continue
        m, s = view_check.gaps(img, reference_image(fields, poses[i], tau, ctx.device))
        worst, shares = max(worst, m), shares + [s]
    ctx.note(f"largest gap of a channel value over the kept frames: {worst} levels")
    ctx.checks = [Check("frames_kept", float(missing), limits["frames_kept"]),
                  Check("share_over_1", max(shares) if shares else float("inf"), limits["share_over_1"])]
    if ctx.trace and state.get("yard_pose") is not None:
        yardstick(ctx, state)


def yardstick(ctx: Context, state) -> None:
    """blend_fwd_roofline.lod and lod.frame_mfu_pct of one profiled LOD
    frame: the forward blend's bound from the reference's binning of the
    interpolated cut, over the kernel's time (the trace when it saw every
    launch the program counted, else timed alone on the eager frame)."""
    from hidegs_tpu_torch.core.camera_math import make_camera
    from hidegs_tpu_torch.raster import cuda_blend

    from gsbench.reference.raster.api import RasterConfig

    fields, poses, tau, renderer = state["fields"], state["poses"], state["tau"], state["renderer"]
    i, j, n = state["yard_pose"]
    ig, _, n_cut = reference_cut(fields, poses[i], tau, ctx.device)
    raster = RasterConfig(tile=32, depth_sort_bits=-1, max_instances=1 << 22)
    b = common.ref_binning(tuple(ig), poses[i], raster, 3, ctx.device)
    ctx.yardstick["blend_fwd_bound_ms"] = common.fwd_bound(b)["bound_ms"]
    traced = ctx.yardstick.get("trace_blend_fwd_ms") or []
    if len(traced) == ctx.yardstick.get("launched_blend_fwd") == n:
        ctx.yardstick["blend_fwd_ms"] = traced[j]
        ctx.yardstick["blend_fwd_source"] = "trace"
    else:
        p = poses[i]
        cam = make_camera(p.R, p.t, fx=p.fx, fy=p.fy, cx=p.cx, cy=p.cy, height=p.height, width=p.width,
                          device=ctx.device)
        renderer.compiled = None  # the eager frame, whose launches the launcher sees

        def run():
            with torch.no_grad():
                renderer.render(cam, tau)
        ms = common.kernel_ms(cuda_blend, "launch_blend_fwd", run, 7)
        ctx.yardstick["blend_fwd_ms"] = ms[-1]
        ctx.yardstick["blend_fwd_source"] = "alone"
        ctx.note(f"blend_fwd: the profiler saw {len(traced)} launches, the program counted "
                 f"{ctx.yardstick.get('launched_blend_fwd')} over {n} frames; timed alone")
    ctx.yardstick["frame_bound_ms"] = ys.bound_ms(ys.pre_fwd(n_cut)) + ctx.yardstick["blend_fwd_bound_ms"]
    frames = ctx.spans.get("profiled.frame", [])
    if j < len(frames):
        ctx.yardstick["frame_device_ms"] = frames[j]
