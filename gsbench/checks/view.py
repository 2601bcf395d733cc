"""The viewer cell's check: the frames kept from the window against the
plain reference's render of the same poses, as 8-bit images.

The reference renders the seed's served model with the frozen plain
preprocess, binning and blend (gsbench/reference/raster/api.py, its own
instance budget, which holds every instance), clamps and quantises as the
viewer does (clip to [0, 1], x255, truncated). Numbers, over the kept
frames:
  * `share_over_1`: the share of channel values that differ by more than
    one level (a level is what float rounding can flip at a boundary);
  * `frames_kept`: kept poses with no frame in the window (0 when each
    chosen pose was rendered).
The largest gap of one channel value, in levels, is printed beside them
and not compared: sound runs read 1 and the control 2 to 6, too close to
hold apart (PERF.md)."""
from __future__ import annotations

import numpy as np
import torch

from gsbench import yardstick as ys
from gsbench.checks import common
from gsbench.harness import Check, Context


def reference_image(arrays, pose, raster, device) -> np.ndarray:
    """The plain reference's 8-bit (H, W, 3) image of `pose`."""
    from gsbench.reference.raster.api import render

    cam = common.ref_camera(pose, device)
    budget = raster.max_instances
    with torch.no_grad():
        while True:
            out = render(*arrays, cam, config=common.ref_config(raster, budget))
            if int(out["overflow"]) == 0:
                break
            budget = 2 * int(out["num_instances"])
        img = torch.clamp(out["render"], 0, 1)
    arr = (np.clip(img.to("cpu", torch.float32).numpy(), 0, 1) * 255).astype(np.uint8)
    return np.ascontiguousarray(arr.transpose(1, 2, 0))


def gaps(got: np.ndarray, want: np.ndarray):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), float((d > 1).mean())


def check(ctx: Context, state) -> None:
    arrays, poses, keep, rcfg = state["arrays"], state["poses"], state["keep"], state["rcfg"]
    limits = ctx.cell.traffic["limits"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst_max, shares, missing = 0, [], 0
    for i, img in keep.items():
        if img is None:
            missing += 1
            continue
        m, s = gaps(img, reference_image(arrays, poses[i], rcfg, ctx.device))
        worst_max = max(worst_max, m)
        shares.append(s)
    ctx.note(f"largest gap of a channel value over the kept frames: {worst_max} levels")
    ctx.checks = [Check("frames_kept", float(missing), limits["frames_kept"]),
                  Check("share_over_1", max(shares) if shares else float("inf"), limits["share_over_1"])]
    if ctx.trace and state.get("yard_pose") is not None:
        yardstick(ctx, state)


def yardstick(ctx: Context, state) -> None:
    """blend_fwd_roofline.view's reading: the bound of one profiled frame's
    forward blend over the kernel's time, from the trace when the profiler
    saw every launch the program counted, else timed alone."""
    from hidegs_tpu_torch.raster import cuda_blend
    from hidegs_tpu_torch.raster.api import render
    from hidegs_tpu_torch.core.camera_math import make_camera

    arrays, poses, rcfg = state["arrays"], state["poses"], state["rcfg"]
    i, j, n = state["yard_pose"]
    b = common.ref_binning(arrays, poses[i], rcfg, 3, ctx.device)
    ctx.yardstick["blend_fwd_bound_ms"] = common.fwd_bound(b)["bound_ms"]
    traced = ctx.yardstick.get("trace_blend_fwd_ms") or []
    if len(traced) == ctx.yardstick.get("launched_blend_fwd") == n:
        ctx.yardstick["blend_fwd_ms"] = traced[j]
        ctx.yardstick["blend_fwd_source"] = "trace"
    else:
        p = poses[i]
        cam = make_camera(p.R, p.t, fx=p.fx, fy=p.fy, cx=p.cx, cy=p.cy, height=p.height, width=p.width,
                          device=ctx.device)

        def run():
            with torch.no_grad():
                render(*arrays, cam, config=rcfg)
        ctx.yardstick["blend_fwd_ms"] = sum(common.kernel_ms(cuda_blend, "launch_blend_fwd", run, 7))
        ctx.yardstick["blend_fwd_source"] = "alone"
        ctx.note(f"blend_fwd: the profiler saw {len(traced)} launches, the program counted "
                 f"{ctx.yardstick.get('launched_blend_fwd')} over {n} frames; timed alone")
    ctx.yardstick["frame_bound_ms"] = ys.bound_ms(ys.pre_fwd(arrays[0].shape[0])) + ctx.yardstick["blend_fwd_bound_ms"]
    frames = ctx.spans.get("profiled.frame", [])
    if j < len(frames):
        ctx.yardstick["frame_device_ms"] = frames[j]
