"""The LOD cells: one client in a closed loop through
`hidegs_tpu_torch.hier.interp.AdaptiveHierRenderer.from_hierarchy(...)
.render(cam, tau)` along a fly-through, at the traffic's pixel granularity
τ.

Set-up builds the served model of the configuration from the seed, and its
hierarchy with the benchmark's frozen copy of the native builder
(gsbench/scenes/hierarchy.py); the program receives it as the `Hierarchy`
of hier/io.py. The program's own builder is offline work, paid once, so
neither its time nor its output enters the cell. The warm-up renders a
sparse sample of the path, so that the budgets the path needs are
captured before the window.

A frame renders the pose and takes the image to the host as 8 bits: the
client clamps and quantises it on the device (x255, truncated, as the
viewers do) and copies the bytes. The program has no path that sends a
LOD frame to a client, so this readback is the harness's own. The harness
wraps, at run time, the renderer's count pass (`cut_size_packed`) to count
the frames that ran it; a frame whose binning still overflowed fails.
"""
from __future__ import annotations

import contextlib
import random
import time
from typing import Dict

import torch

from gsbench import trace
from gsbench.drivers import view
from gsbench.drivers.train import patched
from gsbench.harness import Context


def hierarchy_of(cfg: dict, seed: int, device):
    """(served model arrays, hierarchy fields) of the configuration."""
    from gsbench.scenes import hierarchy

    arrays = view.served_model(cfg, seed, device)
    means, scales, quats, opacities, shs = (a.cpu().numpy() for a in arrays)
    fields = hierarchy.build_hierarchy(means, quats, scales, opacities, shs)
    return arrays, fields


def run(ctx: Context, control: bool = False, fault: str = "") -> Dict:
    import functools

    from hidegs_tpu_torch.core.camera_math import make_camera
    from hidegs_tpu_torch.hier import interp
    from hidegs_tpu_torch.hier.io import Hierarchy

    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    tau = float(traffic["tau_px"])
    t0 = time.perf_counter()
    _, fields = hierarchy_of(cfg, ctx.seed, dev)
    ctx.note(f"set-up: the model and its hierarchy ({len(fields['nodes'])} nodes) made in "
             f"{time.perf_counter() - t0:.2f} s")
    poses = view.poses_of(cfg, traffic)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counts = {"count_pass": 0}
    orig_count = interp.cut_size_packed

    def counted(*args, **kwargs):
        counts["count_pass"] += 1
        return orig_count(*args, **kwargs)

    failed = torch.zeros((), dtype=torch.int64, device=dev)
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(interp, "cut_size_packed", counted))
        if control:
            stack.enter_context(patched(interp, "RasterConfig", functools.partial(interp.RasterConfig,
                                                                                  bf16_stream=True)))
        renderer = interp.AdaptiveHierRenderer.from_hierarchy(Hierarchy(**fields), dev)

        def frame(i, spans, name="frame"):
            p = poses[i]
            cam = make_camera(p.R, p.t, fx=p.fx, fy=p.fy, cx=p.cx, cy=p.cy, height=p.height, width=p.width,
                              device=dev)
            with spans.span(name), torch.no_grad():
                out = renderer.render(cam, tau)
                failed.add_((out["overflow"] > 0).to(torch.int64))
                img = torch.clamp(out["render"], 0, 1)
                if fault == "altered":
                    img = img.clone()
                    img[:, img.shape[1] // 2] = 1.0
                u8 = (img * 255).to(torch.uint8)
            return u8.permute(1, 2, 0).contiguous().cpu().numpy()

        warm = trace.EventSpans(False)
        for i in range(0, len(poses), traffic["warmup_stride"]):
            frame(i, warm)
        failed.zero_()
        captures0 = len(renderer.compiled.captures) if renderer.compiled is not None else 0
        counts["count_pass"] = 0
        rng = random.Random(ctx.seed)
        keep = {i: None for i in rng.sample(range(min(len(poses), traffic["check_within"])),
                                            traffic["check_frames"])}
        spans = trace.EventSpans(ctx.trace and dev.type == "cuda")
        profile = trace.Profile() if ctx.trace and dev.type == "cuda" else None
        loop = view.closed_loop(ctx, poses, frame, keep, spans, traffic["profile_frames"], profile)
        n_count = counts["count_pass"]
    n = loop["frames"]
    ctx.window_s = loop["window_s"] if loop["pre_profile_s"] is None else loop["pre_profile_s"]
    ctx.attempted = n
    ctx.failed = int(failed)
    ctx.e2e["lod_frames_per_s"] = n / loop["window_s"]
    ctx.e2e["lod_frame_ms_p95"] = view.percentile(loop["latencies"], 0.95) * 1e3
    ctx.counters["frames"] = n
    ctx.counters["count_pass_pct"] = 100.0 * n_count / max(n, 1)
    if renderer.compiled is not None:
        ctx.counters["captures_in_window"] = len(renderer.compiled.captures) - captures0
        if ctx.counters["captures_in_window"]:
            ctx.note(f"the renderer captured {ctx.counters['captures_in_window']} new budget keys in the window")
    if dev.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    if spans.enabled:
        ctx.spans.update(spans.read())
    yard_pose = None
    if profile is not None and profile.events is not None:
        ctx.profile = profile.summary()
        ctx.yardstick["trace_blend_fwd_ms"] = profile.launches("blend_fwd")
        ctx.yardstick["launched_blend_fwd"] = profile.launched.get("blend_fwd", 0)
        n_prof = traffic["profile_frames"]
        j = rng.randrange(n_prof)
        yard_pose = ((loop["k_profile"] + j) % len(poses), j, n_prof)
    return dict(fields=fields, poses=poses, keep=keep, tau=tau, renderer=renderer, yard_pose=yard_pose)


def check(ctx: Context, state: Dict) -> None:
    from gsbench.checks import lod as lod_check

    lod_check.check(ctx, state)
