"""The viewer cell: one client in a closed loop through the viewers' render
path, `hidegs_tpu_torch.viewer.__main__.make_render_fn`, with the viewer's
`max_instances` flag set from the cell's traffic.

Each frame builds its camera on the device as a viewer's request does,
renders (on a card a replay of the serving render's CUDA graph), and takes
the image to the host as the 8-bit bytes a viewer sends
(`viewer.network_gui.image_bytes`). A frame's latency runs from the call
to those bytes on the host. The poses cycle through the traffic's path.
The warm-up renders every pose once. The harness wraps, at run time, the
`serving_render` the viewer calls, to count the frames whose binning
overflowed (failed frames).

For the check, the frames of a few poses drawn from the seed keep their
8-bit images; once the window has closed the plain reference renders the
same poses and the images are compared (gsbench/checks/view.py).
"""
from __future__ import annotations

import contextlib
import random
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from gsbench import trace
from gsbench.drivers.train import patched
from gsbench.harness import Context
from gsbench.scenes import flight, uav


def poses_of(cfg: dict, traffic: dict) -> List[flight.Pose]:
    p = traffic["path"]
    if p["kind"] == "orbit":
        return flight.orbit(p["poses"], p["radius"], p["altitude"], p["pitch_lo"], p["pitch_hi"], traffic["width"],
                            traffic["height"], traffic["focal_px"])
    return flight.fly_through(p["poses"], p["period"], cfg["extent_xy"], p["margin"], p["altitude"], p["pitch_lo"],
                              p["pitch_hi"], traffic["width"], traffic["height"], traffic["focal_px"])


def served_model(cfg: dict, seed: int, device):
    return uav.make_uav_gaussians(seed, device, n_ground=cfg["n_ground"], n_structs=cfg["n_structs"],
                                  per_struct=cfg["per_struct"], extent_xy=cfg["extent_xy"],
                                  layout_seed=cfg["layout_seed"])


def percentile(values: List[float], q: float) -> float:
    """The q-quantile by statistics.quantiles' inclusive rule."""
    if len(values) < 2:
        return values[0] if values else float("nan")
    return statistics.quantiles(values, n=100, method="inclusive")[int(round(q * 100)) - 1]


def closed_loop(ctx: Context, poses, frame, keep: Dict[int, np.ndarray], spans: "trace.EventSpans",
                n_profiled: int, profile) -> Dict:
    """Frames in a closed loop until the window closes: `frame(k)` renders
    pose k and returns the 8-bit image on the host. A traced run profiles
    `n_profiled` frames from the middle of the window on, and its layer
    metrics read the window up to there."""
    lat = []
    k = 0
    k_profile = None
    t_profile = None
    dev = ctx.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_start = time.perf_counter()
    ctx.setup_s = t_start - ctx.t_process
    deadline = t_start + ctx.seconds
    while True:
        t0 = time.perf_counter()
        if profile is not None:
            if k_profile is None and t0 >= t_start + 0.5 * ctx.seconds:
                torch.cuda.synchronize(dev)
                k_profile, t_profile = k, time.perf_counter()
                profile.start()
                t0 = time.perf_counter()
            elif k_profile is not None and k == k_profile + n_profiled and profile.active:
                profile.stop()
                t0 = time.perf_counter()
        if t0 >= deadline and not (profile is not None and profile.active):
            break
        i = k % len(poses)
        profiling = profile is not None and profile.active
        name = "profiled.frame" if profiling else "frame" if k_profile is None else "after.frame"
        with trace.host_range("frame") if profiling else contextlib.nullcontext():
            img = frame(i, spans, name)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if i in keep and keep[i] is None:
            keep[i] = img
        k += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    if profile is not None and profile.active:
        profile.stop()
    return dict(latencies=lat, window_s=t_end - t_start, frames=k, k_profile=k_profile,
                pre_profile_s=None if t_profile is None else t_profile - t_start)


def run(ctx: Context, control: bool = False, fault: str = "") -> Dict:
    from hidegs_tpu_torch.config import port_backend
    from hidegs_tpu_torch.core.camera_math import make_camera
    from hidegs_tpu_torch.raster.api import RasterConfig
    from hidegs_tpu_torch.viewer import __main__ as viewer
    from hidegs_tpu_torch.viewer.network_gui import image_bytes

    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    arrays = served_model(cfg, ctx.seed, dev)
    poses = poses_of(cfg, traffic)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rcfg = RasterConfig(backend=port_backend("jnp"), max_instances=traffic["max_instances"], bf16_stream=control)
    overflowed = torch.zeros((), dtype=torch.int64, device=dev)
    orig_serving = viewer.serving_render

    def serving_render(device, config):
        fn = orig_serving(device, config)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            overflowed.add_((out["overflow"] > 0).to(torch.int64))
            if fault == "altered":
                out = dict(out)
                out["render"] = out["render"].clone()
                out["render"][:, out["render"].shape[1] // 2] = 1.0
            return out
        return call

    with patched(viewer, "serving_render", serving_render):
        render_fn = viewer.make_render_fn(arrays, rcfg)

    def frame(i, spans, name="frame"):
        p = poses[i]
        cam = make_camera(p.R, p.t, fx=p.fx, fy=p.fy, cx=p.cx, cy=p.cy, height=p.height, width=p.width, device=dev)
        with spans.span(name):
            img = render_fn(cam)
        return image_bytes(img)

    warm = trace.EventSpans(False)
    for i in range(traffic["warmup_frames"]):
        frame(i, warm)
    overflowed.zero_()
    rng = random.Random(ctx.seed)
    # the first frame of each pose drawn here falls in the window's first
    # `check_within` frames
    keep = {i: None for i in rng.sample(range(min(len(poses), traffic["check_within"])), traffic["check_frames"])}
    spans = trace.EventSpans(ctx.trace and dev.type == "cuda")
    profile = trace.Profile() if ctx.trace and dev.type == "cuda" else None
    loop = closed_loop(ctx, poses, frame, keep, spans, traffic["profile_frames"], profile)
    n = loop["frames"]
    ctx.window_s = loop["window_s"] if loop["pre_profile_s"] is None else loop["pre_profile_s"]
    ctx.attempted = n
    ctx.failed = int(overflowed)
    ctx.e2e["frames_per_s"] = n / loop["window_s"]
    ctx.e2e["frame_ms_p95"] = percentile(loop["latencies"], 0.95) * 1e3
    ctx.counters["frames"] = n
    if dev.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    if spans.enabled:
        ctx.spans.update(spans.read())
    yard_pose = None
    if profile is not None and profile.events is not None:
        ctx.profile = profile.summary()
        launches = profile.launches("blend_fwd")
        ctx.yardstick["trace_blend_fwd_ms"] = launches
        ctx.yardstick["launched_blend_fwd"] = profile.launched.get("blend_fwd", 0)
        n_prof = traffic["profile_frames"]
        j = rng.randrange(n_prof)
        yard_pose = ((loop["k_profile"] + j) % len(poses), j, n_prof)
    return dict(arrays=arrays, poses=poses, keep=keep, rcfg=rcfg, yard_pose=yard_pose)


def check(ctx: Context, state: Dict) -> None:
    from gsbench.checks import view as view_check

    view_check.check(ctx, state)
