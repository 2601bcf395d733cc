"""Shared by the checks and the traced runs' yardstick: the reference's
render and binning of a pose, the counts a kernel's bound is taken from,
and a kernel timed alone on inputs captured from the program."""
from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional

import torch

from gsbench import yardstick as ys


def ref_camera(pose, device):
    from gsbench.reference.core.camera_math import make_camera

    return make_camera(pose.R, pose.t, fx=pose.fx, fy=pose.fy, cx=pose.cx, cy=pose.cy, height=pose.height,
                       width=pose.width, device=device)


def ref_config(raster, max_instances: Optional[int] = None):
    """The reference's RasterConfig with the program's settings' values."""
    from gsbench.reference.raster.api import RasterConfig

    return RasterConfig(tile=raster.tile, max_instances=max_instances or raster.max_instances, backend="blend",
                        antialias=raster.antialias, depth_sort_bits=raster.depth_sort_bits)


def ref_binning(arrays, pose, raster, sh_degree: int, device, render_geo: bool = False) -> Dict:
    """The reference's preprocess and binning of `arrays` (means3d, linear
    scales, quats, opacities, shs) in `pose`, with an instance budget that
    holds every instance; and the counts of its blend."""
    from gsbench.reference.raster.binning import bin_gaussians, tile_grid
    from gsbench.reference.raster.blend_plain import pair_counts
    from gsbench.reference.raster.preprocess import preprocess_plain

    cam = ref_camera(pose, device)
    tile = raster.tile
    ty, tx = tile_grid(cam.height, cam.width, tile)
    with torch.no_grad():
        pre = preprocess_plain(*arrays, cam, active_sh_degree=sh_degree, render_geo=render_geo,
                               antialias=raster.antialias, screen_bounds=(tx * tile, ty * tile))
        budget = raster.max_instances
        while True:
            tb = bin_gaussians(pre, ty, tx, budget, tile, depth_bits=raster.depth_sort_bits)
            if int(tb.overflow) == 0:
                break
            budget = 2 * int(tb.num_instances)
        post_cull = int(tb.tile_count.sum())
        unique_rows = int(torch.unique(tb.gauss_id[:post_cull]).numel())
        counts = pair_counts(pre, tb, tx, tile, 0)
    return dict(post_cull=post_cull, unique_rows=unique_rows, instances=int(tb.num_instances), counts=counts,
                n_tiles=ty * tx, tile=tile, visible=int(pre.visible.sum()))


def fwd_bound(b: Dict) -> Dict:
    return ys.blend_bound(ys.fwd_blend_bytes(b["post_cull"], b["unique_rows"], b["n_tiles"], b["tile"]), b["counts"],
                          b["tile"], ys.OPS_PER_LIVE_PAIR, ys.OPS_PER_KEPT_PAIR, ys.SFU_PER_KEPT_PAIR)


def bwd_bound(b: Dict) -> Dict:
    return ys.blend_bound(ys.bwd_blend_bytes(b["post_cull"], b["unique_rows"], b["n_tiles"], b["tile"],
                                             b["instances"]), b["counts"], b["tile"], ys.BWD_OPS_PER_LIVE_PAIR,
                          ys.BWD_OPS_PER_KEPT_PAIR, ys.BWD_SFU_PER_KEPT_PAIR)


def capture_launches(module, name: str, run: Callable[[], None]) -> List[list]:
    """The arguments (tensors cloned) of every call of module.<name> that
    `run()` makes."""
    from gsbench.drivers.train import patched

    orig = getattr(module, name)
    seen = []

    def wrap(*args):
        seen.append([a.clone() if isinstance(a, torch.Tensor) else a for a in args])
        return orig(*args)
    with patched(module, name, wrap):
        run()
    torch.cuda.synchronize()
    return seen


def time_alone_ms(launch: Callable[[], None], zero: Callable[[], None], warmup: int = 2, iters: int = 10) -> float:
    """Median ms of one launch between two CUDA events, its outputs zeroed
    before each (outside the events)."""
    for _ in range(warmup):
        zero()
        launch()
    times = []
    for _ in range(iters):
        zero()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        launch()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(module, name: str, run: Callable[[], None], zeroed: int) -> List[float]:
    """Each launch of module.<name> that `run()` makes, timed alone on its
    captured inputs (argument `zeroed` is the output the launcher needs
    zeroed): a list of ms, one per launch."""
    out = []
    for args in capture_launches(module, name, run):
        fn = getattr(module, name)
        out.append(time_alone_ms(lambda: fn(*args), args[zeroed].zero_))
    return out
