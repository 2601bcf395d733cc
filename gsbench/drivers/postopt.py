"""The post-optimizer cell: one call of
`hidegs_tpu_torch.train.hier_trainer.post_optimize(...)`, as the large-scene
pipeline's last stage runs it (exposure trained, the pipeline's instance
budget to start from), on the configuration's hierarchy and training views
at the traffic's pixel granularity τ.

Set-up builds the served model and its hierarchy from the seed with the
benchmark's frozen builder (drivers/lod.py:hierarchy_of), and the training
views with their ray-cast targets (scenes/training.py); the program
receives the `Hierarchy` of hier/io.py, the cameras and the images on the
device. The program draws its own views (its `random.Random(0)`).

The window is bounded from outside the program: the harness wraps, at run
time, the two calls of an iteration (`CompiledHierTrainStep.select` and
the step on a card; `select_cut` and `hier_train_step` off it). The
wrapper of the step counts iterations. The window opens (after a
synchronize) at the first iteration past the traffic's `warmup_iters` that
follows `settle_iters` iterations without a new capture: the budget
re-fits capture in the warm-up. The first step that starts after
`--seconds` closes it: a synchronize, then the harness's own exception,
which ends `post_optimize()`. `train_iter_ms` is the window over the
iterations started in it; an iteration whose render overflowed its
instance budget fails.

A program that still overflows its instance budget at the end of the
warm-up, as one that never re-fits does, cannot run this configuration:
the run stops there with an error and no result.

For the check, a stretch of three steps is kept: it starts at the first
iteration at least `stretch_after` into the window whose view sees at
least `stretch_min_interp` slots of its cut that interpolate (t < 1),
counted at set-up by `interpolating_in_frame`. Only those slots give the
parents a gradient, and the cut interpolates only in the far field: the
nadir views and the oblique ones that look off the scene see none, and
their parents' gradient is 0. Kept are the program's state before the
stretch (cloned), each step's view, cut (cloned), loss and budgets in
force, the first step's gradient norms, over the rows the cut renders
(children) and the rows that are only the parents of its interpolating
slots (parents), and the change of the parameters and the exposure over
the three steps (gsbench/checks/postopt.py).
"""
from __future__ import annotations

import contextlib
import random
import time
from typing import Dict, List

import torch

from gsbench import trace
from gsbench.drivers.lod import hierarchy_of
from gsbench.drivers.train import LEAVES, WindowClosed, clone_state, patched
from gsbench.harness import Context

STATE_FIELDS = ("params", "opt", "step", "exposure", "exposure_m", "exposure_v")
# the kernel of PyTorch's sorted accumulation, the backward of the
# interpolation's gathers (`attrs[ri]`, `attrs[pi]`)
INTERP_BWD_KERNEL = "indexing_backward_kernel"


def row_masks(cut, num_points: int):
    """(children, parents) (P,) bool: the rows the cut's valid slots render,
    and the rows that are only the parents of valid slots that interpolate
    (t < 1). A slot with t = 1 gives its parent no share, so its parent's
    gradient is 0 by construction, whatever the program does."""
    dev = cut.valid.device
    children = torch.zeros((num_points + 1,), dtype=torch.bool, device=dev)
    parents = torch.zeros((num_points + 1,), dtype=torch.bool, device=dev)
    children.index_put_((cut.render_indices.long(),), cut.valid)  # padding slots index row P
    interp = cut.valid & (cut.ts < 1)
    parents.index_put_((torch.where(interp, cut.parent_indices, num_points).long(),), interp)
    children, parents = children[:num_points], parents[:num_points]
    return children, parents & ~children


def grad_norms(opt0, opt1, masks) -> torch.Tensor:
    """(len(masks) x 6,) float64 norms of one step's gradient as Adam's
    first moments hold it (g = (m1 - 0.9 m0) / 0.1 on the rows the step
    updated), over each mask's rows, leaf by leaf."""
    upd = opt1.step != opt0.step
    out = []
    for mask in masks:
        rows = upd & mask
        for f in LEAVES:
            m0, m1 = getattr(opt0.m, f).double(), getattr(opt1.m, f).double()
            g = (m1 - 0.9 * m0) / 0.1
            out.append(torch.linalg.vector_norm(g * rows.reshape(rows.shape + (1,) * (g.ndim - 1))))
    return torch.stack(out)


def change_norms(ts, ts0) -> torch.Tensor:
    """(7,) float64 norms of each leaf's change and the exposure's."""
    out = [torch.linalg.vector_norm(getattr(ts.params, f).double() - getattr(ts0.params, f).double())
           for f in LEAVES]
    out.append(torch.linalg.vector_norm(ts.exposure.double() - ts0.exposure.double()))
    return torch.stack(out)


def start_state(ts):
    """The post-opt state with the fields a step writes cloned (the
    topology, which no step writes, shared)."""
    return ts._replace(**{f: clone_state(getattr(ts, f)) for f in STATE_FIELDS})


def clone_cut(cut):
    return type(cut)(*(x.detach().clone() for x in cut))


def alter_cut(cut) -> None:
    """Fault: one interpolation weight of the cut moved by 0.25, in place,
    where the cut is produced."""
    t0 = cut.ts[:1]
    t0.add_(torch.where(t0 > 0.5, -0.25, 0.25))


@contextlib.contextmanager
def no_parent_grad_fault(ht):
    """Fault: the parents' rows read detached in the interpolation (the
    parent gathers take a copy of the arrays that autograd does not reach)."""
    orig = ht.interpolate_cut

    def interp(cut, means3d, scales, quats, opacities, shs, skybox_count=0, attrs=None):
        P = means3d.shape[0]
        arrays = [torch.cat([a, a.detach()]) for a in (means3d, scales, quats, opacities, shs)]
        pi = torch.where(cut.valid, cut.parent_indices + P, cut.parent_indices)
        return orig(cut._replace(parent_indices=pi), *arrays, skybox_count=skybox_count)
    with patched(ht, "interpolate_cut", interp):
        yield


def interpolating_in_frame(fields: Dict, views, target: float, device) -> List[int]:
    """Per view, the slots of its whole cut (the reference's,
    gsbench/reference/hier/lod.py) that interpolate (t < 1) and whose
    gaussian's mean projects into the frame."""
    from gsbench.checks.common import ref_camera
    from gsbench.reference.hier.lod import expand_packed, pack_hierarchy

    dev = torch.device(device)
    with torch.no_grad():
        packed = pack_hierarchy(torch.as_tensor(fields["nodes"], device=dev),
                                torch.as_tensor(fields["boxes"], device=dev))
        pos = torch.as_tensor(fields["pos"], device=dev)
        P = int(pos.shape[0])
        out = []
        for v in views:
            cam = ref_camera(v.pose, dev)
            cut = expand_packed(packed, target, cam.camera_center, budget=P, num_points=P)
            xc = pos[torch.clamp(cut.render_indices.long(), max=P - 1)] @ cam.R.T + cam.t
            z = torch.clamp(xc[:, 2], min=1e-6)
            u, w = cam.fx * xc[:, 0] / z + cam.cx, cam.fy * xc[:, 1] / z + cam.cy
            inside = (xc[:, 2] > 0.01) & (u >= 0) & (u < cam.width) & (w >= 0) & (w < cam.height)
            out.append(int((cut.valid & (cut.ts < 1) & inside).sum()))
    return out


class Recorder:
    """The harness's hooks into one `post_optimize()` call."""

    def __init__(self, ctx: Context, traffic: dict, views, cams, interp_in_frame: List[int], fault: str = ""):
        self.ctx, self.traffic, self.dev, self.fault = ctx, traffic, ctx.device, fault
        self.view_of = {id(c): i for i, c in enumerate(cams)}  # the program passes the cameras it was given
        self.sees_interp = [n >= traffic["stretch_min_interp"] for n in interp_in_frame]
        self.open_it = None
        self.warmup, self.settle = traffic["warmup_iters"], traffic["settle_iters"]
        self.it = 0
        self.compiled = None  # the CompiledHierTrainStep, on a card
        self.captures, self.last_capture_it = 0, 0
        self.t_start = self.t_end = self.t_profile = None
        self.deadline = None
        self.in_window = 0
        self.failed = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.last_overflow = None
        self.spans = trace.EventSpans(ctx.trace and self.dev.type == "cuda")
        self.profile = trace.Profile() if ctx.trace and self.dev.type == "cuda" else None
        self.profile_from = self.profile_to = self.yard_iter = None
        self.yard_offset = random.Random(ctx.seed).randrange(traffic["profile_iters"])
        self.yard = None
        self.stretch_from = None
        self.start = None
        self.stretch: List[dict] = []
        self.cuts: List = []
        self.g_norms = self.dp_norms = None
        self.captured_at: List[tuple] = []
        self.budgets_at_open = self.budgets_at_close = None

    def _profiling(self, it: int) -> bool:
        return self.profile is not None and self.profile_from is not None and \
            self.profile_from <= it < self.profile_to

    def in_stretch(self, it: int) -> bool:
        return self.stretch_from is not None and self.stretch_from <= it < self.stretch_from + 3

    # -- the cut --------------------------------------------------------------
    def select_wrapper(self, select_fn):
        def call(ts, cam, target_size, budget):
            it = self.it + 1
            if self.stretch_from is None and self.open_it is not None and \
                    it >= self.open_it + self.traffic["stretch_after"] and self.sees_interp[self.view_of[id(cam)]]:
                self.stretch_from = it
                self.ctx.note(f"the compared steps are {it}-{it + 2}")
            name = ("warmup.select" if self.t_start is None else "profiled.select" if self._profiling(it)
                    else "select")
            with self.spans.span(name):
                cut = select_fn(ts, cam, target_size, budget)
                if self.fault == "altered_interp":
                    alter_cut(cut)
            if self.in_stretch(it):
                self.cuts.append(clone_cut(cut))
            return cut
        return call

    # -- the step -------------------------------------------------------------
    def overflow_of(self, metrics):
        c = metrics.get("counters")
        if c is not None:
            return c[0]
        counters = getattr(self.compiled, "counters", None)
        return None if not counters else counters["overflow"]

    def step_wrapper(self, step_fn):
        def call(ts, cut, cam, gt_image, lrs, raster_cfg, *args, **kwargs):
            self.it += 1
            it = self.it
            captures = len(self.compiled.captures) if self.compiled is not None else 0
            if captures != self.captures:
                self.captured_at += [(it - 1, c.get("kind"), c.get("max_instances"))
                                     for c in self.compiled.captures[self.captures:]]
                self.captures, self.last_capture_it = captures, it - 1
            if self.t_start is None and it > self.warmup and it - self.last_capture_it > self.settle:
                self.open(it, raster_cfg)
            profiling = self.profile is not None and (self.profile.active or it == self.profile_from)
            if self.deadline is not None and time.perf_counter() >= self.deadline and not profiling \
                    and not self.in_stretch(it):
                self.budgets_at_close = (raster_cfg.max_instances, raster_cfg.max_blocks, raster_cfg.max_visible)
                self.close()
                raise WindowClosed()
            stretch = self.in_stretch(it)
            if stretch:
                self.read_stretch(ts, cam, raster_cfg, cut, it)
            if self.profile is not None:
                if it == self.profile_from:
                    torch.cuda.synchronize(self.dev)
                    self.t_profile = time.perf_counter()
                    self.profile.start()
                if it == self.profile_to and self.profile.active:
                    self.profile.stop()
            if self.ctx.trace and it == self.yard_iter:
                self.keep_yardstick_step(ts, cam, raster_cfg, cut)
            name = ("warmup.step" if self.t_start is None else "profiled.step" if self._profiling(it) else "step")
            with self.spans.span(name):
                out, metrics = step_fn(ts, cut, cam, gt_image, lrs, raster_cfg, *args, **kwargs)
            ovf = self.overflow_of(metrics)
            if ovf is not None and self.t_start is not None:
                self.failed += (ovf > 0).to(torch.int64)
            self.last_overflow = ovf
            if stretch:
                k = it - self.stretch_from
                self.stretch[k]["loss"] = metrics["loss"].detach().clone()
                self.stretch[k]["overflow"] = None if ovf is None else ovf.detach().clone()
                if k == 2:
                    self.dp_norms = change_norms(out, self.start)
            if self.t_start is not None:
                self.in_window += 1
            return out, metrics
        return call

    def open(self, it: int, raster_cfg) -> None:
        self.warmup = it - 1
        self.open_it = it
        self.profile_from = it + self.traffic["profile_after"]
        self.profile_to = self.profile_from + self.traffic["profile_iters"]
        self.yard_iter = self.profile_from + self.yard_offset
        self.budgets_at_open = (raster_cfg.max_instances, raster_cfg.max_blocks, raster_cfg.max_visible)
        if self.last_overflow is not None and int(self.last_overflow) > 0:
            raise RuntimeError(f"the post-opt step of iteration {it - 1} overflowed its instance budget at the end "
                               "of the warm-up: the program does not re-fit its budgets, so it cannot run this cell")
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.t_start = time.perf_counter()
        self.ctx.setup_s = self.t_start - self.ctx.t_process
        self.deadline = self.t_start + self.ctx.seconds
        self.failed.zero_()
        self.ctx.note(f"the window opens at iteration {it} (budgets {self.budgets_at_open})")

    def read_stretch(self, ts, cam, raster_cfg, cut, it) -> None:
        k = it - self.stretch_from
        if k == 0:
            self.start = start_state(ts)
        if k == 1:
            # the input state of the second step is what the first handed back
            masks = row_masks(self.cuts[0], ts.params.xyz.shape[0])
            self.g_norms = grad_norms(self.start.opt, ts.opt, masks)
        self.stretch.append(dict(iteration=it, view=self.view_of[id(cam)],
                                 max_instances=raster_cfg.max_instances, tile=raster_cfg.tile,
                                 antialias=raster_cfg.antialias, depth_sort_bits=raster_cfg.depth_sort_bits,
                                 budget=int(cut.valid.shape[0])))

    def keep_yardstick_step(self, ts, cam, raster_cfg, cut) -> None:
        self.yard = dict(iteration=self.it, view=self.view_of[id(cam)], raster=raster_cfg,
                         budget=int(cut.valid.shape[0]),
                         params=type(ts.params)(*(p.detach().clone() for p in ts.params)))

    def close(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.t_end = time.perf_counter()
        if self.profile is not None and self.profile.active:
            self.profile.stop()

    def readings(self) -> Dict:
        def listed(x):
            return None if x is None else x.tolist()
        stretch = [dict(s, loss=None if s.get("loss") is None else float(s["loss"]),
                        overflow=None if s.get("overflow") is None else int(s["overflow"])) for s in self.stretch]
        return dict(start=self.start, stretch=stretch, cuts=self.cuts, g_norms=listed(self.g_norms),
                    dp_norms=listed(self.dp_norms), yard=self.yard, profile_from=self.profile_from,
                    profile_to=self.profile_to)


def run(ctx: Context, control: bool = False, fault: str = "") -> Dict:
    from hidegs_tpu_torch.hier.io import Hierarchy
    from hidegs_tpu_torch.hier.lod import tau_to_target_size
    from hidegs_tpu_torch.raster.api import RasterConfig
    from hidegs_tpu_torch.train import hier_trainer as ht

    from gsbench.scenes import training

    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    target = tau_to_target_size(traffic["tau_px"], cfg["focal_px"])
    t0 = time.perf_counter()
    _, fields = hierarchy_of(cfg, ctx.seed, dev)
    t1 = time.perf_counter()
    scene = training.build(cfg, ctx.seed, dev)
    views = scene.train_cameras.views
    cams = [v.cam_params(dev) for v in views]
    images = [v.image for v in views]
    t2 = time.perf_counter()
    ctx.note(f"set-up: the hierarchy ({len(fields['nodes'])} nodes) made in {t1 - t0:.2f} s, the {len(views)} "
             f"training views in {t2 - t1:.2f} s")
    interp_in_frame = interpolating_in_frame(fields, views, target, dev)
    ctx.note(f"set-up: each view's interpolating slots in the frame, counted in {time.perf_counter() - t2:.2f} s: "
             f"{interp_in_frame}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)  # the peak of the program's work, not the inputs' making
    rec = Recorder(ctx, traffic, views, cams, interp_in_frame, fault=fault)
    factory = ht.CompiledHierTrainStep

    class Wrapped:
        """The compiled step with the harness's wrappers on its two calls."""

        def __init__(self):
            self.inner = rec.compiled = factory()
            self.select = rec.select_wrapper(self.inner.select)
            self._call = rec.step_wrapper(self.inner)

        def __call__(self, *args, **kwargs):
            return self._call(*args, **kwargs)

    rcfg = RasterConfig(backend="blend", max_instances=traffic["start_max_instances"], bf16_stream=control)
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(ht, "CompiledHierTrainStep", Wrapped))
        stack.enter_context(patched(ht, "select_cut", rec.select_wrapper(ht.select_cut)))
        stack.enter_context(patched(ht, "hier_train_step", rec.step_wrapper(ht.hier_train_step)))
        if fault == "no_parent_grad":
            stack.enter_context(no_parent_grad_fault(ht))
        try:
            ht.post_optimize(Hierarchy(**fields), cams, images, iterations=traffic["iterations"],
                             target_size=target, budget=traffic.get("budget"), raster_cfg=rcfg,
                             log_every=traffic["log_every"], optimize_exposure=traffic["optimize_exposure"],
                             device=dev)
            raise RuntimeError(f"post_optimize() ended at iteration {rec.it} before the window closed")
        except WindowClosed:
            pass
    n = rec.in_window
    if rec.t_end is not None and n:
        ctx.window_s = rec.t_end - rec.t_start
        ctx.e2e["train_iter_ms"] = ctx.window_s / n * 1e3
        if rec.t_profile is not None:
            # the traced run's layer metrics read the window up to the profiler's start
            ctx.window_s = rec.t_profile - rec.t_start
        ctx.attempted = n
        ctx.failed = int(rec.failed)
    in_window = [c for c in rec.captured_at if rec.t_start is not None and c[0] > rec.warmup]
    ctx.counters["captures_in_window"] = len(in_window)
    ctx.note(f"captures (iteration, kind, max_instances): {rec.captured_at}; in the window {len(in_window)}; "
             f"budgets at the window's close {rec.budgets_at_close}")
    if dev.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    if rec.spans.enabled:
        ctx.spans.update(rec.spans.read())
    if rec.profile is not None and rec.profile.events is not None:
        ctx.profile = rec.profile.summary()
        ctx.counters["profiled_steps"] = traffic["profile_iters"]
        ctx.yardstick["trace_interp_bwd_ms"] = rec.profile.launches(INTERP_BWD_KERNEL)
        ctx.yardstick["trace_blend_bwd_ms"] = rec.profile.launches("blend_bwd")
        ctx.yardstick["launched_blend_bwd"] = rec.profile.launched.get("blend_bwd", 0)
    readings = rec.readings()
    del rec
    return dict(fields=fields, views=views, readings=readings, target=target)


def check(ctx: Context, state: Dict) -> None:
    from gsbench.checks import postopt as postopt_check

    postopt_check.check(ctx, state)
