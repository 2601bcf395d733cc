"""The trainer cell: `hidegs_tpu_torch.train.trainer.train(scene=...)` on
the in-memory training scene, with the program's default flags and the
configuration's schedule.

The window is bounded from outside the trainer: the harness wraps, at run
time, the train step the trainer builds (`CompiledTrainStep` on a card,
`train_step` off it), the schedule hook and the state's initialisation.
The wrapper counts iterations. The window opens (after a synchronize) at
the first iteration past the traffic's `warmup_iters` that follows
`settle_iters` iterations without a new capture of the step: the
trainer's budget re-fits (visible-row compaction and its regrowth) capture
in the warm-up, not in the window. The first iteration that starts after
`--seconds` closes it: a synchronize, then the harness's own exception,
which ends `train()`. `train_iter_ms` is the window over the iterations
started in it.

The same wrappers keep what the correctness check reads of the window's
own steps. When the window opens, the compared stretch is fixed: the
three steps that lead into the first densify round at least two
iterations later (iterations 598-600 and the round at 600 in the cell).
Before its first step the program's whole train state is cloned (the
reference starts from it); the stretch records each step's views,
sources, budgets and loss terms, the first step's gradient as Adam's
first moment holds it, the parameters' change over the three steps, the
program's state before the round (cloned) and the round's outcome (the
alive count and the alive rows' norms). Once the window has closed the
reference follows the same three steps, and runs the round on its own from
the program's state before it (gsbench/checks/train.py). The initial
parameters are read before step 1, so that the check also holds the start.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from typing import Dict, List

import torch

from gsbench import trace
from gsbench.harness import Context

LEAVES = ("xyz", "sh_dc", "sh_rest", "scaling", "rotation", "opacity")
TERMS = ("photo", "depth_l1", "freq", "single_view", "mv_ncc", "mv_geo", "total")


class WindowClosed(Exception):
    """Raised from inside the trainer's loop when the window has closed."""


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def leaf_norms(params) -> torch.Tensor:
    """(6,) float64 norms of the parameter leaves."""
    return torch.stack([torch.linalg.vector_norm(getattr(params, f).double()) for f in LEAVES])


def clone_state(x):
    """A deep copy of a train state: tensors cloned, generators forked."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, torch.Generator):
        g = torch.Generator(device=x.device)
        g.set_state(x.get_state())
        return g
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_state(v) for v in x))
    return x


def grad_norms(opt0, opt1) -> torch.Tensor:
    """(6,) float64 norms of one step's gradient as Adam's first moments
    hold it: on the rows the step updated (their step count moved)
    g = (m1 - 0.9 m0) / 0.1, elsewhere 0."""
    upd = opt1.step != opt0.step
    out = []
    for f in LEAVES:
        m0, m1 = getattr(opt0.m, f).double(), getattr(opt1.m, f).double()
        g = (m1 - 0.9 * m0) / 0.1
        out.append(torch.linalg.vector_norm(g * upd.reshape(upd.shape + (1,) * (g.ndim - 1))))
    return torch.stack(out)


def change_norms(params, params0) -> torch.Tensor:
    """(6,) float64 norms of each leaf's change from `params0`."""
    return torch.stack([torch.linalg.vector_norm(getattr(params, f).double() - getattr(params0, f).double())
                        for f in LEAVES])


def alive_norms(g) -> torch.Tensor:
    """(7,) float64: the alive count, then the alive rows' norm of each leaf."""
    a = g.alive
    out = [a.sum().double()]
    for f in LEAVES:
        p = getattr(g.params, f).double()
        out.append(torch.linalg.vector_norm(p * a.reshape(a.shape + (1,) * (p.ndim - 1))))
    return torch.stack(out)


def alter_round(ts) -> None:
    """Fault: the round's outcome altered where it is produced, in place:
    the first alive row moved by one unit along x."""
    g = ts.gaussians
    i = int(torch.nonzero(g.alive)[0, 0])
    g.params.xyz[i, 0] += 1.0


def round_after(open_it: int, cfg: dict) -> int:
    """The densify round the compared steps lead into: the first at least
    two iterations after `open_it`, the window's first."""
    d = cfg["densification_interval"]
    r = max(cfg["densify_from_iter"], open_it + 2)
    r = -(-r // d) * d
    if r > cfg["densify_until_iter"]:
        raise ValueError(f"no densify round after iteration {open_it}")
    return r


def opt_config(cfg: dict):
    from hidegs_tpu_torch.config import OptimizationConfig

    keys = ("iterations", "densify_from_iter", "densify_until_iter", "densification_interval",
            "opacity_reset_interval", "depth_from_iter", "single_view_weight_from_iter",
            "multi_view_weight_from_iter", "max_all_points", "freq_warmup_iterations")
    return OptimizationConfig(**{k: cfg[k] for k in keys})


class Recorder:
    """The harness's hooks into one `train()` call."""

    def __init__(self, ctx: Context, cfg: dict, traffic: dict, scene, control: bool = False, fault: str = "",
                 keep_batches: bool = False):
        self.ctx, self.cfg, self.traffic, self.scene = ctx, cfg, traffic, scene
        self.dev = ctx.device
        self.control, self.fault = control, fault
        self.warmup = traffic["warmup_iters"]
        self.it = 0
        self.t_start = self.t_end = self.t_profile = None
        self.pre_profile_steps = 0
        self.deadline = None
        self.spans = trace.EventSpans(ctx.trace and self.dev.type == "cuda")
        self.profile = trace.Profile() if ctx.trace and self.dev.type == "cuda" else None
        # the window opens at the first iteration past `warmup_iters` that
        # follows `settle_iters` iterations without a new capture of the step
        self.settle = traffic["settle_iters"]
        self.compiled = None  # the CompiledTrainStep, on a card
        self.captures, self.last_capture_it = 0, 0
        self.yard_offset = random.Random(ctx.seed).randrange(traffic["profile_iters"])
        self.profile_from = self.profile_to = self.yard_iter = None
        self.yard = None  # the pre-step rows and views of the step the yardstick counts
        self.step_ok = torch.zeros((), dtype=torch.float64, device=self.dev)
        self.in_window_steps = 0
        self.rounds_in_window = 0
        self.image_ids = {v.image.data_ptr(): i for i, v in enumerate(scene.train_cameras.views)}
        self.gray_ids = {v.gray.data_ptr(): i for i, v in enumerate(scene.train_cameras.views)}
        # the correctness readings: the initial parameters, and the stretch
        # of three window steps that ends in the densify round `round_at`
        self.p0_norms = None
        self.round_at = None
        self.start = None  # the program's state before the stretch's first step
        self.pre_round = None  # the program's state before the round `round_at`
        self.stretch: List[dict] = []
        self.terms: List[dict] = []
        self.g_norms = self.dp_norms = self.after_round = None
        self.keep_batches = keep_batches  # the readings tool runs the stretch again from `start`
        self.batches: List[tuple] = []
        self.round_args = None

    # -- the state's initialisation --------------------------------------------
    def init_wrapper(self, orig):
        deg = self.cfg["initial_sh_degree"]

        def init(*args, **kwargs):
            state = orig(*args, **kwargs)
            return state._replace(active_sh_degree=torch.full_like(state.active_sh_degree, deg))
        return init

    def config_wrapper(self, orig):
        def make(*args, **kwargs):
            tcfg = orig(*args, **kwargs)
            if self.control:
                tcfg = dataclasses.replace(tcfg, raster=dataclasses.replace(tcfg.raster, bf16_stream=True))
            return tcfg
        return make

    # -- the step ---------------------------------------------------------------
    def in_stretch(self, it: int) -> bool:
        return self.round_at is not None and self.round_at - 2 <= it <= self.round_at

    def step_wrapper(self, step_fn):
        def call(ts, batch, tcfg, *args, **kwargs):
            self.it += 1
            it = self.it
            captures = len(self.compiled.captures) if self.compiled is not None else 0
            if captures != self.captures:
                self.captures, self.last_capture_it = captures, it
            if self.t_start is None and it > self.warmup and it - self.last_capture_it > self.settle:
                self.warmup = it - 1
                self.profile_from = it + self.traffic["profile_after"]
                self.profile_to = self.profile_from + self.traffic["profile_iters"]
                self.yard_iter = self.profile_from + self.yard_offset
                self.round_at = round_after(it, self.cfg)
                if self.dev.type == "cuda":
                    torch.cuda.synchronize(self.dev)
                self.t_start = time.perf_counter()
                self.ctx.setup_s = self.t_start - self.ctx.t_process
                self.deadline = self.t_start + self.ctx.seconds
                self.ctx.note(f"the window opens at iteration {it}; the compared steps end in the round at "
                              f"{self.round_at}")
            profiling = self.profile is not None and (self.profile.active or it == self.profile_from)
            compared = self.round_at is not None and it <= self.round_at
            if self.deadline is not None and time.perf_counter() >= self.deadline and not profiling \
                    and not compared:
                self.close()
                raise WindowClosed()
            if it == 1:
                self.ctx.note(f"set-up: the first step starts {time.perf_counter() - self.ctx.t_process:.2f} s "
                              "after the process started")
                self.p0_norms = leaf_norms(ts.gaussians.params)
            stretch = self.in_stretch(it)
            if stretch:
                self.read_stretch(ts, batch, tcfg, it, kwargs)
            if self.profile is not None:
                if it == self.profile_from:
                    torch.cuda.synchronize(self.dev)
                    self.t_profile = time.perf_counter()
                    self.pre_profile_steps = self.in_window_steps
                    self.profile.start()
                if it == self.profile_to and self.profile.active:
                    self.profile.stop()
            if self.ctx.trace and it == self.yard_iter:
                self.keep_yardstick_step(ts, batch, tcfg, kwargs.get("row_budget", 0))
            name = ("warmup.step" if self.t_start is None else "train.step" if it < self.profile_from
                    else "profiled.step")
            with self.spans.span(name):
                out, metrics = step_fn(ts, batch, tcfg, *args, **kwargs)
            if stretch:
                if self.fault == "unchanged":
                    out = ts  # fault: the step hands back its input state
                self.terms.append({k: v.detach().clone() for k, v in metrics.items() if k in TERMS})
            if self.t_start is not None:
                self.in_window_steps += 1
                self.step_ok += metrics["step_ok"].double()
            return out, metrics
        return call

    def read_stretch(self, ts, batch, tcfg, it, kwargs):
        s0 = self.round_at - 2
        if it == s0:
            self.start = clone_state(ts)
        if it == s0 + 1:
            # the input state of step s0 + 1 is what step s0 handed back
            self.g_norms = grad_norms(self.start.opt, ts.opt)
        src = None
        if batch.multi_view is not None:
            src = self.gray_ids[batch.multi_view.src_image_gray.data_ptr()]
        r = tcfg.raster
        self.stretch.append(dict(iteration=it, view=self.image_ids[batch.image.data_ptr()], src=src,
                                 row_budget=kwargs.get("row_budget", 0), max_instances=r.max_instances,
                                 max_blocks=r.max_blocks, max_visible=r.max_visible))
        if self.keep_batches:
            self.batches.append((batch, tcfg, kwargs.get("row_budget", 0), kwargs.get("use_exposure", False)))

    def keep_yardstick_step(self, ts, batch, tcfg, row_budget):
        g = ts.gaussians
        R = row_budget if 0 < row_budget < g.capacity else g.capacity
        src = None if batch.multi_view is None else self.gray_ids[batch.multi_view.src_image_gray.data_ptr()]
        self.yard = dict(iteration=self.it, rows=R, view=self.image_ids[batch.image.data_ptr()], src=src,
                         raster=tcfg.raster, sh_degree=int(g.active_sh_degree),
                         params=type(g.params)(*(p[:R].detach().clone() for p in g.params)),
                         alive=g.alive[:R].clone(), samples=tcfg.multi_view_sample_num,
                         patch_half=tcfg.multi_view_patch_half)

    # -- the schedule hook: the densify rounds ------------------------------------
    def schedule_wrapper(self, orig):
        def call(ts, cfg, scene_extent, step=None, compiled=None):
            is_round = cfg.densify_from <= step <= cfg.densify_until and step % cfg.densify_interval == 0
            if is_round and self.t_start is not None:
                self.rounds_in_window += 1
            compared = step == self.round_at and self.start is not None
            if compared:
                self.dp_norms = change_norms(ts.gaussians.params, self.start.gaussians.params)
                self.pre_round = clone_state(ts)
                if self.keep_batches:
                    self.round_args = (cfg, scene_extent, step)
            name = ("warmup.densify" if self.t_start is None else "densify.round" if step < self.profile_from
                    else "profiled.densify")
            with self.spans.span(name) if is_round else contextlib.nullcontext():
                out = orig(ts, cfg, scene_extent, step=step, compiled=compiled)
            if compared:
                if self.fault == "altered_round":
                    alter_round(out[0])
                self.after_round = alive_norms(out[0].gaussians)
            return out
        return call

    def close(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.t_end = time.perf_counter()
        if self.profile is not None and self.profile.active:
            self.profile.stop()

    def readings(self) -> Dict:
        """What the check reads, as numbers (and the start state)."""
        def listed(x):
            return None if x is None else x.tolist()
        return dict(p0_norms=listed(self.p0_norms), start=self.start, pre_round=self.pre_round,
                    stretch=self.stretch, terms=[{k: float(v) for k, v in t.items()} for t in self.terms],
                    g_norms=listed(self.g_norms), dp_norms=listed(self.dp_norms),
                    after_round=listed(self.after_round), round_at=self.round_at, batches=self.batches,
                    round_args=self.round_args, yard=self.yard, profile_from=self.profile_from,
                    profile_to=self.profile_to)


def run(ctx: Context, control: bool = False, fault: str = "", keep_batches: bool = False) -> Dict:
    """One run of the trainer cell; fills `ctx` and returns what the
    correctness check needs (with `keep_batches`, also the stretch's
    batches, which the readings tool runs again from its start)."""
    from hidegs_tpu_torch.config import ModelConfig, PipelineConfig
    from hidegs_tpu_torch.train import trainer

    from gsbench.scenes import training

    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    t0 = time.perf_counter()
    scene = training.build(cfg, ctx.seed, ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)  # the peak of the program's work, not the scene's making
    ctx.note(f"set-up: the training scene made in {time.perf_counter() - t0:.2f} s "
             f"({time.perf_counter() - ctx.t_process:.2f} s since the process started)")
    rec = Recorder(ctx, cfg, traffic, scene, control=control, fault=fault, keep_batches=keep_batches)
    step_factory = trainer.CompiledTrainStep

    def compiled_step():
        rec.compiled = step_factory()
        return rec.step_wrapper(rec.compiled)

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(trainer, "CompiledTrainStep", compiled_step))
        stack.enter_context(patched(trainer, "train_step", rec.step_wrapper(trainer.train_step)))
        stack.enter_context(patched(trainer, "init_gaussians_from_scene",
                                    rec.init_wrapper(trainer.init_gaussians_from_scene)))
        stack.enter_context(patched(trainer, "maybe_host_side_schedule",
                                    rec.schedule_wrapper(trainer.maybe_host_side_schedule)))
        stack.enter_context(patched(trainer, "train_config_from_opt",
                                    rec.config_wrapper(trainer.train_config_from_opt)))
        if fault == "half_batch":
            stack.enter_context(half_batch_fault())
        if fault == "altered":
            stack.enter_context(altered_render_fault())
        try:
            trainer.train(ModelConfig(), PipelineConfig(), opt_config(cfg), save_iterations=(), scene=scene,
                          seed=traffic["trainer_seed"], device=ctx.device)
            raise RuntimeError(f"train() ended at iteration {rec.it} before the window closed")
        except WindowClosed:
            pass
    n = rec.in_window_steps
    if rec.t_end is not None and n:
        ctx.window_s = rec.t_end - rec.t_start
        ctx.e2e["train_iter_ms"] = ctx.window_s / n * 1e3
        if rec.t_profile is not None:
            # the traced run's layer metrics read the window up to the profiler's start
            ctx.window_s = rec.t_profile - rec.t_start
        ctx.attempted = n
        ctx.failed = n - int(round(float(rec.step_ok)))
        ctx.counters["densify_rounds"] = rec.rounds_in_window
    if ctx.device.type == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
    for k, v in rec.spans.read().items() if rec.spans.enabled else ():
        ctx.spans[k] = v
    if rec.profile is not None and rec.profile.events is not None:
        ctx.profile = rec.profile.summary()
        ctx.counters["profiled_steps"] = traffic["profile_iters"]
        ctx.yardstick["trace_blend_bwd_ms"] = rec.profile.launches("blend_bwd")
        ctx.yardstick["launched_blend_bwd"] = rec.profile.launched.get("blend_bwd", 0)
    readings = rec.readings()
    del rec
    return dict(scene=scene, readings=readings)


def check(ctx: Context, state: Dict) -> None:
    from gsbench.checks import train as train_check

    train_check.check(ctx, state)


def variant_readings(readings: Dict, variant: str) -> Dict:
    """The stretch run again from its start state through the program's
    eager step and round, as `variant`: "control" (the program's bf16
    attribute stream), "half_batch", "altered" or "altered_round" (the
    planted faults below). The readings tool holds these against the same reference as
    the sound run (`keep_batches` kept the stretch's batches)."""
    from hidegs_tpu_torch.train import loop

    start = readings["start"]
    ts = clone_state(start)
    terms, g = [], None
    fault = {"half_batch": half_batch_fault, "altered": altered_render_fault}.get(variant, contextlib.nullcontext)
    with fault():
        for k, (batch, tcfg, row_budget, use_exposure) in enumerate(readings["batches"]):
            if variant == "control":
                tcfg = dataclasses.replace(tcfg, raster=dataclasses.replace(tcfg.raster, bf16_stream=True))
            ts, metrics = loop.train_step(ts, batch, tcfg, use_exposure=use_exposure, row_budget=row_budget)
            terms.append({k: float(v) for k, v in metrics.items() if k in TERMS})
            if k == 0:
                g = grad_norms(start.opt, ts.opt)
        dp = change_norms(ts.gaussians.params, start.gaussians.params)
        cfg, extent, step = readings["round_args"]
        pre = clone_state(ts)
        ts, _ = loop.maybe_host_side_schedule(ts, cfg, scene_extent=extent, step=step)
        if variant == "altered_round":
            alter_round(ts)
    return dict(readings, terms=terms, g_norms=g.tolist(), dp_norms=dp.tolist(), pre_round=pre,
                after_round=alive_norms(ts.gaussians).tolist())


# -- planted faults, for the check's own tests and the fault readings --------------

@contextlib.contextmanager
def half_batch_fault():
    """The photometric term over the top half of the image only (half of
    the batch left out, the mean taken over the rest)."""
    from hidegs_tpu_torch.train import loop

    orig = loop.dssim_l1

    def half(img, gt, lam):
        h = img.shape[-2] // 2
        return orig(img[..., :h, :], gt[..., :h, :], lam)
    with patched(loop, "dssim_l1", half):
        yield


@contextlib.contextmanager
def altered_render_fault():
    """The rendered image altered where it is produced: one pixel row set
    to 1."""
    from hidegs_tpu_torch.train import loop

    orig = loop.render

    def render(*args, **kwargs):
        out = dict(orig(*args, **kwargs))
        img = out["render"].clone()
        img[:, img.shape[1] // 2, :] = 1.0
        out["render"] = img
        return out
    with patched(loop, "render", render):
        yield
