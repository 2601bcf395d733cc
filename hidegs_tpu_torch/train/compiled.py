"""The compiled train step: `train_step` captured once per static key as a
CUDA graph that writes the new state into the state's own buffers.

Port of the JAX package's `jax.jit(train_step, static_argnames=("cfg",
"use_exposure", "row_budget"), donate_argnums=(0,))` (hidegs_tpu/train/
loop.py:348-352), where one iteration is one XLA executable that the host
issues with one call and that updates the donated state in place.
`CompiledTrainStep()` is called as `train_step` is; on a new static key it
warms the step up and captures `step_forward` → `step_backward`
(`torch.autograd.grad`, the blend's two CUDA kernels inside) →
`step_update` → the write-back into one `torch.cuda.CUDAGraph`, and every
call replays that graph (the protocol is utils/graphs.py's `GraphSet.run`):

  * the static key is what JAX retraces on: `cfg` (the raster budgets
    `max_instances`, `max_visible`, `max_blocks` with it), `use_exposure`,
    `row_budget`, and the shapes and dtypes of every tensor of the state,
    the batch and the pixel samples with every non-tensor leaf (the image
    size, which optional members are present);
  * static inputs: the batch and `uv`, copied in before a replay; the state
    is copied into the state buffers except where the caller passes back
    the tensors the previous replay returned (the steady loop), so a
    steady iteration copies only its batch;
  * donation: the captured step's Adam writes the params and moments
    straight into the static state buffers, and the step ends by writing
    the rest of the new state there (`loop._unslice_rows_` on the
    row-budget path); the returned state is those buffers. The state a replay returned is
    consumed by the next replay, as JAX invalidates a donated argument; the
    returned metrics are the graph's static 0-d outputs, valid until the
    next replay (ROADMAP C28);
  * the multi-view pixel samples are drawn before the replay, outside the
    graph, from a copy of `ts.mv_generator` (`loop.draw_step_pixels`), so
    the generator advances exactly as in the eager step.

There is no fallback: a state off the card raises, and so does a failed
capture (a host sync inside the step is one). The eager `train_step` is
the CPU's path.

`CompiledDensify` compiles the host cadence's densify round and scrub the
same way (its docstring says how).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from hidegs_tpu_torch.model.densify import densify_round, scrub_nonfinite, split_draws
from hidegs_tpu_torch.train.loop import (
    TrainConfig,
    TrainState,
    ViewBatch,
    _slice_rows,
    _unslice_rows_,
    draw_step_pixels,
    step_backward,
    step_forward,
    step_update,
)
from hidegs_tpu_torch.utils.graphs import GraphSet, _spec, copy_into, require_cuda


def _effective_row_budget(ts: TrainState, row_budget: int) -> int:
    return row_budget if 0 < row_budget < ts.gaussians.capacity else 0


def static_key(ts: TrainState, batch: ViewBatch, cfg: TrainConfig, use_exposure: bool = False,
               row_budget: int = 0, uv: Optional[torch.Tensor] = None) -> tuple:
    """The key a graph is captured for: what `jax.jit` retraces on (the
    static arguments and the shapes, dtypes and structure of the others).
    A row budget at or above the capacity is the full-capacity step."""
    return (cfg, bool(use_exposure), _effective_row_budget(ts, row_budget), _spec(ts), _spec(batch),
            _spec(uv if batch.multi_view is not None else None))


def step_in_place(ts: TrainState, batch: ViewBatch, cfg: TrainConfig, use_exposure: bool = False,
                  row_budget: int = 0, uv: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """What a graph captures: one `train_step` (its three stages on the
    rows [0, row_budget) when 0 < row_budget < capacity) whose new state is
    written into the buffers of `ts`. Returns the 0-d metric tensors."""
    view = _slice_rows(ts, row_budget) if _effective_row_budget(ts, row_budget) else ts
    loss, aux, inputs = step_forward(view, batch, cfg, use_exposure, uv=uv)
    grads = step_backward(loss, inputs)
    new, metrics = step_update(view, batch, cfg, loss, aux, grads, use_exposure, in_place=True)
    _unslice_rows_(ts, new)
    for dst, src in ((ts.exposure, new.exposure), (ts.exposure_m, new.exposure_m),
                     (ts.exposure_v, new.exposure_v), (ts.step, new.step)):
        dst.copy_(src)
    return metrics


class CompiledTrainStep(GraphSet):
    """`train_step` compiled: called with `train_step`'s arguments,
    `(ts, batch, cfg, use_exposure=False, row_budget=0, uv=None) -> (ts,
    metrics)`, on a state on a CUDA device. See the module docstring for
    what is static, what is donated and how long the outputs live;
    `captures` and `replays` are GraphSet's."""

    def __init__(self):
        super().__init__("the train step")

    def __call__(self, ts: TrainState, batch: ViewBatch, cfg: TrainConfig, use_exposure: bool = False,
                 row_budget: int = 0, uv: Optional[torch.Tensor] = None):
        require_cuda(ts.gaussians.alive.device, "the compiled train step", "train_step")
        mv_generator = ts.mv_generator
        if batch.multi_view is None:
            uv = None
        elif uv is None:
            uv, mv_generator = draw_step_pixels(ts, batch, cfg)
        key = static_key(ts, batch, cfg, use_exposure, row_budget, uv)
        rows = key[2]  # the effective row budget
        info = dict(capacity=ts.gaussians.capacity, image=tuple(batch.image.shape[-2:]),
                    multi_view=batch.multi_view is not None, use_exposure=bool(use_exposure),
                    row_budget=rows, max_instances=cfg.raster.max_instances,
                    max_visible=cfg.raster.max_visible, max_blocks=cfg.raster.max_blocks)
        metrics, state = self.run(
            key, ts.gaussians.alive.device, lambda s, b, u: step_in_place(s, b, cfg, use_exposure, rows, u),
            (batch, uv), state=ts, info=info)
        return state._replace(generator=ts.generator, mv_generator=mv_generator, rows_split=ts.rows_split), metrics


def densify_in_place(ts: TrainState, scene_extent: torch.Tensor, cfg: TrainConfig,
                     draws: tuple) -> Dict[str, torch.Tensor]:
    """What the densify graph captures: `densify_step` on the given split
    draws, its new rows and moments written into the buffers of `ts`.
    Returns the info dict's 0-d tensors."""
    g, opt, info = densify_round(ts.gaussians, ts.opt, scene_extent, cfg.densify, draws)
    copy_into((ts.gaussians, ts.opt), (g, opt))
    return info


def scrub_in_place(ts: TrainState) -> torch.Tensor:
    """What the scrub graph captures: `scrub_nonfinite`, its alive mask
    written into the state's. Returns the count of rows killed."""
    g, n_killed = scrub_nonfinite(ts.gaussians)
    ts.gaussians.alive.copy_(g.alive)
    return n_killed


class CompiledDensify(GraphSet):
    """The densify round and the scrub compiled: the counterparts of the
    JAX package's `jax.jit(densify_step, static_argnames=("cfg",),
    donate_argnums=(0,))` (hidegs_tpu/train/loop.py:447) and jitted
    `scrub_nonfinite` (model/densify.py:254). `densify_step(ts,
    scene_extent, cfg)` and `scrub_step(ts)` are called as
    `loop.densify_step` and `loop.scrub_step` are, on a state on a CUDA
    device, and `maybe_host_side_schedule(compiled=)` calls them:

      * one graph per key: `cfg.densify` and the state's spec for the
        round (JAX's static `cfg`), the state's spec for the scrub. Both
        write into one set of static state buffers per state layout, and
        the returned state is those buffers (donation, C28); the next
        train-step replay copies them into its own buffers, one copy of
        the state per round;
      * the split draws are drawn before the replay from `ts.generator`
        (`split_draws`, which advances it as the eager round does) and
        copied into the graph's static draws; `scene_extent` (traced in
        JAX) is a 0-d float64 input filled before each replay, so the
        threshold is the eager round's to the bit;
      * the info dict's 0-d tensors and the scrub's count are the graphs'
        static outputs, valid until the next replay of either graph.

    There is no fallback: a state off the card raises ValueError, a failed
    capture RuntimeError. `captures` and `replays` are GraphSet's."""

    def __init__(self):
        super().__init__("the densify round")

    def _returned(self, ts: TrainState, state: TrainState) -> TrainState:
        return state._replace(generator=ts.generator, mv_generator=ts.mv_generator, rows_split=ts.rows_split)

    def densify_step(self, ts: TrainState, scene_extent, cfg: TrainConfig):
        dev = ts.gaussians.alive.device
        require_cuda(dev, "the compiled densify round", "densify_step")
        draws = split_draws(ts.generator, ts.gaussians.capacity, dev)
        extent = self.scalar("scene_extent", dev, torch.float64)
        extent.fill_(scene_extent)
        info, state = self.run(("densify", cfg.densify, _spec(ts)), dev,
                               lambda s, d: densify_in_place(s, extent, cfg, d), (draws,), state=ts,
                               info=dict(kind="densify", capacity=ts.gaussians.capacity))
        return self._returned(ts, state), info

    def scrub_step(self, ts: TrainState):
        dev = ts.gaussians.alive.device
        require_cuda(dev, "the compiled scrub", "scrub_step")
        n_killed, state = self.run(("scrub", _spec(ts)), dev, scrub_in_place, state=ts,
                                   info=dict(kind="scrub", capacity=ts.gaussians.capacity))
        return self._returned(ts, state), n_killed
