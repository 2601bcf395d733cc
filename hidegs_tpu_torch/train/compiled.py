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
call replays that graph:

  * the static key is what JAX retraces on: `cfg` (the raster budgets
    `max_instances`, `max_visible`, `max_blocks` with it), `use_exposure`,
    `row_budget`, and the shapes and dtypes of every tensor of the state,
    the batch and the pixel samples with every non-tensor leaf (the image
    size, which optional members are present). A new key warms up on a
    side stream on a scratch copy of the state, then captures; the graphs
    of one `CompiledTrainStep` share one memory pool, since they never
    run at once;
  * static inputs: every tensor of the state, the batch and `uv`. Before a
    replay each one is copied in from the caller's tensor, except where
    the caller passes back the tensors the previous replay returned (the
    steady loop), so a steady iteration copies only its batch;
  * donation: the captured step ends by writing the new state into the
    static state buffers (`loop._unslice_rows_` on the row-budget path),
    and the returned state is those buffers. The state a replay returned is
    consumed by the next replay, as JAX invalidates a donated argument; the
    returned metrics are the graph's static 0-d outputs, valid until the
    next replay (ROADMAP C28);
  * the multi-view pixel samples are drawn before the replay, outside the
    graph, from a copy of `ts.mv_generator` (`loop.draw_step_pixels`), so
    the generator advances exactly as in the eager step.

There is no fallback: a state off the card raises, and so does a failed
capture (a host sync inside the step is one). The eager `train_step` is
the CPU's path.

Launch counts: `cuda_blend`'s counters count its launchers' calls, which a
replay does not make. Each graph records at capture how often the step
launched each kernel, capture leaves those counters as they were (it
launches nothing), and every replay adds the graph's launches to
`REPLAY_LAUNCHES`. The warm-up's launches are real and stay in
`cuda_blend`'s counters.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from hidegs_tpu_torch.raster import cuda_blend
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

KERNELS = ("blend_fwd", "blend_bwd", "fold_rows")
# launches of each kernel made by graph replays in this process
REPLAY_LAUNCHES = {k: 0 for k in KERNELS}


def _kernel_counts() -> tuple:
    return (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES)


def _set_kernel_counts(counts: tuple) -> None:
    cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES = counts


def _map(fn, x):
    """`x` with `fn` applied to each tensor: tensors inside NamedTuples,
    tuples, lists and dataclasses; every other leaf as it is."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _map(fn, getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def _tensors(x) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(out.append, x)
    return out


def _spec(x):
    """The static part of `x`: each tensor's shape, dtype and device, each
    other leaf's value; generators are state, not structure."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, torch.Generator):
        return torch.Generator
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_spec(v) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x), tuple(_spec(getattr(x, f.name)) for f in dataclasses.fields(x)))
    return x


def _effective_row_budget(ts: TrainState, row_budget: int) -> int:
    return row_budget if 0 < row_budget < ts.gaussians.capacity else 0


def static_key(ts: TrainState, batch: ViewBatch, cfg: TrainConfig, use_exposure: bool = False,
               row_budget: int = 0, uv: Optional[torch.Tensor] = None) -> tuple:
    """The key a graph is captured for: what `jax.jit` retraces on (the
    static arguments and the shapes, dtypes and structure of the others).
    A row budget at or above the capacity is the full-capacity step."""
    return (cfg, bool(use_exposure), _effective_row_budget(ts, row_budget), _spec(ts), _spec(batch),
            _spec(uv if batch.multi_view is not None else None))


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype and a.shape == b.shape
            and a.stride() == b.stride())


def copy_into(static, given) -> int:
    """Copy every tensor of `given` into the matching tensor of `static`,
    except those that already are it; returns how many were copied."""
    n = 0
    for s, g in zip(_tensors(static), _tensors(given), strict=True):
        if not _same_memory(s, g):
            s.copy_(g)
            n += 1
    return n


def step_in_place(ts: TrainState, batch: ViewBatch, cfg: TrainConfig, use_exposure: bool = False,
                  row_budget: int = 0, uv: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """What a graph captures: one `train_step` (its three stages on the
    rows [0, row_budget) when 0 < row_budget < capacity) whose new state is
    written into the buffers of `ts`. Returns the 0-d metric tensors."""
    view = _slice_rows(ts, row_budget) if _effective_row_budget(ts, row_budget) else ts
    loss, aux, inputs = step_forward(view, batch, cfg, use_exposure, uv=uv)
    grads = step_backward(loss, inputs)
    new, metrics = step_update(view, batch, cfg, loss, aux, grads, use_exposure)
    _unslice_rows_(ts, new)
    for dst, src in ((ts.exposure, new.exposure), (ts.exposure_m, new.exposure_m),
                     (ts.exposure_v, new.exposure_v), (ts.step, new.step)):
        dst.copy_(src)
    return metrics


@dataclasses.dataclass
class _Graph:
    graph: Any  # torch.cuda.CUDAGraph
    batch: ViewBatch  # static batch tensors
    uv: Optional[torch.Tensor]  # static pixel samples
    metrics: Dict[str, torch.Tensor]  # static outputs
    launches: Dict[str, int]  # kernel launches recorded into the graph


class CompiledTrainStep:
    """`train_step` compiled: called with `train_step`'s arguments,
    `(ts, batch, cfg, use_exposure=False, row_budget=0, uv=None) -> (ts,
    metrics)`, on a state on a CUDA device. See the module docstring for
    what is static, what is donated and how long the outputs live.

    `captures` lists what each capture cost (key summary, warm-up and
    capture seconds, the kernels it recorded, the pool's growth);
    `replays` counts the replays."""

    def __init__(self):
        self._graphs: Dict[tuple, _Graph] = {}
        self._states: Dict[Any, TrainState] = {}  # static state buffers, by the state's spec
        self._pool = None
        self.captures: List[Dict[str, Any]] = []
        self.replays = 0

    def __call__(self, ts: TrainState, batch: ViewBatch, cfg: TrainConfig, use_exposure: bool = False,
                 row_budget: int = 0, uv: Optional[torch.Tensor] = None):
        dev = ts.gaussians.alive.device
        if dev.type != "cuda":
            raise ValueError(f"the compiled train step captures CUDA graphs; the state is on {dev}: "
                             "use train_step off the card")
        mv_generator = ts.mv_generator
        if batch.multi_view is None:
            uv = None
        elif uv is None:
            uv, mv_generator = draw_step_pixels(ts, batch, cfg)
        key = static_key(ts, batch, cfg, use_exposure, row_budget, uv)
        state_spec = key[3]  # the graphs of one state layout share its buffers
        state = self._states.get(state_spec)
        if state is None:
            state = self._states[state_spec] = _map(torch.clone, ts)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(ts, state, batch, cfg, use_exposure,
                                                  _effective_row_budget(ts, row_budget), uv)
        copy_into(state, ts)
        copy_into(g.batch, batch)
        if uv is not None:
            g.uv.copy_(uv)
        g.graph.replay()
        self.replays += 1
        for k, n in g.launches.items():
            REPLAY_LAUNCHES[k] += n
        return state._replace(generator=ts.generator, mv_generator=mv_generator, rows_split=ts.rows_split), \
            g.metrics

    def _capture(self, ts, state, batch, cfg, use_exposure, row_budget, uv) -> _Graph:
        dev = ts.gaussians.alive.device
        static_batch = _map(torch.clone, batch)
        static_uv = None if uv is None else uv.clone()
        with torch.cuda.device(dev):
            # warm-up: the same step on a scratch copy of the caller's state,
            # on a side stream (lazy library state, the kernels' builds)
            scratch = _map(torch.clone, ts)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            counts = _kernel_counts()
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                step_in_place(scratch, static_batch, cfg, use_exposure, row_budget, static_uv)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            warmup_s = time.perf_counter() - t0
            warmup = dict(zip(KERNELS, (b - a for a, b in zip(counts, _kernel_counts()))))
            del scratch
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            counts = _kernel_counts()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph, pool=self._pool):
                    metrics = step_in_place(state, static_batch, cfg, use_exposure, row_budget, static_uv)
                recorded = dict(zip(KERNELS, (b - a for a, b in zip(counts, _kernel_counts()))))
            except Exception as e:
                raise RuntimeError(f"capturing the train step as a CUDA graph failed: {e}") from e
            finally:
                _set_kernel_counts(counts)  # a capture records launches, it makes none
            capture_s = time.perf_counter() - t0
            info = dict(capacity=ts.gaussians.capacity, image=tuple(batch.image.shape[-2:]),
                        multi_view=batch.multi_view is not None, use_exposure=bool(use_exposure),
                        row_budget=row_budget, max_instances=cfg.raster.max_instances,
                        max_visible=cfg.raster.max_visible, max_blocks=cfg.raster.max_blocks,
                        warmup_s=warmup_s, capture_s=capture_s, warmup_launches=warmup, launches=recorded,
                        pool_reserved_bytes=torch.cuda.memory_reserved(dev) - reserved)
        self.captures.append(info)
        return _Graph(graph=graph, batch=static_batch, uv=static_uv, metrics=metrics, launches=recorded)


def compile_train_step(cfg: TrainConfig, use_exposure: bool = False, row_budget: int = 0):
    """`step(ts, batch, uv=None) -> (ts, metrics)`: a `CompiledTrainStep`
    with the static arguments bound (its graphs as `step.compiled`)."""
    compiled = CompiledTrainStep()

    def step(ts: TrainState, batch: ViewBatch, uv: Optional[torch.Tensor] = None):
        return compiled(ts, batch, cfg, use_exposure, row_budget, uv)

    step.compiled = compiled
    return step
