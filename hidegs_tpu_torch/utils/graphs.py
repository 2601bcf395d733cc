"""The port's compiled callables: a callable captured once per static key
as a `torch.cuda.CUDAGraph` and replayed on every call.

The JAX package compiles its hot boundaries with `jax.jit`: one XLA
executable per static key that the host issues with one call. The port's
counterparts subclass `GraphSet`, whose `run` is the one capture-and-replay
protocol: `train.compiled.CompiledTrainStep` and `CompiledDensify`,
`parallel.compiled.CompiledDPStep`, `raster.compiled.CompiledRender`,
`hier.interp.CompiledLodFrame`, `train.hier_trainer.CompiledHierTrainStep`
and `train.lpips.CompiledLpips`. Each keeps its key function, its body,
its refusals and what only it does. Here:

  * `_map`, `_tensors` and `_spec` walk the NamedTuples, tuples, lists and
    dataclasses of a call's arguments; `_spec` is the static part (each
    tensor's shape, dtype and device, every other leaf's value), from
    which each callable builds the key `jax.jit` would retrace on;
  * `copy_into` copies the caller's tensors into a graph's static inputs,
    skipping those that already are them (the buffers a replay returned);
  * `GraphSet.run` checks the tensors held by reference, looks the key up,
    captures on a miss and replays (its docstring says how);
  * `GraphSet.capture` warms the body up on a side stream (lazy library
    state, the kernels' builds), then captures it; the graphs of one
    `GraphSet` share one memory pool, since they never run at once, and
    `GraphSet.captures` records what each capture cost (warm-up and
    capture seconds, the pool's growth, the launches);
  * launch accounting: the counters of `cuda_blend`,
    `preprocess_autograd`, `model.adam` and `hier.interp_autograd` count
    their launchers' calls, which a replay does not make. A capture
    records how often the body launched each kernel and leaves those
    counters as they were (it launches nothing); every replay adds the
    graph's launches to `REPLAY_LAUNCHES`, one process-wide count for
    every compiled callable. The warm-up's launches are real and stay in
    the launchers' counters;
  * spans (utils/profiling.py): every capture is a `graph.capture` span and
    every replay a `graph.replay` span, with the `GraphSet`'s name as
    `what`; nothing inside a captured body records one.

A graph's outputs are its static tensors: a replay of any graph of the
same `GraphSet` may overwrite them (the pool is shared), so a caller that
keeps an output past the next call clones it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List

import torch

from hidegs_tpu_torch.hier import interp_autograd
from hidegs_tpu_torch.model import adam
from hidegs_tpu_torch.raster import cuda_blend, preprocess_autograd
from hidegs_tpu_torch.utils.profiling import span

# the render's kernels, in the order of their counters (gsbench/trace.py
# pairs this tuple with the five render counters)
KERNELS = ("blend_fwd", "blend_bwd", "fold_rows", "preprocess_fwd", "preprocess_bwd")
# every counted kernel: the render's, the masked Adam and the LOD cut's
# interpolation
ALL_KERNELS = KERNELS + ("masked_adam", "interp_fwd", "interp_bwd")
# launches of each kernel made by graph replays in this process
REPLAY_LAUNCHES = {k: 0 for k in ALL_KERNELS}


def _kernel_counts() -> tuple:
    return (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES,
            preprocess_autograd.FWD_LAUNCHES, preprocess_autograd.BWD_LAUNCHES, adam.LAUNCHES,
            interp_autograd.FWD_LAUNCHES, interp_autograd.BWD_LAUNCHES)


def _set_kernel_counts(counts: tuple) -> None:
    (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES,
     preprocess_autograd.FWD_LAUNCHES, preprocess_autograd.BWD_LAUNCHES, adam.LAUNCHES,
     interp_autograd.FWD_LAUNCHES, interp_autograd.BWD_LAUNCHES) = counts


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


def same_tensors(a, b) -> bool:
    """Whether every tensor of `b` is the memory of the matching one of `a`
    (inputs a graph holds by reference)."""
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(_same_memory(x, y) for x, y in zip(ta, tb))


def on_card(dev) -> bool:
    """Whether work on `dev` runs as graph replays: on a CUDA device."""
    return torch.device(dev).type == "cuda"


def require_cuda(dev: torch.device, what: str, eager: str) -> None:
    if not on_card(dev):
        raise ValueError(f"{what} captures CUDA graphs; the state is on {dev}: use {eager} off the card")


@dataclasses.dataclass
class Graph:
    graph: Any  # torch.cuda.CUDAGraph
    outputs: Any  # what the body returned: static tensors
    launches: Dict[str, int]  # kernel launches recorded into the graph
    inputs: Any = None  # static copies of the call's inputs (`GraphSet.run`)
    state: Any = None  # the donated state buffers the graph writes (`GraphSet.run`)
    info: Any = None  # the summary of the key given to the capture (`GraphSet.run`)


class GraphSet:
    """The graphs of one compiled callable: one graph per static key
    (`run`), one memory pool, the record of each capture (`captures`) and
    the count of replays (`replays`). Each compiled callable subclasses it;
    `capture_error_mode` is `torch.cuda.graph`'s for its captures."""

    capture_error_mode = "global"

    def __init__(self, what: str):
        self.what = what
        self._pool = None
        self.captures: List[Dict[str, Any]] = []
        self.replays = 0
        self._graphs: Dict[Any, Graph] = OrderedDict()  # by static key, oldest first (the render's LRU order)
        self._states: Dict[Any, Any] = {}  # donated state buffers, by the state's spec
        self._held = None  # the tensors every graph reads by reference, pinned at the first capture
        self._scalars: Dict[tuple, torch.Tensor] = {}

    def run(self, key, dev: torch.device, body: Callable[..., Any], inputs: tuple = (), state=None, held=None, *,
            info: Dict[str, Any]):
        """Replay the graph of `key`, captured first if the key is new;
        returns (the graph's outputs, the state buffers or None). The
        graph runs `body(state, *inputs)`:

          * `held`: tensors the body reads by reference (a model's arrays),
            never copied. They are pinned at the first capture that holds
            some and checked on every call, before the key is looked up:
            other tensors raise ValueError;
          * on a new key: `_new_key(key, dev)`; the donated state buffers
            of the state's layout (`_spec(state)`), cloned from `state` at
            the layout's first key, which every graph of that layout
            shares; static clones of `inputs`; a warm-up of the body on a
            scratch clone of `state` and the static inputs; the capture
            of the body on the buffers and the static inputs, with `info`
            (`capture`);
          * on every call: `state` and `inputs` copied into the buffers and
            the static inputs, except tensors that already are them (the
            buffers a replay returned), then the replay.

        The returned buffers are donated: the next call's replay writes
        them again. A body that writes its new state writes it into the
        buffers it is given."""
        if held is not None:
            self._check_held(held)
        g = self._graphs.get(key)
        if g is None:
            self._new_key(key, dev)
            buffers = None
            if state is not None:
                spec = _spec(state)
                buffers = self._states.get(spec)
                if buffers is None:
                    buffers = self._states[spec] = _map(torch.clone, state)
            static = _map(torch.clone, inputs)
            g = self.capture(dev, lambda: body(_map(torch.clone, state), *static), lambda: body(buffers, *static),
                             info, self.capture_error_mode)
            g = self._graphs[key] = dataclasses.replace(g, inputs=static, state=buffers, info=info)
            if held is not None and self._held is None:
                self._held = held
        if state is not None:
            copy_into(g.state, state)
        copy_into(g.inputs, inputs)
        self.replay(g)
        return g.outputs, g.state

    def _check_held(self, held) -> None:
        if self._held is not None and not same_tensors(self._held, held):
            name = type(self).__name__
            raise ValueError(f"{name} ({self.what}) reads the tensors it was first given by reference, and this "
                             f"call gives others: use one {name} for each")

    def _new_key(self, key, dev: torch.device) -> None:
        """Called for a new key before its capture."""

    def scalar(self, name: str, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """The 0-d tensor `name` on `dev` that this set's graphs read by
        reference: a traced scalar that the caller writes before each
        call."""
        t = self._scalars.get((name, dev))
        if t is None:
            t = self._scalars[(name, dev)] = torch.zeros((), dtype=dtype, device=dev)
        return t

    def capture(self, dev: torch.device, warmup: Callable[[], Any], body: Callable[[], Any],
                info: Dict[str, Any], capture_error_mode: str = "global") -> Graph:
        """Run `warmup()` on a side stream, then capture `body()` (which
        reads and writes only static tensors) into a new graph of the pool.
        `info` (a summary of the key) is recorded in `captures` with the
        warm-up and capture seconds, the launches of both and the pool's
        growth. `capture_error_mode` is `torch.cuda.graph`'s: "global"
        forbids unsafe CUDA calls in every thread while the capture runs,
        "thread_local" in the capturing thread only. A capture that fails
        raises RuntimeError."""
        with span("graph.capture", what=self.what), torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            counts = _kernel_counts()
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                warmup()
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            warmup_s = time.perf_counter() - t0
            warmup_launches = dict(zip(ALL_KERNELS, (b - a for a, b in zip(counts, _kernel_counts()))))
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            counts = _kernel_counts()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph, pool=self._pool, capture_error_mode=capture_error_mode):
                    outputs = body()
                recorded = dict(zip(ALL_KERNELS, (b - a for a, b in zip(counts, _kernel_counts()))))
            except Exception as e:
                raise RuntimeError(f"capturing {self.what} as a CUDA graph failed: {e}") from e
            finally:
                _set_kernel_counts(counts)  # a capture records launches, it makes none
            capture_s = time.perf_counter() - t0
            info = dict(info, what=self.what, warmup_s=warmup_s, capture_s=capture_s,
                        warmup_launches=warmup_launches, launches=recorded,
                        pool_reserved_bytes=torch.cuda.memory_reserved(dev) - reserved)
        self.captures.append(info)
        return Graph(graph=graph, outputs=outputs, launches=recorded)

    def replay(self, g: Graph) -> None:
        with span("graph.replay", what=self.what):
            g.graph.replay()
        self.replays += 1
        for k, n in g.launches.items():
            REPLAY_LAUNCHES[k] += n
