"""The compiled view-parallel step: the step of parallel/sharded.py captured
once per static key as a CUDA graph that writes the new state into the
state's own buffers.

Port of the JAX package's `jax.jit(step, donate_argnums=(0,))`
(hidegs_tpu/parallel/sharded.py:63), where a V-view step (every view's
render and backward, the gradient all-reduce, masked Adam) is one XLA
executable the host issues with one call. `CompiledDPStep` is called as
`make_dp_train_step`'s step is, `(ts, batch, uv=None) -> (ts, metrics)`,
and follows `train.compiled.CompiledTrainStep` (utils/graphs.py's
`GraphSet.run`):

  * the static key is what JAX retraces on: `cfg`, the gradient wire,
    `use_exposure`, the placement flags and the mesh's shape, and the
    shapes, dtypes and structure of the state, the stacked batch and the
    pixel samples. A new key warms the body (`sharded.dp_step_in_place`)
    up on a scratch copy of the state, then captures it;
  * static inputs: the batch and `uv`, copied in before a replay; the
    state is copied into the state buffers except where the caller passes
    back the tensors the previous replay returned;
  * donation: the captured body ends by writing the new state into the
    static state buffers, and the returned state is those buffers (C28);
    the returned metrics are the graph's static 0-d outputs, valid until
    the next replay;
  * the multi-view pixel samples of all V views are drawn before the
    replay, outside the graph, from a copy of `ts.mv_generator`
    (`sharded.draw_dp_pixels`, C26), so the generator advances exactly as
    in the eager step.

Collectives inside the graph: the body's all-reduces and the all-gather
of the rows are recorded into the graph over NCCL, whose communicator
exists before any capture (`initialize_distributed` creates it eagerly,
C25); the warm-up runs the same collectives once. Every rank must capture
the same collectives in the same order, or the ranks hang, so each new
capture first checks, eagerly, that the key's digest is equal on every
rank of the default group (`assert_same_across_hosts`). gloo cannot be
captured (its collectives on CUDA tensors go through the host): a mesh
whose backend is not NCCL raises ValueError when the step is made, before
any device is looked at. `mesh=None` (one process, no collective) is
captured as is.

There is no fallback: a mesh off NCCL, a state off the card and a failed
capture raise. The eager `make_dp_train_step` is the path of gloo groups
and of the CPU.
"""
from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from hidegs_tpu_torch.parallel import distributed as pdist
from hidegs_tpu_torch.parallel.sharded import (
    check_placement,
    dp_plan,
    dp_step_in_place,
    draw_dp_pixels,
    make_dp_train_step,
)
from hidegs_tpu_torch.train.loop import TrainConfig, TrainState, ViewBatch
from hidegs_tpu_torch.utils.graphs import GraphSet, _spec, require_cuda


def mesh_backend(mesh) -> Optional[str]:
    """The backend of the mesh's groups (None without a mesh)."""
    if mesh is None:
        return None
    return dist.get_backend(mesh.get_group(0))


def dp_static_key(ts: TrainState, batch: ViewBatch, cfg: TrainConfig, mesh=None, use_exposure: bool = False,
                  grad_reduce_dtype: Optional[torch.dtype] = None, replicate_preprocessed: bool = False,
                  shard_gaussians: bool = False, uv: Optional[torch.Tensor] = None) -> tuple:
    """The key a graph is captured for: what `jax.jit` retraces on (the
    step's static arguments, the mesh's shape, and the shapes, dtypes and
    structure of the state, the batch and the samples)."""
    shape = None if mesh is None else (tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    return (cfg, grad_reduce_dtype or torch.float32, bool(use_exposure), bool(replicate_preprocessed),
            bool(shard_gaussians), shape, _spec(ts), _spec(batch),
            _spec(uv if batch.multi_view is not None else None))


def _rank_neutral(x):
    """`x` with every device replaced by its type: ranks on other cards
    hold the same key."""
    if isinstance(x, torch.device):
        return x.type
    if isinstance(x, tuple):
        return tuple(_rank_neutral(v) for v in x)
    return x


def key_digest(key: tuple) -> np.ndarray:
    """The MD5 digest of a key's rank-neutral text, as 16 float32 values
    0-255 (the form `assert_same_across_hosts` compares)."""
    h = hashlib.md5(repr(_rank_neutral(key)).encode())
    return np.frombuffer(h.digest(), np.uint8).astype(np.float32)


class CompiledDPStep(GraphSet):
    """The view-parallel step compiled: made with `make_dp_train_step`'s
    arguments, called as its step is, `(ts, batch, uv=None) -> (ts,
    metrics)`, on a state on a CUDA device. See the module docstring for
    what is static, what is donated, how long the outputs live and why a
    mesh must be NCCL's; `captures` and `replays` are GraphSet's."""

    def __init__(self, cfg: TrainConfig, mesh=None, use_exposure: bool = False,
                 grad_reduce_dtype: Optional[torch.dtype] = None, replicate_preprocessed: bool = False,
                 shard_gaussians: bool = False):
        backend = mesh_backend(mesh)
        if backend not in (None, "nccl"):
            raise ValueError(f"the compiled view-parallel step captures its collectives in a CUDA graph, which "
                             f"NCCL allows and {backend} does not: use the eager make_dp_train_step on a "
                             f"{backend} mesh")
        super().__init__("the view-parallel step")
        self.statics = dict(cfg=cfg, mesh=mesh, use_exposure=use_exposure, grad_reduce_dtype=grad_reduce_dtype,
                            replicate_preprocessed=replicate_preprocessed, shard_gaussians=shard_gaussians)
        self.plan = dp_plan(**self.statics)

    def _new_key(self, key, dev) -> None:
        # every rank must record the same collectives in the same order
        pdist.assert_same_across_hosts(key_digest(key), "the compiled view-parallel step's key", device=dev)

    def __call__(self, ts: TrainState, batch: ViewBatch, uv: Optional[torch.Tensor] = None):
        check_placement(self.plan, ts)
        dev = ts.gaussians.alive.device
        require_cuda(dev, "the compiled view-parallel step", "make_dp_train_step")
        mv_generator = ts.mv_generator
        if batch.multi_view is None:
            uv = None
        elif uv is None:
            uv, mv_generator = draw_dp_pixels(self.plan, ts, batch)
        plan, mesh = self.plan, self.statics["mesh"]
        info = dict(capacity=ts.gaussians.capacity, views=int(batch.image.shape[0]),
                    image=tuple(batch.image.shape[-2:]), multi_view=batch.multi_view is not None,
                    use_exposure=plan.use_exposure, wire=str(plan.wire).rsplit(".", 1)[-1],
                    mesh=None if mesh is None else tuple(mesh.shape), split=plan.split,
                    max_instances=plan.cfg.raster.max_instances)
        metrics, state = self.run(dp_static_key(ts, batch, uv=uv, **self.statics), dev,
                                  lambda s, b, u: dp_step_in_place(plan, s, b, u), (batch, uv), state=ts, info=info)
        return state._replace(generator=ts.generator, mv_generator=mv_generator, rows_split=ts.rows_split), metrics


def compile_dp_train_step(cfg: TrainConfig, mesh=None, use_exposure: bool = False,
                          grad_reduce_dtype: Optional[torch.dtype] = None, replicate_preprocessed: bool = False,
                          shard_gaussians: bool = False):
    """`make_dp_train_step` compiled: (step, place), where `step` is a
    `CompiledDPStep` and `place` the eager step's (JAX's `device_put`)."""
    statics = dict(mesh=mesh, use_exposure=use_exposure, grad_reduce_dtype=grad_reduce_dtype,
                   replicate_preprocessed=replicate_preprocessed, shard_gaussians=shard_gaussians)
    step = CompiledDPStep(cfg, **statics)
    _, place = make_dp_train_step(cfg, **statics)
    return step, place
