"""View-parallel (data-parallel) multi-GPU training step.

Port of hidegs_tpu/parallel/sharded.py. Training views are split across
the ranks of the mesh's data dimension: each rank renders and
differentiates its own views of the same state, and one all-reduce of one
flat buffer sums the gradients. The loss is sum(view totals) / V with V the
global view count, so the sum needs no rescale. Masked sparse Adam runs
over the rows visible in ANY of the step's views, and the densification
statistics are the max over all views. The JAX package leaves the
reduction to GSPMD (or to a shard_map psum on its bf16 wire); here every
collective is an explicit `torch.distributed` call on a plain tensor,
outside the blend kernels, on the group of one mesh dimension:

  * SUM over "data": the parameter and exposure gradients (of the local
    rows), in one flat buffer, in float32 or in `grad_reduce_dtype`
    (bf16 halves the wire); the loss and the metrics ride in it in float32,
    or in a small float32 buffer of their own beside a bf16 one;
  * MAX over "data": the visibility union and the three densification
    maxima of the local rows, one (C_local, 4) buffer;
  * with the rows split over "model" (`shard_gaussians=True`): an
    all-gather of the rows before the render, or with
    `replicate_preprocessed` of the preprocessed rows inside it
    (`RasterConfig.pre_constraint`, docs/SHARDING.md), whose backward takes
    the local slice: the loss is the same on every rank of a model group,
    so its gradient for the local rows is the slice of the full one. (The
    backward of torch.distributed.nn.functional.all_gather sums the
    cotangents over the group, which would scale it by the model size.)

A rank loops over its local views (JAX vmaps them): one forward and one
backward per view, so a view's blend node launches the forward, backward
and fold kernels once. The views' gradients add as halves, (v0 + v1) +
(v2 + v3) for four, so one process and a data group of two ranks give the
same sums. There is no
finite-step gate, as in the JAX DP step. With `mesh=None` the step runs
in one process with no collective at all.

The step is its draws (`draw_dp_pixels`) and `dp_compute`, which returns
the new state; `dp_step_in_place` writes that state into the buffers of
the old one, and is what parallel/compiled.py captures as a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from hidegs_tpu_torch.core.camera_math import CameraParams
from hidegs_tpu_torch.model.adam import AdamState, masked_adam_update
from hidegs_tpu_torch.model.gaussians import GaussianParams
from hidegs_tpu_torch.model.schedules import expon_lr, lr_tree
from hidegs_tpu_torch.raster.preprocess import PreprocessedGaussians
from hidegs_tpu_torch.train.geometric import sample_pixels
from hidegs_tpu_torch.train.loop import TrainConfig, TrainState, ViewBatch, compute_losses, fork_generator
from hidegs_tpu_torch.utils.graphs import copy_into

PARAM_FIELDS = GaussianParams._fields
ROW_FIELDS = ("alive", "grad_max", "grad_abs_max", "max_radii2d", "protected")


class MeshGroups(NamedTuple):
    """The two dimension groups of a mesh and this rank's place in them;
    without a mesh, one process: no groups, sizes 1."""

    data: Optional[dist.ProcessGroup]
    model: Optional[dist.ProcessGroup]
    n_data: int
    n_model: int
    data_index: int
    model_index: int


def mesh_groups(mesh) -> MeshGroups:
    if mesh is None:
        return MeshGroups(None, None, 1, 1, 0, 0)
    names = mesh.mesh_dim_names
    d, m = names.index("data"), names.index("model")
    return MeshGroups(mesh.get_group(d), mesh.get_group(m), mesh.size(d), mesh.size(m),
                      mesh.get_local_rank(d), mesh.get_local_rank(m))


# ---------------------------------------------------------------------------
# collectives (no-ops without a group)


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def _all_gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(R, K) on each of the `n` ranks of `group` → (n·R, K), rank order."""
    if group is None:
        return x
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather of row blocks whose backward is the local block of the
    cotangent (the loss is replicated over the group; see the module
    docstring)."""

    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.rows, ctx.index = x.shape[0], index
        return _all_gather_rows(x, group, n)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None, None, None


def _pack(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """(R, ...) tensors → one (R, K) float32 buffer (bools, int32 and
    float32 values of these fields are exact in float32)."""
    R = cols[0].shape[0]
    return torch.cat([c.reshape(R, -1).to(torch.float32) for c in cols], dim=1)


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, k = [], 0
    for c in like:
        w = math.prod(c.shape[1:])
        col = buf[:, k:k + w].reshape((buf.shape[0],) + tuple(c.shape[1:]))
        # contiguous: the kernels of the render take other paths on strided
        # inputs, which round differently
        out.append(col > 0.5 if c.dtype == torch.bool else col.to(c.dtype).contiguous())
        k += w
    return out


PRE_FIELDS = [f.name for f in dataclasses.fields(PreprocessedGaussians)]


def gather_preprocessed(pre: PreprocessedGaussians, group, n: int, index: int) -> PreprocessedGaussians:
    """`RasterConfig.pre_constraint` of a gaussian-sharded step: the model
    group's preprocessed rows, gathered in one (C, 17) all-gather; the
    gradient of the local rows is their slice."""
    cols = pre.tensors()
    full = _unpack(_GatherRows.apply(_pack(cols), group, n, index), cols)
    return PreprocessedGaussians(**dict(zip(PRE_FIELDS, full)))


def _row_leaves(ts: TrainState) -> List[torch.Tensor]:
    g = ts.gaussians
    return (list(g.params) + list(ts.opt.m) + list(ts.opt.v) + [ts.opt.step]
            + [getattr(g, f) for f in ROW_FIELDS])


def _with_row_leaves(ts: TrainState, leaves: Sequence[torch.Tensor]) -> TrainState:
    n = len(PARAM_FIELDS)
    p, m, v = (GaussianParams(*leaves[i * n:(i + 1) * n]) for i in range(3))
    g = ts.gaussians._replace(params=p, **dict(zip(ROW_FIELDS, leaves[3 * n + 1:])))
    return ts._replace(gaussians=g, opt=AdamState(m=m, v=v, step=leaves[3 * n]))


def shard_rows(ts: TrainState, mesh) -> TrainState:
    """This rank's block of every row field (params, Adam moments and steps,
    alive, the densification stats, protected) over the model dimension;
    the capacity must divide evenly. The state records the split
    (`TrainState.rows_split`)."""
    grp = mesh_groups(mesh)
    C = ts.gaussians.capacity
    if C % grp.n_model:
        raise ValueError(f"capacity {C} does not split over {grp.n_model} model ranks")
    R = C // grp.n_model
    lo = grp.model_index * R
    return _with_row_leaves(ts, [x[lo:lo + R] for x in _row_leaves(ts)])._replace(rows_split=grp.n_model)


def gather_rows(ts: TrainState, mesh) -> TrainState:
    """The inverse of `shard_rows`: every row field whole on every rank of a
    model group, in one all-gather."""
    grp = mesh_groups(mesh)
    leaves = _row_leaves(ts)
    whole = _with_row_leaves(ts, _unpack(_all_gather_rows(_pack(leaves), grp.model, grp.n_model), leaves))
    return whole._replace(rows_split=1)


# ---------------------------------------------------------------------------
# stacked view batches


def _stack(items):
    x = items[0]
    if x is None:
        if any(i is not None for i in items):
            raise ValueError("a batch member is None in some views only")
        return None
    if isinstance(x, torch.Tensor):
        return torch.stack(items)
    if isinstance(x, CameraParams):
        out = {}
        for f in dataclasses.fields(CameraParams):
            vals = [getattr(c, f.name) for c in items]
            if isinstance(vals[0], torch.Tensor):
                out[f.name] = torch.stack(vals)
            elif len(set(vals)) != 1:
                raise ValueError(f"views differ in {f.name}: {vals} (same-resolution policy)")
            else:
                out[f.name] = vals[0]
        return CameraParams(**out)
    return type(x)(*(_stack([getattr(i, f) for i in items]) for f in x._fields))


def _index(x, idx):
    if x is None or isinstance(x, int):
        return x
    if isinstance(x, torch.Tensor):
        return x[idx]
    if isinstance(x, CameraParams):
        return dataclasses.replace(x, **{f.name: getattr(x, f.name)[idx] for f in dataclasses.fields(x)
                                         if isinstance(getattr(x, f.name), torch.Tensor)})
    return type(x)(*(_index(getattr(x, f), idx) for f in x._fields))


def stack_view_batches(batches: Sequence[ViewBatch]) -> ViewBatch:
    """Stack per-view ViewBatches along a new leading axis. All views share
    the image shape (same-resolution policy)."""
    return _stack(list(batches))


def num_views(batch: ViewBatch) -> int:
    return batch.image.shape[0]


def unstack_view_batch(batch: ViewBatch) -> List[ViewBatch]:
    return [_index(batch, j) for j in range(num_views(batch))]


def select_views(batch: ViewBatch, lo: int, hi: int) -> ViewBatch:
    return _index(batch, slice(lo, hi))


# ---------------------------------------------------------------------------
# the step


def _broadcast(x: torch.Tensor, device) -> torch.Tensor:
    """Rank 0's `x` on every rank of the default group, on `device`."""
    y = x.to(device=device, copy=True).contiguous()
    dist.broadcast(y.view(torch.uint8) if y.dtype == torch.bool else y, src=0)
    return y


def _broadcast_generator(gen: torch.Generator, device) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(_broadcast(gen.get_state(), device).cpu())
    return out


class DPPlan(NamedTuple):
    """What `make_dp_train_step` decides once: the static part of a
    view-parallel step."""

    cfg: TrainConfig
    step_cfg: TrainConfig  # cfg, with the render's gather of the preprocessed rows when they are gathered
    grp: MeshGroups
    use_exposure: bool
    wire: torch.dtype  # of the gradient all-reduce
    sharded: bool  # the row fields split over "model"
    gather_pre: bool  # the preprocessed rows gathered inside the render

    @property
    def split(self) -> int:
        """The model ranks a state's rows are split over."""
        return self.grp.n_model if self.sharded else 1


def dp_plan(cfg: TrainConfig, mesh=None, use_exposure: bool = False, grad_reduce_dtype: Optional[torch.dtype] = None,
            replicate_preprocessed: bool = False, shard_gaussians: bool = False) -> DPPlan:
    """The plan of `make_dp_train_step` with these arguments."""
    grp = mesh_groups(mesh)
    sharded = shard_gaussians and grp.n_model > 1
    gather_pre = sharded and replicate_preprocessed
    step_cfg = cfg
    if gather_pre:  # the render gathers the preprocessed rows
        step_cfg = dataclasses.replace(cfg, raster=dataclasses.replace(
            cfg.raster, pre_constraint=lambda pre: gather_preprocessed(pre, grp.model, grp.n_model, grp.model_index)))
    return DPPlan(cfg, step_cfg, grp, bool(use_exposure), grad_reduce_dtype or torch.float32, sharded, gather_pre)


def check_placement(plan: DPPlan, ts: TrainState) -> None:
    """ValueError unless the state's rows are split as the plan splits them."""
    if ts.rows_split != plan.split:
        raise ValueError(f"the state's rows are split over {ts.rows_split} model ranks and this step's over "
                         f"{plan.split}: place the state with the step's own `place`")


def draw_dp_pixels(plan: DPPlan, ts: TrainState, batch: ViewBatch):
    """The multi-view pixel samples of one step, all V views in view order,
    drawn on the device from a copy of `ts.mv_generator` (so every rank
    draws the same, C26): (uv (V, n, 2), the advanced copy)."""
    V = num_views(batch) * plan.grp.n_data
    gen = fork_generator(ts.mv_generator)
    uv = torch.stack([sample_pixels(gen, plan.cfg.multi_view_sample_num, batch.cam.height, batch.cam.width,
                                    plan.cfg.multi_view_patch_half) for _ in range(V)])
    return uv, gen


def _halves_sum(items, n: int) -> List[torch.Tensor]:
    """The elementwise sum of the next `n` lists of `items`, as the sum of
    its halves (the first ceil(n/2) lists, then the rest): four views add
    as (v0 + v1) + (v2 + v3). A data group of two ranks, each holding half
    of the views, adds the two halves once more, so one process and two
    ranks round alike."""
    if n == 1:
        return next(items)
    first = _halves_sum(items, (n + 1) // 2)
    return [a + b for a, b in zip(first, _halves_sum(items, n // 2), strict=True)]


def dp_compute(plan: DPPlan, ts: TrainState, batch: ViewBatch,
               uv: Optional[torch.Tensor]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One view-parallel step on the samples `uv`: (new state, metrics).
    The new state keeps `ts`'s generators; `ts` is left as it was."""
    cfg, step_cfg, grp, use_exposure, wire = plan.cfg, plan.step_cfg, plan.grp, plan.use_exposure, plan.wire
    sharded, gather_pre = plan.sharded, plan.gather_pre
    V_local = num_views(batch)
    V = V_local * grp.n_data
    first = grp.data_index * V_local
    H, W = batch.cam.height, batch.cam.width

    g_local = ts.gaussians
    R = g_local.capacity
    lo = grp.model_index * R

    def local(x):  # this rank's block of a row tensor of the render
        return x if x.shape[0] == R else x[lo:lo + R]

    params = GaussianParams(*(p.detach().requires_grad_(True) for p in g_local.params))
    g_render = g_local._replace(params=params)
    scale_rows = None
    if sharded and not gather_pre:
        # the rows whole on every rank of the model group; autograd
        # gives the local block of their gradient
        cols = list(params) + [g_local.alive, g_local.protected]
        full = _unpack(_GatherRows.apply(_pack(cols), grp.model, grp.n_model, grp.model_index), cols)
        n = len(PARAM_FIELDS)
        g_render = g_local._replace(params=GaussianParams(*full[:n]), alive=full[n], protected=full[n + 1])
    elif gather_pre:
        scale_rows = _GatherRows.apply(g_render.scales, grp.model, grp.n_model, grp.model_index)
    exposure = ts.exposure.detach().requires_grad_(use_exposure)
    rows = g_render.capacity  # the rows the render holds

    n = len(PARAM_FIELDS)
    names: List[str] = []  # the scalar metrics, sorted
    stats = None  # (R, 4): any-visible, max gradient norm, max abs gradient, max radius

    def views():
        """Each local view's parameter gradients (then the exposure's), loss
        total and scalar metrics, in view order; folds the view's
        densification statistics into `stats`."""
        nonlocal stats
        for j, view in enumerate(unstack_view_batch(batch)):
            offset = torch.zeros((rows, 2), dtype=torch.float32, device=params.xyz.device, requires_grad=True)
            total, aux = compute_losses(g_render, exposure, view, ts.step, step_cfg, offset, use_exposure,
                                        uv=None if uv is None else uv[first + j], scale_rows=scale_rows)
            inputs = list(params) + [offset] + ([exposure] if use_exposure else [])
            # the views share the gather's graph when the rows are split
            grads = torch.autograd.grad(total / V, inputs, allow_unused=True,
                                        retain_graph=sharded and j < V_local - 1)
            grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
            scalars = {k: val.detach().to(torch.float32) for k, val in aux.items() if val.ndim == 0}
            if not names:
                names.extend(sorted(scalars))

            # per-view screen-space gradient at single-view magnitude (the
            # mean loss gives each view 1/V), in the reference's (0.5·W,
            # 0.5·H) NDC units (backward.cu:604,754)
            sg = local(grads[n]) * V
            sg = torch.stack([sg[:, 0] * (0.5 * W), sg[:, 1] * (0.5 * H)], dim=1)
            vis, radii = local(aux["visibility"]), local(aux["radii"])
            gnorm = torch.linalg.norm(sg, dim=-1)
            gabs = torch.sum(torch.abs(sg), dim=-1)
            zero = torch.zeros_like(gnorm)
            view_stats = torch.stack([vis.to(torch.float32), torch.where(vis, gnorm, zero),
                                      torch.where(vis, gabs, zero), torch.where(vis, radii.to(torch.float32), zero)],
                                     dim=1)
            stats = view_stats if stats is None else torch.maximum(stats, view_stats)
            item = grads[:n] + grads[n + 1:] + [total.detach()] + [scalars[k] for k in names]
            del total, aux, grads, scalars
            yield item

    summed = _halves_sum(views(), V_local)
    param_grads = summed[:n]
    expo_grad = summed[n] if use_exposure else None
    loss_local = summed[n + int(use_exposure)]
    metric_sums = summed[n + int(use_exposure) + 1:]

    # one flat SUM over the data group: the gradients (in the wire type),
    # then the loss and the metric sums (float32)
    scalars = torch.stack([loss_local / V] + metric_sums)
    flat = [g.reshape(-1) for g in param_grads] + ([expo_grad.reshape(-1)] if use_exposure else [])
    if wire == torch.float32:
        buf = _all_reduce(torch.cat(flat + [scalars]), dist.ReduceOp.SUM, grp.data)
        grad_buf, scalars = buf[:-scalars.numel()], buf[-scalars.numel():]
    else:
        grad_buf = _all_reduce(torch.cat(flat).to(wire), dist.ReduceOp.SUM, grp.data).to(torch.float32)
        scalars = _all_reduce(scalars, dist.ReduceOp.SUM, grp.data)
    pieces = list(torch.split(grad_buf, [g.numel() for g in flat]))
    param_grads = GaussianParams(*(p.reshape(g.shape) for p, g in zip(pieces, param_grads)))
    if use_exposure:
        expo_grad = pieces[-1].reshape(ts.exposure.shape)
    stats = _all_reduce(stats, dist.ReduceOp.MAX, grp.data)

    visible_any = stats[:, 0] > 0
    lrs = lr_tree(ts.step, cfg.lr, g_local.spatial_lr_scale)
    new_params, new_opt = masked_adam_update(g_local.params, param_grads, ts.opt, lrs, visible_any)
    g_state = g_local._replace(
        params=new_params,
        grad_max=torch.maximum(g_local.grad_max, stats[:, 1]),
        grad_abs_max=torch.maximum(g_local.grad_abs_max, stats[:, 2]),
        max_radii2d=torch.maximum(g_local.max_radii2d, stats[:, 3]),
    )

    if use_exposure:
        b1, b2, eps = 0.9, 0.999, 1e-8
        t = torch.clamp(ts.step + 1, min=1).to(torch.float32)
        m = b1 * ts.exposure_m + (1 - b1) * expo_grad
        v = b2 * ts.exposure_v + (1 - b2) * expo_grad**2
        lr_e = expon_lr(ts.step, cfg.lr.exposure_lr_init, cfg.lr.exposure_lr_final, cfg.iterations)
        new_expo = ts.exposure - lr_e * (m / (1 - b1**t)) / (torch.sqrt(v / (1 - b2**t)) + eps)
    else:
        m, v, new_expo = ts.exposure_m, ts.exposure_v, ts.exposure

    new_ts = ts._replace(gaussians=g_state, opt=new_opt, exposure=new_expo.detach(), exposure_m=m.detach(),
                         exposure_v=v.detach(), step=ts.step + 1)
    metrics = {k: scalars[i + 1] / V for i, k in enumerate(names)}
    metrics["loss"] = scalars[0]
    return new_ts, metrics


def dp_step_in_place(plan: DPPlan, ts: TrainState, batch: ViewBatch,
                     uv: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """What the compiled step (parallel/compiled.py) captures: `dp_compute`
    whose new state is written into the buffers of `ts` (every tensor the
    step replaces). Returns the 0-d metrics."""
    new_ts, metrics = dp_compute(plan, ts, batch, uv)
    copy_into(ts, new_ts)
    return metrics


def make_dp_train_step(
    cfg: TrainConfig,
    mesh=None,
    use_exposure: bool = False,
    grad_reduce_dtype: Optional[torch.dtype] = None,
    replicate_preprocessed: bool = False,
    shard_gaussians: bool = False,
):
    """A view-parallel step over `mesh` (a parallel.mesh.make_mesh mesh, or
    None for one process). Returns (step, place):

      * `place(ts, batch)` → (this rank's state, its views): rank 0's state
        on every rank; the views of this rank's data index (V must split
        evenly); with `shard_gaussians` the row fields split over the model
        dimension (`shard_rows`);
      * `step(ts, batch, uv=None)` → (new state, metrics): `batch` is this
        rank's stacked views. The state must be split as this step splits
        it (`TrainState.rows_split`), else ValueError. `uv`: the (V, n, 2)
        multi-view pixel samples of ALL V views of the step, in view order;
        by default a batch with a multi-view part draws them
        (`draw_dp_pixels`), and the new state carries the advanced copy of
        `ts.mv_generator`. The metrics are the mean over the V views of
        each scalar of the loss stack's aux, plus "loss".

    `grad_reduce_dtype` (torch.bfloat16) is the wire of the gradient
    all-reduce (SURVEY §7.3 #7): the flat buffer is cast down, summed in
    that type and cast back to float32 for Adam; None keeps float32.
    `parallel.compiled.compile_dp_train_step` is this step captured as a
    CUDA graph."""
    plan = dp_plan(cfg, mesh, use_exposure, grad_reduce_dtype, replicate_preprocessed, shard_gaussians)
    grp = plan.grp

    def step(ts: TrainState, batch: ViewBatch,
             uv: Optional[torch.Tensor] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        check_placement(plan, ts)
        mv_generator = ts.mv_generator
        if batch.multi_view is not None and uv is None:
            uv, mv_generator = draw_dp_pixels(plan, ts, batch)
        new_ts, metrics = dp_compute(plan, ts, batch, uv)
        return new_ts._replace(mv_generator=mv_generator), metrics

    def place(ts: TrainState, batch: ViewBatch) -> Tuple[TrainState, ViewBatch]:
        """Rank 0's state on every rank (params replicated), this rank's
        views; with `shard_gaussians` the row fields split over the model
        dimension instead (SURVEY §2.4 row 2)."""
        V = num_views(batch)
        if V % grp.n_data:
            raise ValueError(f"{V} views do not split over {grp.n_data} data ranks")
        if mesh is not None:
            dev = ts.gaussians.alive.device

            def bcast(x):
                return _broadcast(x, dev)

            g = ts.gaussians
            ts = _with_row_leaves(ts, [bcast(x) for x in _row_leaves(ts)])
            ts = ts._replace(
                gaussians=ts.gaussians._replace(active_sh_degree=bcast(g.active_sh_degree),
                                                spatial_lr_scale=bcast(g.spatial_lr_scale)),
                exposure=bcast(ts.exposure), exposure_m=bcast(ts.exposure_m), exposure_v=bcast(ts.exposure_v),
                step=bcast(ts.step), generator=_broadcast_generator(ts.generator, dev),
                mv_generator=_broadcast_generator(ts.mv_generator, dev))
        if plan.sharded:
            ts = shard_rows(ts, mesh)
        V_local = V // grp.n_data
        return ts, select_views(batch, grp.data_index * V_local, (grp.data_index + 1) * V_local)

    return step, place
