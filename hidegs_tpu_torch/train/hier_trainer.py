"""Hierarchy post-optimization: fine-tune a built hierarchy end-to-end.

Port of hidegs_tpu/train/hier_trainer.py. The reference trains leaves,
builds the hierarchy offline, then post-optimizes the hierarchy with
LOD-cut renders and the sparse optimizer (h3dgs flow; the pieces live in
create_from_hier gaussian_model.py:358-431 — opacity activation switches to
|x| — plus render_post and OurAdam.step(relevant)).

The hierarchy's gaussians become a GaussianParams (log-scale, |x|
opacity). Each step draws a camera, selects its LOD cut (not
differentiable), renders through the differentiable interpolation path and
applies the masked sparse Adam to every gaussian the cut touched: the
selected nodes AND their parents, whose gradients autograd routes through
the interpolation's gathers. A step is `select_cut`, `hier_step_forward`,
`step_backward` (train/loop.py) and `hier_step_update`; it reads nothing
back to the host. The gathers' backward is the sorted `index_put_` of
`attrs[idx]`, which sums the rows of parents that many slots share in a
fixed order, so the gradients are bitwise reproducible on the card.

Differences from the JAX version, each for the device: the hierarchy is
packed once per state (`HierTrainState.packed`) and every cut is an
`expand_packed`; `post_optimize` uploads the images once; the state has no
`rng` (the JAX state splits its key every step and never draws from it).
"""
from __future__ import annotations

import json
import os
import random
from typing import NamedTuple, Optional

import numpy as np
import torch

from hidegs_tpu_torch.core.transforms import normalize
from hidegs_tpu_torch.device import DeviceLike, resolve_device
from hidegs_tpu_torch.hier.interp import interpolate_cut
from hidegs_tpu_torch.hier.io import Hierarchy
from hidegs_tpu_torch.hier.lod import HierCut, PackedHier, expand_packed, pack_hierarchy
from hidegs_tpu_torch.model.adam import AdamState, init_adam, masked_adam_update
from hidegs_tpu_torch.model.gaussians import GaussianParams
from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
from hidegs_tpu_torch.raster.api import RasterConfig, render
from hidegs_tpu_torch.train.budgets import COUNTERS, OVERFLOW_CHECK_EVERY, BudgetRefit
from hidegs_tpu_torch.train.loop import apply_exposure, step_backward
from hidegs_tpu_torch.train.losses import abs_, clip, dssim_l1
from hidegs_tpu_torch.utils.graphs import GraphSet, _same_memory, _spec, _tensors, copy_into, on_card, require_cuda
from hidegs_tpu_torch.utils.profiling import span


class HierTrainState(NamedTuple):
    params: GaussianParams
    opt: AdamState
    nodes: torch.Tensor  # (N, 7) static topology
    boxes: torch.Tensor  # (N, 2, 4)
    packed: PackedHier  # pack_hierarchy(nodes, boxes), built once
    step: torch.Tensor  # () int32
    # per-image exposure compensation (create_from_hier loads pretrained
    # exposures alongside the .hier, gaussian_model.py:358-431); identity
    # when none were provided
    exposure: torch.Tensor  # (E, 3, 4)
    exposure_m: torch.Tensor
    exposure_v: torch.Tensor


def state_from_hierarchy(
    h: Hierarchy, num_images: int = 1, exposures: Optional[np.ndarray] = None, device: DeviceLike = "cuda",
) -> HierTrainState:
    """The post-opt state of `h` on `device`. `exposures` ((E, 3, 4), e.g.
    from load_exposures) seeds the per-image compensation the reference
    ingests with a pretrained hierarchy; identity otherwise."""
    dev = resolve_device(device)

    def tensor(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    params = GaussianParams(
        xyz=tensor(h.pos),
        sh_dc=tensor(h.shs[:, 0, :]),
        sh_rest=tensor(h.shs[:, 1:, :]),
        scaling=tensor(h.scale),  # already log
        rotation=tensor(h.rot),
        opacity=tensor(h.alpha),  # |x| activation, stored activated
    )
    if exposures is not None:
        expo = tensor(np.asarray(exposures, np.float32))
    else:
        eye34 = torch.zeros((3, 4), dtype=torch.float32, device=dev)
        eye34[:, :3] = torch.eye(3, device=dev)
        expo = eye34[None].repeat(max(num_images, 1), 1, 1)
    nodes, boxes = tensor(h.nodes), tensor(h.boxes)
    return HierTrainState(
        params=params,
        opt=init_adam(params),
        nodes=nodes,
        boxes=boxes,
        packed=pack_hierarchy(nodes, boxes),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        exposure=expo,
        exposure_m=torch.zeros_like(expo),
        exposure_v=torch.zeros_like(expo),
    )


def load_exposures(path: str, image_names=None) -> Optional[np.ndarray]:
    """Read an exposure.json (saved by train/checkpoint.py or the reference's
    scene/__init__.py:164-170) into an (E, 3, 4) array. Keys may be image
    names or integer indices; `image_names` orders name-keyed files."""
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    if not d:
        return None
    if image_names is not None and any(k in d for k in image_names):
        eye = np.zeros((3, 4), np.float32)
        eye[:, :3] = np.eye(3)
        return np.stack([np.asarray(d.get(name, eye), np.float32) for name in image_names])
    if not all(k.isdigit() for k in d):
        # a name-keyed file without image_names to order it: JSON insertion
        # order matched against cameras by index would mispair exposures
        # with images
        raise ValueError(f"{path} is keyed by image names; pass image_names= to order it")
    keys = sorted(d.keys(), key=int)
    return np.stack([np.asarray(d[k], np.float32) for k in keys])


def hierarchy_to_arrays(params: GaussianParams):
    """Activated rendering arrays from hierarchy params (|x| opacity)."""
    return (
        params.xyz,
        torch.exp(params.scaling),
        normalize(params.rotation),
        abs_(params.opacity),
        torch.cat([params.sh_dc[:, None, :], params.sh_rest], dim=1),
    )


def select_cut(ts: HierTrainState, cam, target_size, budget: int) -> HierCut:
    """The LOD cut of `cam` from the packed hierarchy, on the device (the
    viewpoint is the camera's device tensor)."""
    return expand_packed(ts.packed, target_size, cam.camera_center, budget=budget,
                         num_points=int(ts.params.xyz.shape[0]))


def image_row(exposure: torch.Tensor, image_idx) -> torch.Tensor:
    """exposure[image_idx] for an int or a 0-d integer tensor. A tensor
    index is read as a one-element gather: indexing with a 0-d tensor reads
    it to the host, which a CUDA graph cannot capture (JAX traces the
    index, hidegs_tpu/train/hier_trainer.py:168)."""
    if isinstance(image_idx, torch.Tensor):
        return exposure[image_idx.reshape(1).long()][0]
    return exposure[image_idx]


def _hier_forward(ts, cut, cam, gt_image, raster_cfg, lambda_dssim, skybox_count, image_idx, use_exposure):
    """hier_step_forward, and the render's output dict."""
    params = GaussianParams(*(p.detach().requires_grad_(True) for p in ts.params))
    exposure = ts.exposure.detach().requires_grad_(use_exposure)
    xyz, scales, quats, opac, shs = hierarchy_to_arrays(params)
    ig = interpolate_cut(cut, xyz, scales, quats, opac, shs, skybox_count)
    out = render(ig.means3d, ig.scales, ig.quats, ig.opacities, ig.shs, cam, config=raster_cfg)
    img = out["render"]
    if use_exposure:
        img = apply_exposure(img, image_row(exposure, image_idx))
    # background pixels render as exactly 0: clip's tie gradient matters
    img = clip(img, 0.0, 1.0)
    loss = dssim_l1(img, gt_image, lambda_dssim)
    return loss, list(params) + ([exposure] if use_exposure else []), out


def hier_step_forward(
    ts: HierTrainState,
    cut: HierCut,
    cam,
    gt_image: torch.Tensor,
    raster_cfg: RasterConfig,
    lambda_dssim: float = 0.2,
    skybox_count: int = 0,
    image_idx=0,
    use_exposure: bool = False,
):
    """The forward half of a step: interpolate the cut, render, loss, on
    fresh leaves that require grad. Returns (loss, inputs): the params'
    leaves and, with `use_exposure`, the exposure. `image_idx` is an int or
    a 0-d integer tensor."""
    loss, inputs, _ = _hier_forward(ts, cut, cam, gt_image, raster_cfg, lambda_dssim, skybox_count, image_idx,
                                    use_exposure)
    return loss, inputs


def hier_step_update(
    ts: HierTrainState,
    cut: HierCut,
    grads,
    lr_cfg_tree: GaussianParams,
    skybox_count: int = 0,
    frozen: Optional[torch.Tensor] = None,
    use_exposure: bool = False,
    optimize_exposure: bool = False,
    in_place: bool = False,
):
    """The update half: the visible mask of the cut, masked sparse Adam and
    the exposure Adam. Returns (new state, visible mask). `in_place`: Adam
    writes the params and moments into the buffers of `ts` (a step that
    donates its state)."""
    P = ts.params.xyz.shape[0]
    param_grads = GaussianParams(*grads[:len(GaussianParams._fields)])
    # visible = gaussians referenced by the cut (children) or as parents;
    # padding slots point at row P of a (P+1,) buffer, which is dropped.
    # A destination that repeats always gets the same value.
    visible = torch.zeros((P + 1,), dtype=torch.bool, device=cut.valid.device)
    visible.index_put_((cut.render_indices.long(),), cut.valid)
    visible.index_put_((cut.parent_indices.long(),), cut.valid)
    visible = visible[:P]
    if skybox_count:
        visible[P - skybox_count:] = True
    if frozen is not None:
        visible = visible & ~frozen

    new_params, new_opt = masked_adam_update(ts.params, param_grads, ts.opt, lr_cfg_tree, visible, in_place=in_place)
    if use_exposure and optimize_exposure:
        expo_grads = grads[-1]
        b1, b2, eps = 0.9, 0.999, 1e-8
        t = torch.clamp(ts.step + 1, min=1).to(torch.float32)
        m = b1 * ts.exposure_m + (1 - b1) * expo_grads
        v = b2 * ts.exposure_v + (1 - b2) * expo_grads**2
        new_expo = ts.exposure - 1e-3 * (m / (1 - b1**t)) / (torch.sqrt(v / (1 - b2**t)) + eps)
    else:
        m, v, new_expo = ts.exposure_m, ts.exposure_v, ts.exposure
    new_ts = ts._replace(params=new_params, opt=new_opt, step=ts.step + 1, exposure=new_expo.detach(),
                         exposure_m=m.detach(), exposure_v=v.detach())
    return new_ts, visible


def hier_train_step(
    ts: HierTrainState,
    cut: HierCut,
    cam,
    gt_image: torch.Tensor,
    lr_cfg_tree: GaussianParams,
    raster_cfg: RasterConfig,
    lambda_dssim: float = 0.2,
    skybox_count: int = 0,
    frozen: Optional[torch.Tensor] = None,
    image_idx=0,
    use_exposure: bool = False,
    optimize_exposure: bool = False,
):
    """One post-opt step on a fixed LOD cut. `frozen` (P,) bool excludes
    gaussians from the sparse update — used for anchors.bin gaussians, which
    render at full detail from every training view and must keep their
    chunk-trained appearance (anchors loaded at gaussian_model.py:366-374).

    `use_exposure` applies ts.exposure[image_idx] to the render (the
    pretrained-exposure ingestion of create_from_hier,
    gaussian_model.py:358-431); `optimize_exposure` additionally trains it
    with a small dense Adam like the main loop's exposure optimizer.
    Returns (new state, metrics): "loss" and "n_visible", 0-d, and
    "counters", the render's budget counters (train/budgets.py:COUNTERS)
    as one int64 tensor, in that order. The input state is left as it
    was."""
    return _train_step(ts, cut, cam, gt_image, lr_cfg_tree, raster_cfg, lambda_dssim, skybox_count, frozen, image_idx,
                       use_exposure, optimize_exposure)


def _train_step(ts, cut, cam, gt_image, lr_cfg_tree, raster_cfg, lambda_dssim, skybox_count, frozen, image_idx,
                use_exposure, optimize_exposure, in_place=False):
    """`hier_train_step`'s body, which the captured step runs too
    (`in_place`: as `hier_step_update`'s)."""
    loss, inputs, out = _hier_forward(ts, cut, cam, gt_image, raster_cfg, lambda_dssim, skybox_count, image_idx,
                                      use_exposure)
    grads = step_backward(loss, inputs)
    new_ts, visible = hier_step_update(ts, cut, grads, lr_cfg_tree, skybox_count, frozen, use_exposure,
                                       optimize_exposure, in_place)
    counters = torch.stack([out[k].to(torch.int64) for k in COUNTERS])
    return new_ts, {"loss": loss.detach(), "n_visible": visible.sum(), "counters": counters}


# ---------------------------------------------------------------------------
# the compiled post-opt step

# the fields of HierTrainState a step writes; the topology (nodes, boxes,
# packed) is only read, by the cut, and is held by reference
_STEP_FIELDS = ("params", "opt", "step", "exposure", "exposure_m", "exposure_v")


def _written(ts: HierTrainState) -> tuple:
    return tuple(getattr(ts, f) for f in _STEP_FIELDS)


def hier_static_key(ts: HierTrainState, cut: HierCut, cam, gt_image: torch.Tensor, lr_cfg_tree: GaussianParams,
                    raster_cfg: RasterConfig, lambda_dssim: float = 0.2, skybox_count: int = 0,
                    frozen: Optional[torch.Tensor] = None, use_exposure: bool = False,
                    optimize_exposure: bool = False) -> tuple:
    """The key a post-opt step graph is captured for: what `jax.jit`
    retraces `hier_train_step` on, its static arguments and the shapes,
    dtypes and non-tensor leaves of the others (the learning rates' float
    leaves, the image size, whether `frozen` is given). The image index is
    a traced input, not part of the key."""
    return (raster_cfg, float(lambda_dssim), int(skybox_count), bool(use_exposure), bool(optimize_exposure),
            _spec(ts), _spec(cut), _spec(cam), _spec(gt_image), _spec(lr_cfg_tree), _spec(frozen))


def select_static_key(ts: HierTrainState, target_size, budget: int) -> tuple:
    """The key a cut graph is captured for: JAX's static arguments of
    `expand_packed` (budget, num_points), the packed hierarchy's shapes and
    a float target's value (a tensor target is an input)."""
    return (int(budget), int(ts.params.xyz.shape[0]), _spec(ts.packed), _spec(target_size))


def hier_step_in_place(ts: HierTrainState, cut: HierCut, cam, gt_image: torch.Tensor, lr_cfg_tree: GaussianParams,
                       raster_cfg: RasterConfig, lambda_dssim: float = 0.2, skybox_count: int = 0,
                       frozen: Optional[torch.Tensor] = None, image_idx=0, use_exposure: bool = False,
                       optimize_exposure: bool = False):
    """What a post-opt graph captures: one `hier_train_step` whose new
    params, moments, step and exposure are written into the buffers of
    `ts` (the params and moments by Adam itself). Returns its metrics, as
    `hier_train_step`'s."""
    new, metrics = _train_step(ts, cut, cam, gt_image, lr_cfg_tree, raster_cfg, lambda_dssim, skybox_count, frozen,
                               image_idx, use_exposure, optimize_exposure, in_place=True)
    for dst, src in zip(_tensors(_written(ts)), _tensors(_written(new)), strict=True):
        if not _same_memory(dst, src):
            dst.copy_(src)
    return metrics


class CompiledHierTrainStep(GraphSet):
    """`hier_train_step` compiled, the counterpart of the JAX package's
    `jax.jit(hier_train_step, static_argnames=(raster_cfg, lambda_dssim,
    skybox_count, use_exposure, optimize_exposure), donate_argnums=(0,))`
    (hidegs_tpu/train/hier_trainer.py:136-147), with `select` for the cut
    (JAX's own `expand_packed` executable). Called as `hier_train_step` is,
    on a state on a CUDA device; returns (state, {"loss", "n_visible"}).
    Both are utils/graphs.py's `GraphSet.run`:

      * the static key (`hier_static_key`) is what JAX retraces on; a new
        key warms the step up on a scratch copy of the state, then
        captures `hier_step_in_place`. The image index is an input (an int
        is written into it, a tensor copied), so every view replays one
        graph;
      * donation: the captured step ends by writing the new state into the
        static state buffers, and the returned state is those buffers (with
        the caller's topology, `nodes`, `boxes` and `packed`, which the step
        does not read). The state a replay returned is consumed by the next
        replay, as JAX invalidates a donated argument; a fresh state is
        copied in;
      * the cut, camera, target image, learning rates and `frozen` are
        copied into the graph's static inputs before each replay, except
        where they already are them;
      * `select(ts, cam, target_size, budget)` replays the cut of
        `select_cut` captured per `select_static_key`; the packed
        hierarchy is held by reference (it is constant for the state's
        lifetime; a call with another one raises), the viewpoint is copied
        in;
      * the metrics (the render's budget counters among them, `counters`,
        in the order of train/budgets.py:COUNTERS) and the cut are static
        tensors of graphs that share one pool: valid until the next replay
        of either graph.

    There is no fallback: a state off the card raises ValueError, a failed
    capture RuntimeError. `captures` and `replays` are GraphSet's."""

    def __init__(self):
        super().__init__("the post-opt step")

    def select(self, ts: HierTrainState, cam, target_size, budget: int) -> HierCut:
        """`select_cut(ts, cam, target_size, budget)` as a graph replay."""
        dev = ts.params.xyz.device
        require_cuda(dev, "the compiled post-opt step", "select_cut and hier_train_step")
        target = target_size if isinstance(target_size, torch.Tensor) else float(target_size)

        def body(_, target, viewpoint):
            return expand_packed(ts.packed, target, viewpoint, budget=budget, num_points=int(ts.params.xyz.shape[0]))

        cut, _ = self.run(select_static_key(ts, target_size, budget), dev, body, (target, cam.camera_center),
                          held=ts.packed, info=dict(kind="cut", budget=int(budget)))
        return cut

    def __call__(self, ts: HierTrainState, cut: HierCut, cam, gt_image: torch.Tensor, lr_cfg_tree: GaussianParams,
                 raster_cfg: RasterConfig, lambda_dssim: float = 0.2, skybox_count: int = 0,
                 frozen: Optional[torch.Tensor] = None, image_idx=0, use_exposure: bool = False,
                 optimize_exposure: bool = False):
        dev = ts.params.xyz.device
        require_cuda(dev, "the compiled post-opt step", "hier_train_step")
        key = hier_static_key(ts, cut, cam, gt_image, lr_cfg_tree, raster_cfg, lambda_dssim, skybox_count, frozen,
                              use_exposure, optimize_exposure)
        idx = self.scalar("image_idx", dev, torch.int64)
        if isinstance(image_idx, torch.Tensor):
            copy_into(idx, image_idx.reshape(()))
        else:
            idx.fill_(int(image_idx))

        def body(written, cut, cam, gt_image, lrs, frozen):
            return hier_step_in_place(ts._replace(**dict(zip(_STEP_FIELDS, written))), cut, cam, gt_image, lrs,
                                      raster_cfg, lambda_dssim, skybox_count, frozen, idx, use_exposure,
                                      optimize_exposure)

        info = dict(kind="step", budget=int(cut.valid.shape[0]), image=tuple(gt_image.shape[-2:]),
                    max_instances=raster_cfg.max_instances)
        metrics, state = self.run(key, dev, body, (cut, cam, gt_image, lr_cfg_tree, frozen), state=_written(ts),
                                  info=info)
        return ts._replace(**dict(zip(_STEP_FIELDS, state))), metrics


def post_optimize(
    h: Hierarchy,
    cameras,
    images,
    iterations: int = 2000,
    target_size: float = 0.01,
    budget: Optional[int] = None,
    raster_cfg: Optional[RasterConfig] = None,
    lr_cfg: Optional[LRConfig] = None,
    skybox_count: int = 0,
    log_every: int = 100,
    anchors=None,
    exposures: Optional[np.ndarray] = None,
    optimize_exposure: bool = False,
    device: DeviceLike = "cuda",
) -> HierTrainState:
    """Host loop: post-optimize `h` on `device` against (cameras[i],
    images[i]) pairs, the cameras' CameraParams on that device and the
    images (3, H, W) arrays or tensors, uploaded once. `anchors` (int32
    indices from io.read_anchors) are frozen throughout. `exposures`
    ((len(cameras), 3, 4)) seeds per-image compensation (the
    create_from_hier pretrained-exposure ingestion); `optimize_exposure`
    trains it (fresh identity when no seed was given). Views are drawn
    with random.Random(0), as in the JAX package.

    On a card every iteration is two graph replays, the cut and the step
    (`CompiledHierTrainStep`, JAX's two executables `expand_packed` and
    `hier_train_step`); on the CPU the eager `select_cut` and
    `hier_train_step`. The image index is a device tensor, so one graph
    serves every view.

    The render's budgets start from `raster_cfg` and are re-fitted from the
    steps' counters by the leaf trainer's rule (train/budgets.py): the host
    reads the counters of OVERFLOW_CHECK_EVERY steps in one copy, and the
    loss at the log, and nothing else. A new budget is a new key of the
    compiled step, which captures it and keeps the old graphs.

    Each iteration is a `postopt.iteration` span (utils/profiling.py) whose
    request is the iteration: inside it `postopt.select` (with `budget`,
    the cut's slots), `postopt.step` (with `image`, its height and width,
    and the budgets in force: `max_instances`, `max_blocks`,
    `max_visible`), and the host's reads as wait spans,
    `postopt.read_budgets` (with `refit`, 1 when a budget changed) and
    `postopt.read_log`."""
    dev = resolve_device(device)
    ts = state_from_hierarchy(h, num_images=len(cameras), exposures=exposures, device=dev)
    use_expo = exposures is not None or optimize_exposure
    frozen = None
    if anchors is not None and len(anchors):
        frozen = torch.zeros((h.num_points,), dtype=torch.bool, device=dev)
        frozen[torch.as_tensor(np.asarray(anchors), device=dev).long()] = True
    budget = budget or 1 << int(np.ceil(np.log2(max(h.num_points, 1024))))
    raster_cfg = raster_cfg or RasterConfig(backend="blend", max_instances=1 << 18)
    lr_cfg = lr_cfg or LRConfig()
    gts = [torch.as_tensor(im, dtype=torch.float32, device=dev) for im in images]
    image_ids = torch.arange(len(cameras), device=dev)
    if on_card(dev):
        compiled = CompiledHierTrainStep()
        select, step = compiled.select, compiled
    else:
        select, step = select_cut, hier_train_step
    refit = BudgetRefit()
    pending = []  # each step's budget counters, read in windows
    rnd = random.Random(0)
    for it in range(1, iterations + 1):
        with span("postopt.iteration", request=it):
            if len(pending) >= OVERFLOW_CHECK_EVERY:
                with span("postopt.read_budgets", wait=True, refit=0) as read:
                    vals = [tuple(int(x) for x in row) for row in torch.stack(pending).tolist()]
                pending = []
                raster_cfg, changed = refit.update(raster_cfg, vals, it, budget)
                if changed:
                    read.set(refit=1)
            i = rnd.randrange(len(cameras))
            with span("postopt.select", budget=budget):
                cut = select(ts, cameras[i], target_size, budget)
            lrs = lr_tree(ts.step, lr_cfg, 1.0)
            with span("postopt.step", image=tuple(gts[i].shape[-2:]), max_instances=raster_cfg.max_instances,
                      max_blocks=raster_cfg.max_blocks, max_visible=raster_cfg.max_visible):
                ts, m = step(
                    ts, cut, cameras[i], gts[i], lrs, raster_cfg,
                    skybox_count=skybox_count, frozen=frozen,
                    image_idx=image_ids[i], use_exposure=use_expo,
                    optimize_exposure=optimize_exposure,
                )
            # copied: the next replay overwrites the step's outputs
            pending.append(m["counters"].clone())
            if it % log_every == 0:
                with span("postopt.read_log", wait=True):
                    loss, n_vis = torch.stack([m["loss"].double(), m["n_visible"].double()]).tolist()
                print(f"[hier {it}/{iterations}] loss={loss:.4f} visible={int(n_vis)}", flush=True)
    if pending:
        refit.dropped_instances += sum(row[0] for row in torch.stack(pending).tolist())
    if refit.dropped_instances:
        print(f"[hier] run summary: {refit.dropped_instances} instances were dropped by budget overflows before "
              f"re-budgeting caught up; the last instance budget {raster_cfg.max_instances}", flush=True)
    return ts


def hierarchy_from_state(ts: HierTrainState, h_template: Hierarchy) -> Hierarchy:
    """Write optimized params back into a Hierarchy (for write_hier)."""
    def host(x):
        return x.detach().cpu().numpy()

    p = ts.params
    return Hierarchy(
        pos=host(p.xyz),
        rot=host(normalize(p.rotation)),
        scale=host(p.scaling),
        alpha=host(abs_(p.opacity)),
        shs=host(torch.cat([p.sh_dc[:, None, :], p.sh_rest], dim=1)),
        nodes=h_template.nodes,
        boxes=h_template.boxes,
    )

