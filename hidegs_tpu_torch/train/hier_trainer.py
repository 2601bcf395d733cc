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
from hidegs_tpu_torch.train.loop import apply_exposure, step_backward
from hidegs_tpu_torch.train.losses import abs_, clip, dssim_l1


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
    leaves and, with `use_exposure`, the exposure."""
    params = GaussianParams(*(p.detach().requires_grad_(True) for p in ts.params))
    exposure = ts.exposure.detach().requires_grad_(use_exposure)
    xyz, scales, quats, opac, shs = hierarchy_to_arrays(params)
    ig = interpolate_cut(cut, xyz, scales, quats, opac, shs, skybox_count)
    out = render(ig.means3d, ig.scales, ig.quats, ig.opacities, ig.shs, cam, config=raster_cfg)
    img = out["render"]
    if use_exposure:
        img = apply_exposure(img, exposure[image_idx])
    # background pixels render as exactly 0: clip's tie gradient matters
    img = clip(img, 0.0, 1.0)
    loss = dssim_l1(img, gt_image, lambda_dssim)
    return loss, list(params) + ([exposure] if use_exposure else [])


def hier_step_update(
    ts: HierTrainState,
    cut: HierCut,
    grads,
    lr_cfg_tree: GaussianParams,
    skybox_count: int = 0,
    frozen: Optional[torch.Tensor] = None,
    use_exposure: bool = False,
    optimize_exposure: bool = False,
):
    """The update half: the visible mask of the cut, masked sparse Adam and
    the exposure Adam. Returns (new state, visible mask)."""
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

    new_params, new_opt = masked_adam_update(ts.params, param_grads, ts.opt, lr_cfg_tree, visible)
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
    Returns (new state, {"loss", "n_visible"} as 0-d tensors). The input
    state is left as it was."""
    loss, inputs = hier_step_forward(ts, cut, cam, gt_image, raster_cfg, lambda_dssim, skybox_count,
                                     image_idx, use_exposure)
    grads = step_backward(loss, inputs)
    new_ts, visible = hier_step_update(ts, cut, grads, lr_cfg_tree, skybox_count, frozen, use_exposure,
                                       optimize_exposure)
    return new_ts, {"loss": loss.detach(), "n_visible": visible.sum()}


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
    with random.Random(0), as in the JAX package; the host reads the
    device only at the log."""
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
    rnd = random.Random(0)
    for it in range(1, iterations + 1):
        i = rnd.randrange(len(cameras))
        cut = select_cut(ts, cameras[i], target_size, budget)
        lrs = lr_tree(ts.step, lr_cfg, 1.0)
        ts, m = hier_train_step(
            ts, cut, cameras[i], gts[i], lrs, raster_cfg,
            skybox_count=skybox_count, frozen=frozen,
            image_idx=i, use_exposure=use_expo,
            optimize_exposure=optimize_exposure,
        )
        if it % log_every == 0:
            loss, n_vis = torch.stack([m["loss"].double(), m["n_visible"].double()]).tolist()
            print(f"[hier {it}/{iterations}] loss={loss:.4f} visible={int(n_vis)}", flush=True)
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

