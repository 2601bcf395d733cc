# Frozen copy of hidegs_tpu_torch/train/hier_trainer.py:61-114 and :138-275 at commit b3cd3be (the
# post-opt state, the cut and the eager step), the benchmark's plain reference: imports point into
# gsbench.reference; edits are marked "frozen copy:".
"""The hierarchy post-optimizer's state and its eager step.

The h3dgs hierarchy optimization (Kerbl et al. 2024): create_from_hier
(gaussian_model.py:358-431: |x| opacity, per-image exposures) and
render_post (gaussian_renderer/__init__.py:217-374: each selected
gaussian lerped with its parent). Departures from those, as the program
has them: the hierarchy is packed once per state and every cut is an
`expand_packed`; the interpolation's backward is autograd of its gathers
(the reference's backward.cu:459-495 is hand-written); the padding slots
of a cut gather row (slot mod P); the sparse Adam updates every row the
cut touched, parents included, and the exposure has a dense Adam of its
own at lr 1e-3.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gsbench.reference.core.transforms import normalize
from gsbench.reference.device import DeviceLike, resolve_device
from gsbench.reference.hier.interp import interpolate_cut
from gsbench.reference.hier.io import Hierarchy
from gsbench.reference.hier.lod import HierCut, PackedHier, expand_packed, pack_hierarchy
from gsbench.reference.model.adam import AdamState, init_adam, masked_adam_update
from gsbench.reference.model.gaussians import GaussianParams
from gsbench.reference.raster.api import RasterConfig, render
from gsbench.reference.train.loop import apply_exposure, step_backward
from gsbench.reference.train.losses import abs_, clip, dssim_l1

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
    Returns (new state, {"loss", "n_visible", "overflow"} as 0-d tensors).
    The input state is left as it was."""
    # frozen copy: the render's overflow is returned, so that the check can
    # grow its instance budget until nothing is dropped
    loss, inputs, out = _hier_forward(ts, cut, cam, gt_image, raster_cfg, lambda_dssim, skybox_count, image_idx,
                                      use_exposure)
    grads = step_backward(loss, inputs)
    new_ts, visible = hier_step_update(ts, cut, grads, lr_cfg_tree, skybox_count, frozen, use_exposure,
                                       optimize_exposure)
    return new_ts, {"loss": loss.detach(), "n_visible": visible.sum(), "overflow": out["overflow"]}
