# Frozen copy of hidegs_tpu_torch/raster/api.py:1-252 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Public render API.

Port of hidegs_tpu/raster/api.py. Output-dict compatible with the JAX
package (and with it the reference renderer): render / invdepth / alpha /
T_final / out_observe / radii / visibility, the budget counters, and with
`render_geo` the rendered_normal / rendered_distance / plane_depth /
depth_normal planes.

Backends (`RasterConfig.backend`):
  * "blend" (default): the hand-written CUDA forward and backward blend on
    CUDA tensors (raster/cuda_blend.py), their plain PyTorch versions on CPU
    tensors, behind the autograd Function of raster/blend_autograd.py;
  * "plain": the plain PyTorch blend on any device, differentiated by
    autograd (tests, and holding the kernels against it);
  * "oracle": the dense reference rasterizer.
`render` runs on the device its inputs lie on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from gsbench.reference.core import sh as shm
from gsbench.reference.core.camera_math import CameraParams
from gsbench.reference.core.geometry import depth_to_normal_cam, plane_depth_from_blend
from gsbench.reference.raster import blend_autograd, blend_plain
from gsbench.reference.raster.binning import TILE, bin_gaussians, tile_grid
from gsbench.reference.raster.oracle import render_oracle
from gsbench.reference.raster.preprocess import compact_visible, preprocess_gaussians

RenderOutputs = Dict[str, torch.Tensor]

BACKENDS = ("blend", "plain", "oracle")
_RENAMED = {"pallas": "blend", "jnp": "plain"}


@dataclass(frozen=True)
class RasterConfig:
    """Rasterization settings."""

    tile: int = TILE
    max_instances: int = 1 << 20  # static instance budget; overflow is counted
    backend: str = "blend"  # "blend" | "plain" | "oracle"
    antialias: bool = True
    # 0 = exact lexicographic (tile, depth) sort; >0 = single-key sort with
    # this many depth-quantization bits; -1 = the widest that fits an int32
    depth_sort_bits: int = 0
    # budget of 128-instance blocks (each tile's span padded to a multiple of
    # 128); tiles past it render empty and the excess is `block_overflow`.
    # 0 = no cap.
    max_blocks: int = 0
    # with 0 < max_visible < N, visible rows are packed into a
    # (max_visible,)-row buffer before binning; excess is `visible_overflow`
    max_visible: int = 0
    # "blend" backend: blend the bf16 attribute stream (each instance's
    # attributes rounded to bfloat16, mean2d re-based to its tile first;
    # float32 arithmetic; raster/blend_plain.py). EXPERIMENTAL and off, as
    # in the JAX package, whose "jnp" backend ignores it as "plain" and
    # "oracle" do here.
    bf16_stream: bool = False
    # optional callable applied to the capacity-sized PreprocessedGaussians
    # before compaction and binning; returns the rows the rest of the render
    # uses. A gaussian-sharded step (parallel/sharded.py) gathers the model
    # group's preprocessed rows here, so that each rank preprocesses only
    # its own rows (docs/SHARDING.md). None = no-op.
    pre_constraint: Optional[Callable] = None

    def __post_init__(self):
        if self.backend in _RENAMED:
            raise ValueError(
                f"backend {self.backend!r} is the JAX package's; in this port use "
                f"backend={_RENAMED[self.backend]!r}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")


def _check_same_device(cam: CameraParams, *tensors) -> torch.device:
    dev = tensors[0].device
    for x in (cam.R, cam.t, cam.fx, cam.fy, cam.cx, cam.cy) + tensors[1:]:
        if x is not None and x.device != dev:
            raise ValueError(f"render inputs span {dev} and {x.device}; move them to one device")
    return dev


def render(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    cam: CameraParams,
    background: Optional[torch.Tensor] = None,
    active_sh_degree=shm.MAX_SH_DEGREE,
    render_geo: bool = False,
    colors_precomp: Optional[torch.Tensor] = None,
    config: RasterConfig = RasterConfig(),
    mean2d_offset: Optional[torch.Tensor] = None,
    boxmin: Optional[torch.Tensor] = None,
    boxmax: Optional[torch.Tensor] = None,
    box_exempt: Optional[torch.Tensor] = None,
) -> RenderOutputs:
    """Render a set of 3D Gaussians into `cam`, on the inputs' device.

    Dead gaussians must carry opacity 0, which culls them here.
    `boxmin`/`boxmax`/`box_exempt`: optional chunk-AABB cull (see
    preprocess_gaussians).
    """
    dev = _check_same_device(cam, means3d, scales, quats, opacities, shs, background,
                             colors_precomp, mean2d_offset, boxmin, boxmax, box_exempt)
    if background is None:
        background = torch.zeros(3, dtype=torch.float32, device=dev)
    H, W = cam.height, cam.width
    tiles_y, tiles_x = tile_grid(H, W, config.tile)

    pre = preprocess_gaussians(
        means3d, scales, quats, opacities, shs, cam,
        active_sh_degree=active_sh_degree,
        render_geo=render_geo,
        colors_precomp=colors_precomp,
        antialias=config.antialias,
        mean2d_offset=mean2d_offset,
        boxmin=boxmin,
        boxmax=boxmax,
        box_exempt=box_exempt,
        screen_bounds=(tiles_x * config.tile, tiles_y * config.tile),
    )
    if config.pre_constraint is not None:
        pre = config.pre_constraint(pre)

    if config.backend == "oracle":
        out = render_oracle(pre, cam, background=background, render_geo=render_geo)
        out["radii"] = pre.radius
        out["visibility"] = pre.visible & (pre.radius > 0)
        return out

    # full-model (N-domain) outputs captured before any compaction
    radii_full = pre.radius
    visible_full = pre.visible & (pre.radius > 0)
    N_full = pre.visible.shape[0]
    vidx = None
    num_visible = torch.sum(visible_full.to(torch.int32))
    visible_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if 0 < config.max_visible < N_full:
        pre, vidx, num_visible, visible_overflow = compact_visible(pre, config.max_visible)

    tb = bin_gaussians(
        pre, tiles_y, tiles_x, config.max_instances, config.tile,
        depth_bits=config.depth_sort_bits,
    )
    if config.backend == "blend":
        planes = blend_autograd.blend_tiles(pre, tb, tiles_y, tiles_x, config.tile, config.max_blocks,
                                            config.bf16_stream)
    else:
        planes = blend_plain.blend_tiles(pre, tb, tiles_y, tiles_x, config.tile, config.max_blocks)
    blocks_needed = blend_plain.needed_blocks(tb.tile_count)
    block_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if config.max_blocks:
        block_overflow = torch.clamp(blocks_needed - config.max_blocks, min=0)

    def crop(x):
        return x[..., :H, :W]

    color = crop(planes["render"]) + crop(planes["T_final"])[None] * background[:, None, None]
    observe = planes["out_observe"]
    if vidx is not None:
        # blend outputs are in the compacted domain: scatter per-gaussian
        # counts back to model rows (padding slots carry index N and drop)
        full = torch.zeros((N_full + 1,), dtype=observe.dtype, device=dev)
        full[vidx.long()] = observe
        observe = full[:N_full]
    out: RenderOutputs = {
        "render": color,
        "invdepth": crop(planes["invdepth"]),
        "alpha": crop(planes["alpha"]),
        "T_final": crop(planes["T_final"]),
        "out_observe": observe,
        "radii": radii_full,
        "visibility": visible_full,
        "overflow": tb.overflow,
        "block_overflow": block_overflow,
        # demand counters for host-side re-budgeting (grow AND shrink)
        "num_instances": tb.num_instances,
        "needed_blocks": blocks_needed,
        "num_visible": num_visible,
        "visible_overflow": visible_overflow,
    }
    if render_geo:
        nrm = crop(planes["normal"])
        dist = crop(planes["distance"])
        out["rendered_normal"] = nrm
        out["rendered_distance"] = dist
        out["plane_depth"] = plane_depth_from_blend(dist, nrm.permute(1, 2, 0), cam)
        # normal re-derived from the plane depth map, for the single-view loss
        out["depth_normal"] = depth_to_normal_cam(out["plane_depth"], cam).permute(2, 0, 1)
    return out


def render_coarse(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    cam: CameraParams,
    indices: Optional[torch.Tensor] = None,
    background: Optional[torch.Tensor] = None,
    active_sh_degree=shm.MAX_SH_DEGREE,
    config: RasterConfig = RasterConfig(),
) -> RenderOutputs:
    """Color-only render of an optional index subset (the reference's
    render_coarse). With `indices`, `visibility` is subset-indexed; map it
    back with `scatter_subset_visibility`."""
    if indices is not None:
        idx = indices.long()
        means3d, scales, quats, opacities, shs = (
            means3d[idx], scales[idx], quats[idx], opacities[idx], shs[idx]
        )
    out = render(
        means3d, scales, quats, opacities, shs, cam,
        background=background, active_sh_degree=active_sh_degree,
        render_geo=False, config=config,
    )
    if indices is not None:
        out["subset_indices"] = indices
    return out


def scatter_subset_visibility(vis_subset: torch.Tensor, indices: torch.Tensor, n_full: int) -> torch.Tensor:
    """Expand subset visibility back to the full array."""
    out = torch.zeros((n_full,), dtype=torch.bool, device=vis_subset.device)
    out[indices.long()] = vis_subset
    return out


def round_budget(want: int) -> int:
    """Round a budget up to the next quarter-octave step (m·2^k, m ∈
    {16,20,24,28}): at most +25% over-provisioning."""
    want = max(int(want), 1 << 10)
    k = (want - 1).bit_length() - 5  # 16·2^k < want ≤ 32·2^k
    for m in (16, 20, 24, 28):
        if m << k >= want:
            return m << k
    return 32 << k


def suggest_max_instances(n_gaussians: int, mult: int = 8, floor: int = 1 << 16) -> int:
    """Heuristic static budget: `mult` tile-instances per gaussian, rounded
    up to a quarter-octave step."""
    return round_budget(max(floor, mult * n_gaussians))
