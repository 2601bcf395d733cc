"""Hierarchy render path: parent/child interpolation and the skybox tail.

Port of hidegs_tpu/hier/interp.py, the reference's `render_post` with
interp_python=True (gaussian_renderer/__init__.py:217-324): the attributes
of each selected gaussian are lerped with its parent's by the smooth LOD
weight t (the rotation sign-aligned first), the skybox tail is appended with
t=1, and the LOD alpha correction α ← t·α + (1−t)·(1−(1−α)^(1/kids))
(forward.cu:547-556) is applied to the interpolated opacity. The result
feeds the ordinary `render`; as in the JAX package, the reference's
hand-written hierarchy backward (backward.cu:459-495) is autograd of these
gathers and lerps.

The gathers read one (P, 59) attribute matrix (`pack_attributes`: means,
scales, quats, opacity and the 48 SH values of each gaussian). The JAX
version concatenates it inside every call, ~470 MB per frame at 2M points;
`AdaptiveHierRenderer` builds it once per hierarchy and passes it in.

On a card the renderer replays each frame as a CUDA graph
(`CompiledLodFrame`, the counterpart of JAX's one jit dispatch per frame).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hidegs_tpu_torch.hier.io import Hierarchy
from hidegs_tpu_torch.hier.lod import (
    HierCut,
    PackedHier,
    cut_size_packed,
    expand_packed,
    expand_to_size,
    hierarchy_opacity_correction,
    pack_hierarchy,
)
from hidegs_tpu_torch.raster.api import RasterConfig, render, round_budget
from hidegs_tpu_torch.utils.graphs import GraphSet, _spec, on_card, require_cuda
from hidegs_tpu_torch.utils.profiling import span


class InterpolatedGaussians(NamedTuple):
    means3d: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    shs: torch.Tensor


def hierarchy_tensors(h: Hierarchy, device):
    """(nodes, boxes, means3d, scales, quats, opacities, shs) of `h` on
    `device`, scales activated (the file stores their logs)."""
    def tensor(x):
        return torch.as_tensor(x, device=device)

    return (tensor(h.nodes), tensor(h.boxes), tensor(h.pos), torch.exp(tensor(h.scale)), tensor(h.rot),
            tensor(h.alpha), tensor(h.shs))


def pack_attributes(means3d, scales, quats, opacities, shs) -> torch.Tensor:
    """(P, 11 + 48) rows [means(3) scales(3) quats(4) opacity(1) shs(48)]:
    the matrix `interpolate_cut` gathers from."""
    P = means3d.shape[0]
    return torch.cat([means3d, scales, quats, opacities[:, None], shs.reshape(P, -1)], dim=-1)


def interpolate_cut(
    cut: HierCut,
    means3d: torch.Tensor,  # (P, 3)
    scales: torch.Tensor,  # (P, 3) ACTIVATED
    quats: torch.Tensor,  # (P, 4)
    opacities: torch.Tensor,  # (P,) ACTIVATED
    shs: torch.Tensor,  # (P, 16, 3)
    skybox_count: int = 0,
    attrs: Optional[torch.Tensor] = None,
) -> InterpolatedGaussians:
    """The (B [+ skybox],) rendering arrays of one LOD cut.

    Invalid budget slots get opacity 0 (render culls them) and gather row
    (slot mod P), where the JAX package clamps them all to row P - 1: the
    gathers' backward sums each run of equal indices in one thread, and a
    million padding slots on one row cost ~0.8 s per gather on an H100.
    Skybox points are the LAST `skybox_count` gaussians (the reference keeps
    them at the tail, render_post:300-313). `attrs` is `pack_attributes` of
    the five arrays, built here when not given.
    """
    P = means3d.shape[0]
    if attrs is None:
        attrs = pack_attributes(means3d, scales, quats, opacities, shs)
    spread = torch.arange(cut.valid.shape[0], device=cut.valid.device) % P
    ri = torch.where(cut.valid, torch.clamp(cut.render_indices, max=P - 1).long(), spread)
    pi = torch.where(cut.valid, torch.clamp(cut.parent_indices, max=P - 1).long(), spread)
    t = cut.ts[:, None]
    row_c = attrs[ri]
    row_p = attrs[pi]
    sh_shape = shs.shape[1:]
    sh_dim = sh_shape[0] * sh_shape[1]

    m = t * row_c[:, 0:3] + (1 - t) * row_p[:, 0:3]
    s = t * row_c[:, 3:6] + (1 - t) * row_p[:, 3:6]
    sh = (t[..., None] * row_c[:, 11:11 + sh_dim].reshape(-1, *sh_shape)
          + (1 - t[..., None]) * row_p[:, 11:11 + sh_dim].reshape(-1, *sh_shape))

    rot_c = row_c[:, 6:10]
    rot_p = row_p[:, 6:10]
    dot = torch.sum(rot_c * rot_p, dim=-1, keepdim=True)
    sign = torch.where(dot < 0, -torch.ones_like(dot), torch.ones_like(dot))
    q = t * rot_c + (1 - t) * rot_p * sign

    op = cut.ts * row_c[:, 10] + (1 - cut.ts) * row_p[:, 10]
    op = hierarchy_opacity_correction(op, cut.ts, cut.kids)
    op = torch.where(cut.valid, op, torch.zeros_like(op))

    if skybox_count > 0:
        sky = slice(P - skybox_count, P)
        m = torch.cat([m, means3d[sky]])
        s = torch.cat([s, scales[sky]])
        q = torch.cat([q, quats[sky]])
        sh = torch.cat([sh, shs[sky]])
        op = torch.cat([op, opacities[sky]])
    return InterpolatedGaussians(m, s, q, op, sh)


def render_hierarchy(
    cut: HierCut,
    means3d,
    scales,
    quats,
    opacities,
    shs,
    cam,
    skybox_count: int = 0,
    background: Optional[torch.Tensor] = None,
    render_geo: bool = False,
    config: Optional[RasterConfig] = None,
    active_sh_degree: int = 3,
    attrs: Optional[torch.Tensor] = None,
):
    """render_post: interpolate the cut, then the ordinary render."""
    ig = interpolate_cut(cut, means3d, scales, quats, opacities, shs, skybox_count, attrs)
    return render(*ig, cam, background=background, active_sh_degree=active_sh_degree,
                  render_geo=render_geo, config=config or RasterConfig())


def render_coarse(
    nodes,
    boxes,
    means3d,
    scales,
    quats,
    opacities,
    shs,
    cam,
    coarse_target_size: float = 0.1,
    budget: int = 1 << 16,
    **kwargs,
):
    """Coarse render: a large-granularity LOD cut, the scaffold/coarse-opt
    path (render_coarse, gaussian_renderer/__init__.py:376-488) as the
    hierarchy render at a coarse target size."""
    cut = expand_to_size(nodes, boxes, coarse_target_size, cam.camera_center, budget=budget,
                         num_points=int(means3d.shape[0]))
    return render_hierarchy(cut, means3d, scales, quats, opacities, shs, cam, **kwargs)


def fused_lod_frame(
    packed: PackedHier,
    target_size,
    cam,
    means3d, scales, quats, opacities, shs,
    budget: int,
    num_points: int,
    skybox_count: int = 0,
    background=None,
    config: Optional[RasterConfig] = None,
    active_sh_degree: int = 3,
    render_geo: bool = False,
    attrs: Optional[torch.Tensor] = None,
):
    """Cut select, interpolation and raster of one frame in one call, with
    no host read; the render dict gains `num_selected`. (The JAX version is
    one jit dispatch; the reference's interactive loop one CUDA stream.)"""
    cut = expand_packed(packed, target_size, cam.camera_center, budget=budget, num_points=num_points)
    out = dict(render_hierarchy(
        cut, means3d, scales, quats, opacities, shs, cam, skybox_count=skybox_count,
        background=background, render_geo=render_geo, config=config,
        active_sh_degree=active_sh_degree, attrs=attrs))
    out["num_selected"] = cut.num_selected
    return out


def lod_frame_key(packed: PackedHier, target_size, cam, means3d, scales, quats, opacities, shs, budget: int,
                  num_points: int, skybox_count: int = 0, background=None, config: Optional[RasterConfig] = None,
                  active_sh_degree: int = 3, render_geo: bool = False, attrs: Optional[torch.Tensor] = None) -> tuple:
    """The key a LOD frame graph is captured for: JAX's static arguments of
    `fused_lod_frame` (budget, num_points, skybox_count, config,
    active_sh_degree, render_geo), the shapes of the hierarchy, its arrays,
    `attrs` and the camera (the image size), whether `background` is given
    and a float target's value (a tensor target is an input)."""
    return (int(budget), int(num_points), int(skybox_count), config or RasterConfig(), int(active_sh_degree),
            bool(render_geo), _spec(packed), _spec((means3d, scales, quats, opacities, shs)), _spec(attrs),
            _spec(cam), _spec(target_size), _spec(background))


class CompiledLodFrame(GraphSet):
    """`fused_lod_frame` captured once per static key (`lod_frame_key`) as
    a CUDA graph and replayed (utils/graphs.py's `GraphSet.run`): cut
    select (`expand_packed`), interpolation and raster in one replay, the
    forward blend kernel inside. Called as `fused_lod_frame` is, on a
    hierarchy on a CUDA device; the frame is not differentiable (the body
    runs under `torch.no_grad`).

      * the hierarchy (`packed`), its five arrays and `attrs` are held by
        reference: they never change for a renderer, and copying the
        (P, 59) attribute matrix per key would cost ~470 MB at 2M points.
        A call with other tensors for them raises: use one
        CompiledLodFrame per hierarchy;
      * the camera, a tensor target and the background are copied into
        the graph's static inputs before each replay;
      * the returned dict holds the graph's static tensors: the next
        replay of any of this callable's graphs (they share one pool)
        overwrites them, so a caller that keeps a frame past the next
        call clones it.

    There is no fallback: a hierarchy off the card raises ValueError, a
    failed capture RuntimeError."""

    def __init__(self):
        super().__init__("the LOD frame")

    @staticmethod
    def body(*args, **kwargs):
        """What a graph captures: `fused_lod_frame` under no_grad."""
        with torch.no_grad():
            return fused_lod_frame(*args, **kwargs)

    def __call__(self, packed: PackedHier, target_size, cam, means3d, scales, quats, opacities, shs, budget: int,
                 num_points: int, skybox_count: int = 0, background=None, config: Optional[RasterConfig] = None,
                 active_sh_degree: int = 3, render_geo: bool = False, attrs: Optional[torch.Tensor] = None):
        dev = packed.obox.device
        require_cuda(dev, "the compiled LOD frame", "fused_lod_frame")
        arrays = (means3d, scales, quats, opacities, shs)
        key = lod_frame_key(packed, target_size, cam, *arrays, budget, num_points, skybox_count, background, config,
                            active_sh_degree, render_geo, attrs)

        def body(_, target, c, bg):
            return self.body(packed, target, c, *arrays, budget=budget, num_points=num_points,
                             skybox_count=skybox_count, background=bg, config=config,
                             active_sh_degree=active_sh_degree, render_geo=render_geo, attrs=attrs)

        info = dict(budget=int(budget), image=(cam.height, cam.width), max_instances=key[3].max_instances)
        outputs, _ = self.run(key, dev, body, (target_size, cam, background), held=(packed, arrays, attrs), info=info)
        return dict(outputs)


class AdaptiveHierRenderer:
    """τ-aware hierarchy renderer: fits the cut, interpolation and raster
    budgets to the cut size of each (viewpoint, τ) instead of riding
    worst-case buffers.

    A count pass (`cut_size_packed`, one N-node reduction) sizes the budget;
    quarter-octave rounding (`round_budget`), +12% slack and shrink
    hysteresis keep the budgets few, while coarse cuts get proportionally
    small streams. The count is frame-coherent: consecutive frames at one τ
    from nearby viewpoints keep the counted size until the camera moves
    `recount_frac` of the scene diagonal or `recount_every` frames pass; a
    stale budget is caught by the num_selected check, which re-expands.
    Instance budgets start at two tile-instances per cut gaussian and
    regrow on overflow.

    Host reads per frame: the viewpoint (three floats, as JAX's renderer
    reads it to the host), the count only when the cache misses (a hit
    skips the count pass), and the three counters (num_selected, overflow,
    num_instances) together; a re-expansion or a regrow reads the counters
    again.

    On a card each cut-and-render call is a replay of `compiled`, a
    `CompiledLodFrame` (None off the card; set to None, the renderer calls
    the eager `fused_lod_frame`); the budgets are part of its key, so a
    re-expansion or a regrow captures once and replays afterwards. The
    frame it returns then holds the graph's static tensors, which the next
    `render` overwrites: a caller that keeps a frame clones it.
    """

    def __init__(self, nodes, boxes, means3d, scales, quats, opacities, shs,
                 num_points: int, skybox_count: int = 0,
                 backend: str = "blend", tile: int = 32,
                 slack: float = 1.12, shrink_factor: float = 0.5,
                 recount_frac: float = 0.01, recount_every: int = 60):
        self.nodes = nodes
        self.boxes = boxes
        self.arrays = (means3d, scales, quats, opacities, shs)
        self.num_points = int(num_points)
        self.skybox_count = int(skybox_count)
        lo = torch.amin(boxes[:, 0, :3], dim=0)
        hi = torch.amax(boxes[:, 1, :3], dim=0)
        diag = float(torch.linalg.norm(hi - lo))
        self.recount_dist = recount_frac * max(diag, 1e-6)
        self.recount_every = int(recount_every)
        self._count_cache = None
        self._packed = pack_hierarchy(nodes, boxes)
        self._attrs = pack_attributes(*self.arrays)
        self.backend = backend
        self.tile = tile
        self.slack = slack
        self.shrink_factor = shrink_factor
        self._budget = 0
        self._max_inst = 0
        self.compiled = CompiledLodFrame() if on_card(boxes.device) else None
        self.frames = 0  # frames rendered: the next frame's number

    @classmethod
    def from_hierarchy(cls, h: Hierarchy, device, **kwargs) -> "AdaptiveHierRenderer":
        """The renderer of a `Hierarchy` (hier.io) with its arrays on `device`."""
        return cls(*hierarchy_tensors(h, device), num_points=h.num_points, **kwargs)

    def _fit_budget(self, n_cut: int) -> int:
        want = round_budget(max(int(n_cut * self.slack), 1 << 10))
        if want > self._budget or want <= self._budget * self.shrink_factor:
            self._budget = want
        return min(self._budget, round_budget(self.num_points))

    @staticmethod
    def target_size(cam, tau_px: float) -> torch.Tensor:
        """The cut's target size for pixel granularity `tau_px` (0 = the
        exact leaf cut), on the camera's device without a host read: the
        float64 quotient of `tau_to_target_size`, rounded to float32 as the
        JAX package's jnp.float32(target) rounds it."""
        if tau_px == 0:
            return torch.zeros((), dtype=torch.float32, device=cam.fx.device)
        num = torch.full((), 2.0 * float(tau_px) + 1.0, dtype=torch.float64, device=cam.fx.device)
        return (num / cam.fx.to(torch.float64)).to(torch.float32)

    def render(self, cam, tau_px: float, render_geo: bool = False, background=None,
               active_sh_degree: int = 3):
        """One frame at pixel granularity `tau_px` (0 = exact leaf cut): a
        `lod.frame` span (utils/profiling.py) whose request is the frame's
        number, with `count_pass` (whether the count pass ran) and
        `attempts` (cut-and-render calls); each host read of the device
        inside it is a wait span."""
        with span("lod.frame", request=self.frames, count_pass=0) as frame_span:
            self.frames += 1
            target = self.target_size(cam, tau_px)
            vp = cam.camera_center
            with span("lod.read_viewpoint", wait=True):
                vp_np = vp.to(torch.float64).cpu().numpy()

            # frame-coherent count reuse: skip the count pass and its host read
            # when the camera is near the last counted viewpoint at the same τ
            c = self._count_cache
            if (
                c is not None
                and c["tau"] == tau_px
                and c["frames"] < self.recount_every
                and float(np.linalg.norm(vp_np - c["vp"])) <= self.recount_dist
            ):
                c["frames"] += 1
                n_cut = c["n_cut"]
            else:
                with span("lod.count", wait=True):
                    n_cut = int(cut_size_packed(self._packed, target, vp))
                frame_span.set(count_pass=1)
                self._count_cache = {"tau": tau_px, "vp": vp_np, "frames": 0, "n_cut": n_cut}
            budget = self._fit_budget(n_cut)
            want = round_budget(max(2 * (budget + self.skybox_count), 1 << 14))
            if want > self._max_inst or want * 4 <= self._max_inst:
                self._max_inst = want
            frame = fused_lod_frame if self.compiled is None else self.compiled
            for attempt in range(1, 6):
                frame_span.set(attempts=attempt)
                config = RasterConfig(backend=self.backend, tile=self.tile, depth_sort_bits=-1,
                                      max_instances=self._max_inst)
                out = frame(
                    self._packed, target, cam, *self.arrays, budget=budget, num_points=self.num_points,
                    skybox_count=self.skybox_count, background=background, config=config,
                    render_geo=render_geo, active_sh_degree=active_sh_degree, attrs=self._attrs)
                counters = torch.stack([out["num_selected"].to(torch.int64), out["overflow"].to(torch.int64),
                                        out["num_instances"].to(torch.int64)])
                with span("lod.read_counters", wait=True):
                    n_sel, overflow, n_inst = (int(x) for x in counters.cpu())
                if n_sel > budget:
                    # a stale cached count under-budgeted the cut: refresh the
                    # cache from the true demand and re-expand
                    self._count_cache = {"tau": tau_px, "vp": vp_np, "frames": 0, "n_cut": n_sel}
                    budget = self._fit_budget(n_sel)
                    continue
                if overflow == 0:
                    return out
                self._max_inst = round_budget(n_inst + 1)
            print(
                f"WARNING: AdaptiveHierRenderer gave up after 5 attempts "
                f"with overflow={overflow} cut={n_sel}/{budget} "
                f"(instance budget {self._max_inst}, demand {n_inst}) "
                f"— frame is missing content",
                flush=True,
            )
            return out
