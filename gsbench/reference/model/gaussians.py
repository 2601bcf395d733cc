# Frozen copy of hidegs_tpu_torch/model/gaussians.py:1-240 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Gaussian model state: capacity-padded parameters and an alive mask.

Port of hidegs_tpu/model/gaussians.py. All buffers are allocated once at
`capacity` with an `alive` mask, as in the JAX package, so densify and prune
are masked writes and the layout matches the reference row for row (the
parity tests compare it that way). Activations follow the reference:
scaling = exp, opacity = sigmoid, rotation = normalize; xyz and SH are raw.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gsbench.reference.core.sh import NUM_SH_COEFFS, rgb_to_sh_dc
from gsbench.reference.core.transforms import inverse_sigmoid, normalize


class GaussianParams(NamedTuple):
    """The optimizable leaves, each (C, ...) with C = capacity."""

    xyz: torch.Tensor  # (C, 3)
    sh_dc: torch.Tensor  # (C, 3) DC color coefficients
    sh_rest: torch.Tensor  # (C, 15, 3) higher SH bands
    scaling: torch.Tensor  # (C, 3) log-scale
    rotation: torch.Tensor  # (C, 4) unnormalized quaternion wxyz
    opacity: torch.Tensor  # (C,) logit opacity


class GaussianState(NamedTuple):
    """Model state carried through training (everything but the optimizer)."""

    params: GaussianParams
    alive: torch.Tensor  # (C,) bool
    # densification statistics: running max of the screen-space positional
    # gradient norm and its abs variant, and the max 2D radius
    grad_max: torch.Tensor  # (C,)
    grad_abs_max: torch.Tensor  # (C,)
    max_radii2d: torch.Tensor  # (C,)
    # skybox / scaffold rows, exempt from pruning and opacity reset
    protected: torch.Tensor  # (C,) bool
    active_sh_degree: torch.Tensor  # () int32
    spatial_lr_scale: torch.Tensor  # () float32

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.params.scaling)

    @property
    def quats(self) -> torch.Tensor:
        return normalize(self.params.rotation)

    @property
    def opacities(self) -> torch.Tensor:
        o = torch.sigmoid(self.params.opacity)
        return torch.where(self.alive, o, torch.zeros_like(o))

    @property
    def shs(self) -> torch.Tensor:
        """(C, 16, 3) full SH tensor."""
        return torch.cat([self.params.sh_dc[:, None, :], self.params.sh_rest], dim=1)

    @property
    def shs_flat(self) -> torch.Tensor:
        """(C, 48) flat SH tensor [k0_rgb, k1_rgb, ...]."""
        C = self.params.sh_dc.shape[0]
        return torch.cat([self.params.sh_dc, self.params.sh_rest.reshape(C, -1)], dim=1)


def init_from_points(
    points: torch.Tensor,
    colors: torch.Tensor,
    capacity: int,
    spatial_lr_scale: float = 1.0,
    init_opacity: float = 0.1,
    knn_scale: Optional[torch.Tensor] = None,
    protected_mask: Optional[torch.Tensor] = None,
) -> GaussianState:
    """State from a point cloud on the points' device: points (n, 3),
    colors (n, 3) in [0, 1], n ≤ capacity. The initial isotropic scale is
    `knn_scale` (model/knn.py:initial_scales) or, when None, extent / cbrt(n).
    Rows past n are dead, with scaling and opacity logits at -10."""
    n = points.shape[0]
    dev = points.device
    f32 = torch.float32
    if knn_scale is None:
        extent = torch.max(points.amax(dim=0) - points.amin(dim=0))
        knn_scale = torch.clamp(extent / float(np.cbrt(n)), min=1e-4).expand(n)
    dist = torch.clamp(knn_scale, min=1e-7)
    rotation = torch.zeros((n, 4), dtype=f32, device=dev)
    rotation[:, 0] = 1.0
    logit = float(inverse_sigmoid(torch.tensor(init_opacity, dtype=f32)))
    rows = GaussianParams(
        xyz=points,
        sh_dc=rgb_to_sh_dc(colors),
        sh_rest=torch.zeros((n, NUM_SH_COEFFS - 1, 3), dtype=f32, device=dev),
        scaling=torch.log(dist)[:, None].repeat(1, 3),
        rotation=rotation,
        opacity=torch.full((n,), logit, dtype=f32, device=dev),
    )
    return state_from_rows(rows, capacity, spatial_lr_scale, protected_mask=protected_mask)


def state_from_rows(
    rows: GaussianParams,
    capacity: int,
    spatial_lr_scale: float = 1.0,
    active_sh_degree: int = 0,
    protected_mask: Optional[torch.Tensor] = None,
) -> GaussianState:
    """State whose first n rows are the raw parameters `rows` (each (n,
    ...)), alive, and whose rows past n are dead: zeros, an identity
    rotation, and scaling and opacity logits at -10. Statistics start at 0."""
    n = rows.xyz.shape[0]
    if n > capacity:
        raise ValueError(f"{n} rows exceed capacity {capacity}")
    C = capacity
    dev = rows.xyz.device
    f32 = torch.float32
    fill = dict(scaling=-10.0, opacity=-10.0)

    def pad(name, x):
        out = torch.full((C,) + tuple(x.shape[1:]), fill.get(name, 0.0), dtype=f32, device=dev)
        if name == "rotation":
            out[:, 0] = 1.0
        out[:n] = x.to(f32)
        return out

    alive = torch.zeros((C,), dtype=torch.bool, device=dev)
    alive[:n] = True
    protected = torch.zeros((C,), dtype=torch.bool, device=dev)
    if protected_mask is not None:
        protected[:n] = protected_mask
    return GaussianState(
        params=GaussianParams(*(pad(name, x) for name, x in zip(GaussianParams._fields, rows))),
        alive=alive,
        grad_max=torch.zeros((C,), dtype=f32, device=dev),
        grad_abs_max=torch.zeros((C,), dtype=f32, device=dev),
        max_radii2d=torch.zeros((C,), dtype=f32, device=dev),
        protected=protected,
        active_sh_degree=torch.tensor(active_sh_degree, dtype=torch.int32, device=dev),
        spatial_lr_scale=torch.tensor(spatial_lr_scale, dtype=f32, device=dev),
    )


def make_skybox(num_points: int, scene_center: np.ndarray, scene_radius: float, seed: int = 0):
    """Skybox shell: a random sphere at 10x the scene radius, sky-tinted,
    biased toward the upper hemisphere. Returns (points, colors) numpy
    arrays, equal to the JAX package's for the same seed."""
    rng = np.random.RandomState(seed)
    theta = 2.0 * np.pi * rng.rand(num_points)
    phi = np.arccos(1.0 - 1.4 * rng.rand(num_points))
    r = 10.0 * scene_radius
    pts = np.stack(
        [
            r * np.sin(phi) * np.cos(theta),
            -r * np.cos(phi),  # world -y is up in the COLMAP convention
            r * np.sin(phi) * np.sin(theta),
        ],
        axis=-1,
    ) + np.asarray(scene_center)[None]
    colors = np.tile(np.array([[0.7, 0.8, 0.95]]), (num_points, 1))
    return pts.astype(np.float32), colors.astype(np.float32)


def prepend_raw_points(state: GaussianState, raw: dict, protected: bool = True) -> GaussianState:
    """Write raw-parameter points (e.g. a border scaffold) into the LAST dead
    slots, so the initial cloud's rows keep their indices. Raises if the
    capacity cannot hold them."""
    n_new = len(raw["xyz"])
    if n_new == 0:
        # guard: dead[-0:] below would select every dead slot
        return state
    dev = state.alive.device
    dead = torch.nonzero(~state.alive).squeeze(1)
    if dead.shape[0] < n_new:
        raise ValueError(f"capacity {state.capacity} cannot hold {n_new} extra scaffold points")
    slots = dead[-n_new:]

    def put(leaf, key):
        out = leaf.clone()
        out[slots] = torch.as_tensor(np.asarray(raw[key], np.float32), device=dev).reshape(
            (n_new,) + tuple(leaf.shape[1:]))
        return out

    p = state.params
    alive = state.alive.clone()
    alive[slots] = True
    prot = state.protected.clone()
    prot[slots] = protected
    return state._replace(
        params=GaussianParams(*(put(getattr(p, f), f) for f in GaussianParams._fields)),
        alive=alive,
        protected=prot,
    )


def oneup_sh_degree(state: GaussianState, max_degree: int = 3) -> GaussianState:
    """SH warm-up: one more active band, up to `max_degree`."""
    return state._replace(active_sh_degree=torch.clamp(state.active_sh_degree + 1, max=max_degree))


def reset_opacity(state: GaussianState, max_opacity: float = 0.01) -> GaussianState:
    """Clamp opacity to ≤ `max_opacity`; protected rows are exempt."""
    cap = inverse_sigmoid(torch.tensor(max_opacity, dtype=torch.float32, device=state.alive.device))
    new_logit = torch.minimum(state.params.opacity, cap)
    opac = torch.where(state.protected, state.params.opacity, new_logit)
    return state._replace(params=state.params._replace(opacity=opac))


def compact_gaussians(state: GaussianState, opt):
    """Permute rows so every alive row sits in the prefix [0, n_alive), in
    their previous relative order (a stable sort on ~alive); every (C, ...)
    buffer of the state and of the Adam state `opt` rides the same
    permutation. Enables the train step's `row_budget`."""
    from gsbench.reference.model.adam import AdamState

    perm = torch.argsort((~state.alive).to(torch.int32), stable=True)

    def g_params(p: GaussianParams) -> GaussianParams:
        return GaussianParams(*(leaf[perm] for leaf in p))

    new_state = state._replace(
        params=g_params(state.params),
        alive=state.alive[perm],
        grad_max=state.grad_max[perm],
        grad_abs_max=state.grad_abs_max[perm],
        max_radii2d=state.max_radii2d[perm],
        protected=state.protected[perm],
    )
    return new_state, AdamState(m=g_params(opt.m), v=g_params(opt.v), step=opt.step[perm])
