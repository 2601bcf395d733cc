# Frozen copy of hidegs_tpu_torch/model/densify.py:1-231 at commit 63641d3, the benchmark's plain
# reference: imports point into gsbench.reference; edits are marked "frozen copy:".
"""Densification (clone / split / prune) on capacity-padded buffers.

Port of hidegs_tpu/model/densify.py:

  * clone: score = ‖∇2d‖_max · max_radii2D · opacity^(1/5) ≥ τ, opacity >
    0.15 and max scale ≤ percent_dense·extent: copied into a dead slot;
  * split: same score, larger scale: the parent becomes child #0 in place,
    child #1 takes a dead slot; children are drawn from N(0, scale) rotated
    by the parent and get scale / (0.8·N), N = 2;
  * prune: opacity < min_opacity (protected rows exempt), or non-finite.

Dead slots go to the highest-scoring candidates first; candidates beyond
the free-slot supply (or the `max_growth_frac` budget) are dropped. Writes
whose slot is "none" (index C) land in a spare row that is cut off, so
nothing here reads a count back to the host.

The split draws come from `split_draws` and a `torch.Generator`; the
numbers differ from `jax.random`'s, so the parity test replaces that one
function with the JAX draws. `densify_round` takes the draws as an input
(the compiled round, train/compiled.py:CompiledDensify, draws them before
its replay, as the view-parallel step draws its pixel samples), and
`densify_and_prune` draws them for it. Nothing here reads the device from
the host or copies a constant from it, so a round can be captured as a
CUDA graph.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gsbench.reference.core.transforms import quat_to_rotmat
from gsbench.reference.model.adam import AdamState, reset_moments_at
from gsbench.reference.model.gaussians import GaussianParams, GaussianState


class DensifyConfig(NamedTuple):
    grad_threshold: float = 0.015
    abs_grad_threshold: float = 0.0008
    min_opacity: float = 0.005
    percent_dense: float = 1e-4  # fraction of the scene extent
    clone_min_opacity: float = 0.15
    split_n: int = 2
    split_scale_div: float = 0.8  # children scale / (0.8 * N)
    # at most this fraction of the alive count is added per round, highest
    # scores first (0 = unbounded, the reference's behaviour)
    max_growth_frac: float = 0.0


def add_densification_stats(
    state: GaussianState,
    screen_grad: torch.Tensor,
    visible: torch.Tensor,
    radii: torch.Tensor,
) -> GaussianState:
    """Running max of the screen-space gradient norm (and its abs variant)
    and of the 2D radius over visible rows. screen_grad: (C, 2)."""
    gnorm = torch.linalg.norm(screen_grad[:, :2], dim=-1)
    gabs = torch.sum(torch.abs(screen_grad[:, :2]), dim=-1)
    return state._replace(
        grad_max=torch.where(visible, torch.maximum(state.grad_max, gnorm), state.grad_max),
        grad_abs_max=torch.where(visible, torch.maximum(state.grad_abs_max, gabs), state.grad_abs_max),
        max_radii2d=torch.where(
            visible, torch.maximum(state.max_radii2d, radii.to(torch.float32)), state.max_radii2d),
    )


def split_draws(generator: torch.Generator, capacity: int, device) -> tuple:
    """The two (C, 3) standard-normal draws of a densify round, one per
    split child. Drawn on the CPU from `generator`, so a seed gives the same
    numbers on any device; for a card into pinned memory, whose copy does
    not make the host wait."""
    pin = torch.device(device).type == "cuda"
    eps0 = torch.randn((capacity, 3), generator=generator, pin_memory=pin)
    eps1 = torch.randn((capacity, 3), generator=generator, pin_memory=pin)
    return eps0.to(device, non_blocking=pin), eps1.to(device, non_blocking=pin)


def _put(x: torch.Tensor, dest: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x with x[dest[i]] = src[i]; entries with dest = C are dropped (they
    land in a spare row). The kept destinations are distinct."""
    C = x.shape[0]
    ext = torch.cat([x, x[:1]], dim=0)
    ext.index_copy_(0, dest, src)
    return ext[:C]


def _finite_rows(p: GaussianParams) -> torch.Tensor:
    return (
        torch.isfinite(p.xyz).all(-1)
        & torch.isfinite(p.scaling).all(-1)
        & torch.isfinite(p.rotation).all(-1)
        & torch.isfinite(p.opacity)
        & torch.isfinite(p.sh_dc).all(-1)
        & torch.isfinite(p.sh_rest).all(-1).all(-1)
    )


def densify_and_prune(
    state: GaussianState,
    opt: AdamState,
    scene_extent,
    cfg: DensifyConfig,
    generator: torch.Generator,
):
    """One densification round on draws from `generator` (`split_draws`).
    Returns (new_state, new_opt, info dict of 0-d tensors)."""
    return densify_round(state, opt, scene_extent, cfg, split_draws(generator, state.capacity, state.params.xyz.device))


def _constants(values, device) -> torch.Tensor:
    """float32 constants on `device`, from fills (no copy from the host)."""
    return torch.stack([torch.full((), v, dtype=torch.float32, device=device) for v in values])


def densify_round(state: GaussianState, opt: AdamState, scene_extent, cfg: DensifyConfig, draws: tuple):
    """`densify_and_prune` on the given split draws, the (C, 3) pair of
    `split_draws`. `scene_extent`: a float or a 0-d float64 tensor (the
    same threshold to the bit). Returns (new_state, new_opt, info dict of
    0-d tensors)."""
    p = state.params
    C = state.capacity
    dev = p.xyz.device
    opac = state.opacities  # already alive-masked
    max_scale = torch.amax(torch.exp(p.scaling), dim=-1)

    score = state.grad_max * state.max_radii2d * torch.pow(torch.clamp(opac, min=1e-8), 0.2)
    eligible = (
        state.alive & ~state.protected & (score >= cfg.grad_threshold) & (opac > cfg.clone_min_opacity)
    )
    clone_mask = eligible & (max_scale <= cfg.percent_dense * scene_extent)
    split_mask = eligible & (max_scale > cfg.percent_dense * scene_extent)

    # dead slots first, in index order
    dead_idx = torch.argsort(state.alive.to(torch.int32), stable=True)
    n_dead = C - state.alive.sum()
    n_clone = clone_mask.sum()
    n_split = split_mask.sum()

    # each candidate (clone copy or split child #1) takes one dead slot,
    # highest score first
    sel_mask = clone_mask | split_mask
    sel_key = torch.where(sel_mask, score, torch.full_like(score, float("-inf")))
    order = torch.argsort(-sel_key, stable=True)
    ar = torch.arange(C, device=dev)
    cand_rank = torch.empty_like(ar)
    cand_rank[order] = ar
    budget = n_dead
    if cfg.max_growth_frac > 0:
        budget = torch.minimum(budget, (cfg.max_growth_frac * state.alive.sum()).to(torch.int64))
    none = torch.full_like(ar, C)
    slot = torch.where(sel_mask & (cand_rank < budget), dead_idx[torch.clamp(cand_rank, 0, C - 1)], none)
    clone_slot = torch.where(clone_mask, slot, none)
    split_slot = torch.where(split_mask, slot, none)
    # splits whose child #1 found no slot shrink in place, except under a
    # growth budget, where they keep their parent untouched
    if cfg.max_growth_frac > 0:
        split_mask = split_mask & (cand_rank < budget)

    # clones: verbatim copies
    new_params = GaussianParams(*(_put(leaf, clone_slot, leaf) for leaf in p))

    # splits: sample the children
    scales = torch.exp(p.scaling)
    R = quat_to_rotmat(p.rotation)
    eps0, eps1 = draws
    child0_xyz = p.xyz + torch.einsum("nij,nj->ni", R, eps0 * scales)
    child1_xyz = p.xyz + torch.einsum("nij,nj->ni", R, eps1 * scales)
    child_scaling = p.scaling - torch.log(
        torch.full((), cfg.split_scale_div * cfg.split_n, dtype=torch.float32, device=dev))
    child1 = GaussianParams(
        xyz=child1_xyz, sh_dc=p.sh_dc, sh_rest=p.sh_rest, scaling=child_scaling,
        rotation=p.rotation, opacity=p.opacity,
    )
    new_params = GaussianParams(*(_put(a, split_slot, b) for a, b in zip(new_params, child1)))
    sm = split_mask
    new_params = new_params._replace(
        xyz=torch.where(sm[:, None], child0_xyz, new_params.xyz),
        scaling=torch.where(sm[:, None], child_scaling, new_params.scaling),
    )

    # alive mask and prune
    true = torch.ones((C,), dtype=torch.bool, device=dev)
    alive = _put(_put(state.alive, clone_slot, true), split_slot, true)
    finite = _finite_rows(new_params)
    new_opac_act = torch.sigmoid(new_params.opacity)
    prune = alive & ((~state.protected & (new_opac_act < cfg.min_opacity)) | ~finite)
    alive = alive & ~prune

    # bookkeeping: new slots, split parents and pruned rows restart Adam
    touched = torch.zeros((C,), dtype=torch.bool, device=dev)
    touched = _put(_put(touched, clone_slot, true), split_slot, true)
    touched = touched | sm | prune
    new_opt = reset_moments_at(opt, touched)

    new_state = state._replace(
        params=new_params,
        alive=alive,
        grad_max=torch.zeros_like(state.grad_max),
        grad_abs_max=torch.zeros_like(state.grad_abs_max),
        max_radii2d=torch.zeros_like(state.max_radii2d),
    )
    # score quantiles among alive rows, for threshold calibration
    nan = torch.full_like(score, float("nan"))
    q = torch.nanquantile(torch.where(state.alive, score, nan), _constants((0.5, 0.9, 0.99), dev))
    qg = torch.nanquantile(torch.where(state.alive, state.grad_max, nan), _constants((0.5, 0.99), dev))
    qr = torch.nanquantile(torch.where(state.alive, state.max_radii2d, nan), _constants((0.5, 0.99), dev))
    info = {
        "n_clone": n_clone,
        "n_split": n_split,
        "n_pruned": prune.sum(),
        "n_alive": alive.sum(),
        "n_dropped": torch.clamp(n_clone + n_split - budget, min=0),
        "score_p50": q[0],
        "score_p90": q[1],
        "score_p99": q[2],
        "grad_p50": qg[0],
        "grad_p99": qg[1],
        "radii_p50": qr[0],
        "radii_p99": qr[1],
    }
    return new_state, new_opt, info


def scrub_nonfinite(state: GaussianState):
    """Kill alive rows whose parameters went non-finite (the scrub
    densify_and_prune applies, for use after the densify window). Returns
    (state, n_killed)."""
    finite = _finite_rows(state.params)
    killed = state.alive & ~finite
    return state._replace(alive=state.alive & finite), killed.sum()
