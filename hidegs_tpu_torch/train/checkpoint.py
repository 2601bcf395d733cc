"""Checkpoint / resume.

Port of hidegs_tpu/train/checkpoint.py. A checkpoint directory
`iteration_N/` holds the whole TrainState as `state.npz`, the alive rows as
a reference-format `point_cloud.ply`, `meta.json` and `exposure.json`, and
resume scans the `iteration_*` directories as the reference does
(utils/system_utils.py:25-27).

`state.npz` uses the JAX package's leaf keys (`gaussians/params/xyz`, ...,
`opt/m/xyz`, ..., `opt/step`, `exposure`, `step`, `rng`), so a checkpoint
written by either package loads in the other. The port's TrainState carries
two torch.Generators where the JAX one carries a PRNG key: the densify
generator (CPU) and the multi-view pixel generator (on the state's
device). The port writes `rng` as the key of the densify generator's seed
and adds the generators' states under `torch_generator_state` and
`torch_mv_generator_state`, which the JAX package ignores; a checkpoint
without them seeds each generator from `rng`.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from hidegs_tpu_torch.model.adam import AdamState
from hidegs_tpu_torch.model.gaussians import GaussianParams, GaussianState
from hidegs_tpu_torch.train.loop import TrainState
from hidegs_tpu_torch.utils.ply import save_gaussian_ply

GENERATOR_KEY = "torch_generator_state"
MV_GENERATOR_KEY = "torch_mv_generator_state"
_PARAM_FIELDS = GaussianParams._fields


def _flatten_with_paths(ts: TrainState) -> Dict[str, torch.Tensor]:
    """The TrainState's tensors under the JAX package's leaf keys, in its
    order (the generator is not a tensor and is left out)."""
    g = ts.gaussians
    out = {f"gaussians/params/{f}": getattr(g.params, f) for f in _PARAM_FIELDS}
    out.update({f"gaussians/{f}": getattr(g, f) for f in GaussianState._fields if f != "params"})
    for moment in ("m", "v"):
        out.update({f"opt/{moment}/{f}": getattr(getattr(ts.opt, moment), f) for f in _PARAM_FIELDS})
    out["opt/step"] = ts.opt.step
    out.update({f: getattr(ts, f) for f in ("exposure", "exposure_m", "exposure_v", "step")})
    return out


def _rng_key(generator: torch.Generator) -> np.ndarray:
    """jax.random.PRNGKey(seed) of the generator's seed: [seed >> 32, seed & 0xffffffff]."""
    seed = generator.initial_seed()
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _unflatten(leaves: Dict[str, torch.Tensor], generator: torch.Generator,
               mv_generator: torch.Generator) -> TrainState:
    def params(prefix):
        return GaussianParams(*(leaves[f"{prefix}/{f}"] for f in _PARAM_FIELDS))

    gaussians = GaussianState(params=params("gaussians/params"), **{
        f: leaves[f"gaussians/{f}"] for f in GaussianState._fields if f != "params"})
    return TrainState(
        gaussians=gaussians,
        opt=AdamState(m=params("opt/m"), v=params("opt/v"), step=leaves["opt/step"]),
        exposure=leaves["exposure"], exposure_m=leaves["exposure_m"], exposure_v=leaves["exposure_v"],
        step=leaves["step"], generator=generator, mv_generator=mv_generator,
    )


def check_alive_finite(gaussians: GaussianState, max_bad_frac: float = 0.01):
    """Count alive rows with non-finite params; raise if the fraction says
    the run diverged rather than a few stray rows blowing up.

    A run that diverges can keep a finite training loss (the raster culls
    non-finite rows) while nearly every row is NaN, and a handful of bad rows
    is normal optimizer noise that the caller scrubs; beyond `max_bad_frac`
    of the alive rows the model is corrupt and saving it would be lying.
    Returns (n_alive, bad row mask), the mask a bool tensor on the state's
    device."""
    alive = gaussians.alive
    n_alive = int(alive.sum())
    bad = torch.zeros_like(alive)
    for name in ("xyz", "scaling", "rotation", "opacity", "sh_dc", "sh_rest"):
        arr = getattr(gaussians.params, name)
        finite = torch.isfinite(arr).reshape(arr.shape[0], -1).all(dim=1)
        bad |= alive & ~finite
    n_bad = int(bad.sum())
    if n_bad > max_bad_frac * max(n_alive, 1):
        raise FloatingPointError(
            f"checkpoint corrupt: {n_bad}/{n_alive} alive rows hold non-finite "
            "params (training diverged)"
        )
    return n_alive, bad


def save_train_state(ts: TrainState, directory: str, iteration: int, extras: Optional[dict] = None) -> str:
    """Write checkpoint dir: state.npz + point_cloud.ply + meta.json +
    exposure.json.

    Stray non-finite alive rows (≤1%) are scrubbed (marked dead) with a
    warning and recorded in meta.json; beyond that the save REFUSES
    (FloatingPointError) — the model diverged."""
    n_alive, bad = check_alive_finite(ts.gaussians)
    n_scrubbed = int(bad.sum())
    if n_scrubbed:
        print(f"  checkpoint: scrubbing {n_scrubbed}/{n_alive} non-finite alive rows before save", flush=True)
        ts = ts._replace(gaussians=ts.gaussians._replace(alive=ts.gaussians.alive & ~bad))
    extras = dict(extras or {})
    extras.setdefault("n_scrubbed_at_save", n_scrubbed)
    d = os.path.join(directory, f"iteration_{iteration}")
    os.makedirs(d, exist_ok=True)
    arrays = {k: v.detach().cpu().numpy() for k, v in _flatten_with_paths(ts).items()}
    arrays["rng"] = _rng_key(ts.generator)
    arrays[GENERATOR_KEY] = ts.generator.get_state().numpy()
    arrays[MV_GENERATOR_KEY] = ts.mv_generator.get_state().numpy()
    np.savez_compressed(os.path.join(d, "state.npz"), **arrays)
    params = {f: arrays[f"gaussians/params/{f}"] for f in _PARAM_FIELDS}
    save_gaussian_ply(os.path.join(d, "point_cloud.ply"), params, alive=arrays["gaussians/alive"])
    meta = {"iteration": iteration, "n_alive": int(ts.gaussians.alive.sum())}
    meta.update(extras)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    # exposure.json interchange (scene/__init__.py:164-170)
    expo = arrays["exposure"]
    with open(os.path.join(d, "exposure.json"), "w") as f:
        json.dump({str(i): expo[i].tolist() for i in range(len(expo))}, f)
    return d


def find_latest_iteration(directory: str) -> Optional[int]:
    """Scan `iteration_*` subdirs (searchForMaxIteration, utils/system_utils.py:25-27)."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"iteration_(\d+)", name)
        if m:
            it = int(m.group(1))
            best = it if best is None else max(best, it)
    return best


def load_train_state(template_ts: TrainState, directory: str, iteration: int = -1):
    """Restore a TrainState saved by `save_train_state` of either package.
    `template_ts` gives the leaves' shapes, dtypes and device (same
    capacity and number of images). Returns (state, iteration)."""
    if iteration == -1:
        iteration = find_latest_iteration(directory)
        if iteration is None:
            raise FileNotFoundError(f"no iteration_* checkpoints in {directory}")
    d = os.path.join(directory, f"iteration_{iteration}")
    with np.load(os.path.join(d, "state.npz")) as data:
        leaves = {}
        for key, want in _flatten_with_paths(template_ts).items():
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            saved = data[key]
            if saved.shape != tuple(want.shape):
                raise ValueError(
                    f"shape mismatch for {key}: checkpoint {saved.shape} vs template {tuple(want.shape)}")
            leaves[key] = torch.as_tensor(saved).to(dtype=want.dtype, device=want.device)
        key = data["rng"].astype(np.uint64)
        seed = int((key[0] << np.uint64(32)) | key[1])
        generator = torch.Generator()
        mv_generator = torch.Generator(device=template_ts.mv_generator.device)
        for gen, name in ((generator, GENERATOR_KEY), (mv_generator, MV_GENERATOR_KEY)):
            if name in data:
                gen.set_state(torch.as_tensor(data[name]))
            else:
                gen.manual_seed(seed)
    return _unflatten(leaves, generator, mv_generator), iteration
