"""Multi-process dry runs of the view-parallel step, and their launcher.

The port's counterpart of `__graft_entry__.py:dryrun_multichip` and
`dryrun_schedule_leg`: every rank joins one process group, forms a
("data", "model") mesh and runs the step of parallel/sharded.py.

  * `dryrun_multichip`: one full step on a (n/model, model) mesh (model 2
    when n is even and > 2) with the rows split over "model": 16,384
    toy gaussians at capacity 65,536, 256² views, the "plain" backend
    (the "blend" backend on a card: `leg_backend`);
    then the kernel leg: one step on an (n, 1) mesh on the "blend" backend
    (the CUDA kernels on a card, their plain versions on the CPU) with the
    bf16 gradient wire;
  * `dryrun_schedule_leg`: 50 steps of a 512-gaussian scene on 32² views
    with densify at steps 10 and 30, an opacity reset at 25 and an
    instance-budget regrow at 12, under three placements (the n-rank mesh
    replicated, the same mesh with the rows split over "model", and one
    process with no collective), held against each other at the JAX
    package's tolerances; after every densify and reset the alive masks
    must be bitwise equal.
  * `dp_worker`: K steps of a saved problem (`save_dp_job`) under a list
    of placements, each rank's states written back; the parity tests and
    the smoke use it.

On a card with NCCL, or with no group, every step is a replay of the
compiled step (parallel/compiled.py) and the schedule leg's densify rounds
replay the compiled round (train/compiled.py:CompiledDensify); a gloo
group runs the eager `make_dp_train_step`, whose collectives go through
the host and cannot be captured (`dp_step`).

    python -m hidegs_tpu_torch.parallel --nproc N [--backend nccl|gloo] [--device cuda|cpu]

spawns N ranks with torch.multiprocessing (or, under torchrun, runs as the
rank torchrun gives: `torchrun --nproc_per_node N -m
hidegs_tpu_torch.parallel`). The card is the default device, and its
backend NCCL; without a card that default raises. NCCL takes one card per
rank, so more ranks than cards need `--backend gloo`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hidegs_tpu_torch import convert
from hidegs_tpu_torch.device import DeviceLike, resolve_device
from hidegs_tpu_torch.parallel import distributed as pdist
from hidegs_tpu_torch.parallel.compiled import compile_dp_train_step, mesh_backend
from hidegs_tpu_torch.parallel.mesh import make_mesh
from hidegs_tpu_torch.parallel.sharded import gather_rows, make_dp_train_step, shard_rows, stack_view_batches
from hidegs_tpu_torch.raster.api import RasterConfig, render, suggest_max_instances
from hidegs_tpu_torch.train.compiled import CompiledDensify
from hidegs_tpu_torch.train.loop import TrainConfig, TrainState, ViewBatch, densify_step, init_train_state
from hidegs_tpu_torch.utils.graphs import on_card

DRYRUN_TIMEOUT = 1800.0  # seconds for all ranks of `python -m hidegs_tpu_torch.parallel`

# ---------------------------------------------------------------------------
# launcher


def _entry(rank: int, fn: Callable, nproc: int, args: tuple, log_dir: str, threads: int):
    """A spawned rank: its stdout and stderr (file descriptors too) go to
    `log_dir/rank{rank}.log`."""
    log = open(os.path.join(log_dir, f"rank{rank}.log"), "w", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    sys.stdout = sys.stderr = log
    if threads:
        torch.set_num_threads(threads)
    try:
        fn(rank, nproc, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        log.flush()


def worker_logs(log_dir: str, nproc: int) -> str:
    out = []
    for r in range(nproc):
        p = Path(log_dir) / f"rank{r}.log"
        out.append(f"----- rank {r} -----\n" + (p.read_text()[-6000:] if p.exists() else "(no log)"))
    return "\n".join(out)


def launch(fn: Callable, nproc: int, args: tuple, timeout: float, log_dir: str, threads: int = 0) -> str:
    """Run `fn(rank, nproc, *args)` in `nproc` spawned processes; wait at
    most `timeout` seconds. Returns the ranks' logs. A rank that fails, or
    the timeout, stops every rank and raises with the logs (TimeoutError
    for the timeout). `threads` > 0 sets each rank's torch thread count."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    os.makedirs(log_dir, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(fn, nproc, args, log_dir, threads), nprocs=nproc,
                             start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nproc} ranks still running after {timeout:.0f} s\n"
                                   + worker_logs(log_dir, nproc))
    except ProcessException as e:
        raise RuntimeError(f"a rank failed: {e}\n" + worker_logs(log_dir, nproc)) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return worker_logs(log_dir, nproc)


def file_init_method(directory: str) -> str:
    """A file:// rendezvous in `directory`, which it creates (no port to
    collide). The file must not be left from an earlier group."""
    os.makedirs(directory, exist_ok=True)
    return "file://" + str(Path(directory).resolve() / "rendezvous")


def dp_step(dev: torch.device, cfg: TrainConfig, mesh=None, **kwargs):
    """(step, place) of the view-parallel step on `dev` over `mesh`: the
    compiled step on a card with an NCCL mesh or none, else (a gloo group,
    the CPU) the eager `make_dp_train_step`."""
    if on_card(dev) and mesh_backend(mesh) in (None, "nccl"):
        return compile_dp_train_step(cfg, mesh, **kwargs)
    return make_dp_train_step(cfg, mesh, **kwargs)


# ---------------------------------------------------------------------------
# saved problems for dp_worker


def save_dp_job(path: str, ts: TrainState, views: Sequence[ViewBatch], cfg: TrainConfig, runs: List[Dict],
                use_exposure: bool = False):
    """Write a problem for `dp_worker`: the state (its numpy leaves and
    generator states), the views (single-view batches without multi-view
    parts), the config and the runs. Each run is a dict: name, data, model
    (the mesh; data·model = the world size, or 0 for no process group),
    shard (split the rows over "model"), replicate_preprocessed, wire
    (None or "bf16"), steps."""
    torch.save({
        "state": convert.train_state_to_numpy(ts),
        "generator": ts.generator.get_state(),
        "mv_generator": ts.mv_generator.get_state(),
        "views": [{"cam": [np.asarray(x.detach().cpu()) for x in (v.cam.R, v.cam.t, v.cam.fx, v.cam.fy, v.cam.cx,
                                                                  v.cam.cy)],
                   "hw": (v.cam.height, v.cam.width), "image": v.image.detach().cpu(),
                   "image_idx": int(v.image_idx)} for v in views],
        "cfg": cfg,
        "runs": runs,
        "use_exposure": use_exposure,
    }, path)


def load_dp_job(path: str, device: DeviceLike):
    job = torch.load(path, weights_only=False)
    s = job["state"]
    ts = convert.train_state_from_jax(gaussians=s["gaussians"], m=s["m"], v=s["v"], opt_step=s["opt_step"],
                                      exposure=s["exposure"], exposure_m=s["exposure_m"],
                                      exposure_v=s["exposure_v"], step=s["step"], device=device)
    ts.generator.set_state(job["generator"])
    ts.mv_generator.set_state(job["mv_generator"])
    views = [ViewBatch(cam=convert.camera_from_jax(*v["cam"], *v["hw"], device=device),
                       image=v["image"].to(device), image_idx=torch.tensor(v["image_idx"], device=device))
             for v in job["views"]]
    return ts, views, job


def dp_worker(rank: int, world: int, init_method: str, backend: str, device: str, job_path: str, out_dir: str):
    """Run each of the job's runs from its state and write this rank's
    results to `out_dir/rank{rank}.pt`: per run the losses, each step's
    metrics and seconds, a digest of the whole final state (gathered over
    "model" when split; checked equal on every rank), the numpy state after
    each step in the run's `save_steps` (rank 0 only; with `save="params"`
    its parameters alone), and with `record` the
    collectives of its steps (`record_collectives`). Also this rank's
    `local_camera_indices(10)` and whether `assert_same_across_hosts`
    raised on a value that differs by rank."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if torch.cuda.device_count() == 1 else rank)
    pdist.initialize_distributed(backend=backend, device=dev, init_method=init_method, world_size=world,
                                 rank=rank)
    ts0, views, job = load_dp_job(job_path, dev)
    batch = stack_view_batches(views)
    results = {"camera_indices": pdist.local_camera_indices(10, seed=0)}
    try:
        try:
            pdist.assert_same_across_hosts(np.full(4, float(rank)), "rank", device=dev)
            results["differing_ranks_raise"] = False
        except AssertionError:
            results["differing_ranks_raise"] = True
        for run in job["runs"]:
            mesh = None if not run["data"] else make_mesh(world, data=run["data"], model=run["model"],
                                                          device_type=dev.type)
            shard = run.get("shard", False)
            wire = torch.bfloat16 if run.get("wire") == "bf16" else None
            step, place = dp_step(dev, job["cfg"], mesh, use_exposure=job["use_exposure"], grad_reduce_dtype=wire,
                                  replicate_preprocessed=run.get("replicate_preprocessed", False),
                                  shard_gaussians=shard)
            ts, b = place(ts0, batch)
            out = {"losses": [], "metrics": [], "seconds": [], "states": {}, "collectives": []}
            if shard:  # a state split over "model" refuses a step that keeps the rows whole
                other, _ = make_dp_train_step(job["cfg"], mesh, use_exposure=job["use_exposure"])
                try:
                    other(ts, b)
                    out["mismatch_raises"] = False
                except ValueError:
                    out["mismatch_raises"] = True
            for k in range(1, run["steps"] + 1):
                t0 = time.perf_counter()
                with record_collectives(out["collectives"]) if run.get("record") else contextlib.nullcontext():
                    ts, m = step(ts, b)
                    metrics = {key: float(v) for key, v in m.items()}
                out["seconds"].append(time.perf_counter() - t0)
                out["losses"].append(metrics["loss"])
                out["metrics"].append(metrics)
                if k in run.get("save_steps", ()) or k == run["steps"]:
                    whole = gather_rows(ts, mesh) if shard and mesh is not None else ts
                    if k in run.get("save_steps", ()) and rank == 0:
                        out["states"][k] = (convert.train_state_to_numpy(whole) if run.get("save") != "params" else
                                            {f: getattr(whole.gaussians.params, f).cpu().numpy()
                                             for f in whole.gaussians.params._fields})
            out["digest"] = pdist.state_digest(_state_tensors(whole))
            if mesh is not None:
                pdist.assert_same_across_hosts(out["digest"], f"{run['name']} state", device=dev)
            results[run["name"]] = out
            print(f"rank {rank}: {run['name']} losses {out['losses']} "
                  f"{1e3 * float(np.median(out['seconds'])):.1f} ms/step (median)", flush=True)
    finally:
        pdist.shutdown_distributed()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


@contextlib.contextmanager
def record_collectives(log: list):
    """Append (name, shape, dtype, group size, op) of every all_reduce,
    all_gather_into_tensor and broadcast the enclosed code calls (the
    output's shape for the gather) to `log`."""
    import torch.distributed as dist

    names = ("all_reduce", "all_gather_into_tensor", "broadcast")
    orig = {n: getattr(dist, n) for n in names}

    def wrap(name, fn):
        def recorded(t, *args, **kwargs):
            op = kwargs.get("op")
            log.append((name, tuple(t.shape), str(t.dtype), dist.get_world_size(kwargs.get("group")),
                        "" if op is None else str(op).rsplit(".", 1)[-1]))
            return fn(t, *args, **kwargs)

        return recorded

    for n in names:
        setattr(dist, n, wrap(n, orig[n]))
    try:
        yield log
    finally:
        for n in names:
            setattr(dist, n, orig[n])


def _state_tensors(ts: TrainState) -> List[torch.Tensor]:
    g = ts.gaussians
    return (list(g.params) + list(ts.opt.m) + list(ts.opt.v)
            + [ts.opt.step, g.alive, g.grad_max, g.grad_abs_max, g.max_radii2d, g.protected,
               ts.exposure, ts.exposure_m, ts.exposure_v, ts.step])


# ---------------------------------------------------------------------------
# the dry runs


def _views(scene, cams, rcfg) -> List[ViewBatch]:
    with torch.no_grad():
        return [ViewBatch(cam=c, image=render(*scene, c, config=rcfg)["render"],
                          image_idx=torch.tensor(i, device=c.device)) for i, c in enumerate(cams)]


def leg_backend(dev: torch.device) -> str:
    """The render backend of the multichip and schedule legs: "plain" on
    the CPU; on a card "blend", the kernels, which the compiled step
    captures (the plain blend reads its tile counts to the host)."""
    return "blend" if on_card(dev) else "plain"


def _model_size(n: int) -> int:
    return 2 if n % 2 == 0 and n > 2 else 1


def dryrun_multichip(world: int, dev: torch.device) -> None:
    from hidegs_tpu_torch.data.synthetic import make_toy_gaussians, ring_camera
    from hidegs_tpu_torch.model.gaussians import init_from_points

    rank = pdist.process_index()
    model = _model_size(world)
    V = world // model
    mesh = make_mesh(world, data=V, model=model, device_type=dev.type)
    # the JAX dry run's shapes: 64k capacity, 256² views
    H = W = 256
    n = 16_384
    scene = make_toy_gaussians(n, seed=0, device=dev)
    cams = [ring_camera(i, n_cams=max(V, 2), height=H, width=W, device=dev) for i in range(V)]
    rcfg = RasterConfig(backend=leg_backend(dev), max_instances=suggest_max_instances(n, mult=8))
    views = _views(scene, cams, rcfg)
    state = init_from_points(scene.means3d, torch.full((n, 3), 0.5, device=dev), capacity=1 << 16)
    cfg = TrainConfig(iterations=10, raster=rcfg, freq_warmup=0, single_view_weight=0.015, single_view_from=0)
    step, place = dp_step(dev, cfg, mesh, shard_gaussians=model > 1)
    ts, batch = place(init_train_state(state, num_images=V), stack_view_batches(views))
    ts, metrics = step(ts, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if rank == 0:
        print(f"dryrun_multichip({world}): mesh={tuple(mesh.shape)} capacity={state.capacity} "
              f"views={V}x{H}x{W} loss={loss:.4f} ok", flush=True)

    # the kernel leg: the "blend" backend (the CUDA kernels on a card) with
    # the bf16 gradient wire, views over every rank
    mesh_dp = make_mesh(world, data=world, model=1, device_type=dev.type)
    on_cpu = dev.type == "cpu"
    Hp = Wp = 16 if on_cpu else 256
    np_ = 64 if on_cpu else 16_384
    pscene = make_toy_gaussians(np_, seed=1, device=dev)
    pcams = [ring_camera(i, n_cams=max(world, 2), height=Hp, width=Wp, device=dev) for i in range(world)]
    pcfg_r = RasterConfig(backend="blend", tile=16 if on_cpu else 32, max_instances=1 << (9 if on_cpu else 17))
    pviews = _views(pscene, pcams, pcfg_r)
    pstate = init_from_points(pscene.means3d, torch.full((np_, 3), 0.5, device=dev), capacity=max(128, np_ * 2))
    pcfg = TrainConfig(iterations=10, raster=pcfg_r, freq_warmup=0, single_view_weight=0.015, single_view_from=0)
    pstep, pplace = dp_step(dev, pcfg, mesh_dp, grad_reduce_dtype=torch.bfloat16)
    pts, pbatch = pplace(init_train_state(pstate, num_images=world), stack_view_batches(pviews))
    pts, pmetrics = pstep(pts, pbatch)
    ploss = float(pmetrics["loss"])
    if not np.isfinite(ploss):
        raise AssertionError(f"non-finite blend loss {ploss}")
    if rank == 0:
        print(f"dryrun_multichip({world}): blend kernel leg mesh={tuple(mesh_dp.shape)} "
              f"views={world}x{Hp}x{Wp} bf16 all-reduce loss={ploss:.4f} ok", flush=True)


def dryrun_schedule_leg(world: int, dev: torch.device, n_steps: int = 50) -> Dict:
    """`__graft_entry__.py:dryrun_schedule_leg` on this process group: the
    three placements' loss trajectories agree, densify brings the same rows
    to life everywhere, and the alive masks after every event are bitwise
    equal. Returns the three runs' losses."""
    from hidegs_tpu_torch.data.synthetic import make_toy_gaussians, ring_camera
    from hidegs_tpu_torch.model.adam import reset_opacity_moments
    from hidegs_tpu_torch.model.gaussians import init_from_points, reset_opacity

    rank = pdist.process_index()
    model = _model_size(world)
    V = world // model
    H = W = 32
    n = 512
    scene = make_toy_gaussians(n, seed=3, device=dev)
    cams = [ring_camera(i, n_cams=max(V, 2), height=H, width=W, device=dev) for i in range(V)]
    rcfg0 = RasterConfig(backend=leg_backend(dev), max_instances=1 << 12)
    batch = stack_view_batches(_views(scene, cams, rcfg0))
    cfg0 = TrainConfig(
        iterations=n_steps, raster=rcfg0, freq_warmup=0, single_view_weight=0.0,
        # thresholds that make the tiny 32-pixel views clone and split at
        # step 10 (the init opacity must clear the 0.15 clone gate)
        densify=TrainConfig().densify._replace(grad_threshold=1e-4, percent_dense=0.01),
    )

    def run(mesh, shard: bool):
        state = init_from_points(scene.means3d, torch.full((n, 3), 0.5, device=dev), capacity=1024,
                                 knn_scale=None, spatial_lr_scale=3.0, init_opacity=0.5)
        cfg = cfg0
        step, place = dp_step(dev, cfg, mesh, shard_gaussians=shard)
        densify = CompiledDensify().densify_step if on_card(dev) else densify_step
        ts, b = place(init_train_state(state, num_images=V, seed=7), batch)
        losses, events, snaps = [], [], []

        def whole(t):
            return gather_rows(t, mesh) if shard else t

        def snap(tag, t):
            g = whole(t).gaussians
            snaps.append((tag, g.alive.cpu().numpy(), g.params.xyz.cpu().numpy(),
                          g.params.opacity.cpu().numpy()))

        for it in range(1, n_steps + 1):
            if it == 12:
                # instance-budget regrow mid-run: a new step with twice the
                # budget; the placed state flows into it unchanged
                cfg = dataclasses.replace(cfg, raster=dataclasses.replace(cfg.raster, max_instances=1 << 13))
                step, _ = dp_step(dev, cfg, mesh, shard_gaussians=shard)
                events.append(("regrow", it))
            ts, metrics = step(ts, b)
            losses.append(float(metrics["loss"]))
            if it in (10, 30):
                full, info = densify(whole(ts), 3.0, cfg)
                ts = shard_rows(full, mesh) if shard else full
                events.append(("densify", it, int(info["n_alive"])))
                snap(f"densify@{it}", ts)
            if it == 25:
                ts = ts._replace(gaussians=reset_opacity(ts.gaussians), opt=reset_opacity_moments(ts.opt))
                events.append(("reset", it))
                snap(f"reset@{it}", ts)
        return np.asarray(losses), int(whole(ts).gaussians.alive.sum()), events, snaps

    mesh_n = make_mesh(world, data=V, model=model, device_type=dev.type)
    loss_repl, alive_repl, ev_repl, snap_repl = run(mesh_n, False)
    loss_shard, alive_shard, _, snap_shard = run(mesh_n, model > 1)
    loss_base, alive_base, _, snap_base = run(None, False)

    if not (np.isfinite(loss_repl).all() and np.isfinite(loss_shard).all()):
        raise AssertionError("non-finite losses")
    # placement must not change the math: the trajectories track the
    # baseline (reduction-order noise only; looser after the reset, where
    # the dynamics amplify it)
    np.testing.assert_allclose(loss_repl[:10], loss_base[:10], rtol=1e-3)
    np.testing.assert_allclose(loss_shard[:10], loss_base[:10], rtol=1e-3)
    np.testing.assert_allclose(loss_repl, loss_base, rtol=0.25)
    np.testing.assert_allclose(loss_shard, loss_base, rtol=0.25)
    if not alive_repl == alive_shard == alive_base:
        raise AssertionError((alive_repl, alive_shard, alive_base))
    if alive_repl <= n:
        raise AssertionError("densify event brought no rows to life")
    # after every densify and reset the alive mask is bitwise the
    # baseline's; at the first densify the parameters are close (Adam's
    # normalisation turns reduction-order noise into O(lr) steps where a
    # gradient hovers near zero, so the worst row may drift ~1e-2; a
    # placement fault moves most rows by the scene's scale)
    for (tag, a_b, x_b, o_b), (_, a_r, x_r, o_r), (_, a_s, x_s, o_s) in zip(snap_base, snap_repl, snap_shard):
        np.testing.assert_array_equal(a_r, a_b, err_msg=f"{tag} alive repl")
        np.testing.assert_array_equal(a_s, a_b, err_msg=f"{tag} alive shard")
        if tag == "densify@10":
            live = a_b
            for x_o, o_o, who in ((x_r, o_r, "repl"), (x_s, o_s, "shard")):
                np.testing.assert_allclose(x_o[live], x_b[live], rtol=0.5, atol=0.3, err_msg=f"{tag} xyz {who}")
                mean_drift = float(np.abs(x_o[live] - x_b[live]).mean())
                if mean_drift >= 0.02:
                    raise AssertionError((tag, who, mean_drift))
                np.testing.assert_allclose(o_o[live], o_b[live], rtol=0.5, atol=0.3,
                                           err_msg=f"{tag} opacity {who}")
    if not loss_repl[-1] < loss_repl[0]:
        raise AssertionError("no progress through the schedule events")
    if rank == 0:
        print(f"dryrun_schedule_leg({world}): {n_steps} steps, events={ev_repl}, alive {n}→{alive_repl}, "
              f"final loss {loss_repl[-1]:.4f} (baseline {loss_base[-1]:.4f}) ok", flush=True)
    return {"repl": loss_repl, "shard": loss_shard, "base": loss_base, "alive": alive_repl}


def dryrun_worker(rank: int, world: int, init_method: Optional[str], backend: str, device: str,
                  legs: Sequence[str] = ("multichip", "schedule")):
    """One rank of the dry run: join the group, run the legs, leave."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    pdist.initialize_distributed(backend=backend, device=dev, init_method=init_method, world_size=world, rank=rank)
    try:
        if "multichip" in legs:
            dryrun_multichip(world, dev)
        if "schedule" in legs:
            dryrun_schedule_leg(world, dev)
    finally:
        pdist.shutdown_distributed()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Dry run of the view-parallel step on N ranks.")
    p.add_argument("--nproc", type=int, default=1, help="ranks to spawn (ignored under torchrun)")
    p.add_argument("--backend", default=None, help="nccl or gloo; default: nccl on cuda, gloo on cpu")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    backend = a.backend or pdist.default_backend(dev)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # under torchrun
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        device = a.device if dev.type == "cpu" else f"cuda:{int(os.environ.get('LOCAL_RANK', rank)) % torch.cuda.device_count()}"
        # a one-rank torchrun still forms its group: the env:// rendezvous
        dryrun_worker(rank, world, "env://", backend, device)
        return 0
    if backend == "nccl" and a.nproc > torch.cuda.device_count():
        raise RuntimeError(f"NCCL takes one card per rank: {a.nproc} ranks, {torch.cuda.device_count()} "
                           "cards; pass --backend gloo to share a card")
    with tempfile.TemporaryDirectory(prefix="hidegs_dryrun_") as tmp:
        logs = launch(dryrun_worker, a.nproc, (file_init_method(tmp), backend, a.device), DRYRUN_TIMEOUT,
                      os.path.join(tmp, "logs"), threads=1 if dev.type == "cpu" else 0)
    print(logs)
    return 0
