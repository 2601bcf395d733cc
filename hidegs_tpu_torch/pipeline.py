"""The large-scene pipeline — the offline flow of SURVEY §3.6 end-to-end:

    chunk the COLMAP scene → train each chunk → build per-chunk hierarchies
    → merge into a global hierarchy → (optional) post-optimize → LOD eval

Port of hidegs_tpu/pipeline.py. Run as

    python -m hidegs_tpu_torch.pipeline --source_path ... --output_path ... [--device cuda]

Everything runs on `--device` (default cuda, which raises without a card).
Chunks train sequentially in-process, or with `--workers N` each in its
own process (`python -m hidegs_tpu_torch.pipeline --chunk i j ... --device
<the parent's>`), the analog of the reference's SLURM fan-out
(preprocess/generate_chunks.py:17-35): the per-chunk work shares nothing
but the filesystem. `--backend` takes the JAX package's values ("jnp",
"pallas"), mapped to the port's blend (config.port_backend). The output
directory is the JAX pipeline's layout.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from hidegs_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig, port_backend
from hidegs_tpu_torch.data import colmap
from hidegs_tpu_torch.data.scene import load_scene
from hidegs_tpu_torch.device import DeviceLike, resolve_device
from hidegs_tpu_torch.hier.build import build_hierarchy
from hidegs_tpu_torch.hier.interp import hierarchy_tensors, pack_attributes, render_hierarchy
from hidegs_tpu_torch.hier.io import Hierarchy, read_hier, write_hier
from hidegs_tpu_torch.hier.lod import expand_packed, pack_hierarchy, tau_to_target_size
from hidegs_tpu_torch.hier.merge import merge_hierarchies
from hidegs_tpu_torch.preprocess import chunking
from hidegs_tpu_torch.raster.api import RasterConfig
from hidegs_tpu_torch.train.hier_trainer import hierarchy_from_state, post_optimize
from hidegs_tpu_torch.train.losses import psnr
from hidegs_tpu_torch.train.trainer import train
from hidegs_tpu_torch.utils.ply import load_gaussian_arrays


def train_one_chunk(
    source_path: str,
    chunks_dir: str,
    ci: int,
    cj: int,
    iterations: int = 1000,
    capacity: int = 0,
    max_instances: int = 1 << 18,
    backend: str = "jnp",
    resolution: int = -1,
    skybox_num: int = 0,
    log_every: int = 200,
    scaffold_dir: str = "",
    device: DeviceLike = "cuda",
) -> str:
    """Train chunk (ci, cj) on `device` and build its hierarchy. Idempotent:
    returns immediately if `hierarchy.hier` already exists (fan-out resume).
    This is the per-process unit of the chunk fan-out — the analog of one
    SLURM job in the reference's generate_chunks.py:17-35."""
    cdir = os.path.join(chunks_dir, f"chunk_{ci}_{cj}")
    hier_path = os.path.join(cdir, "hierarchy.hier")
    if os.path.exists(hier_path):
        print(f"[pipeline] chunk_{ci}_{cj}: hierarchy exists, skipping", flush=True)
        return hier_path
    model_dir = os.path.join(cdir, "trained")
    # chunk scenes reuse the full images directory
    model_cfg = ModelConfig(
        source_path=cdir,
        model_path=model_dir,
        images=os.path.join(os.path.relpath(source_path, cdir), "images"),
        resolution=resolution,
        skybox_num=skybox_num,
        scaffold_file=scaffold_dir,
    )
    # Box cull ONLY with a scaffold (the reference pairing,
    # gaussian_model.py:235-274 + forward.cu:319-321): culling out-of-cell
    # gaussians without one makes border pixels that show out-of-cell
    # content unexplainable, and the gradient pushes in-cell gaussians to
    # cover them. With a scaffold the frozen coarse-model border annulus
    # explains those pixels, so the cull can confine gradient to the cell.
    pipe_cfg = PipelineConfig(
        raster_backend=backend, max_instances=max_instances, capacity=capacity,
        chunk_box_cull=bool(scaffold_dir),
    )
    opt_cfg = OptimizationConfig(
        iterations=iterations,
        densify_from_iter=max(iterations // 10, 50),
        densify_until_iter=int(iterations * 0.8),
        # //20 (not //10): long chunk schedules (≥5k) get ~14 densify
        # events, so the chunk actually reaches its capacity
        densification_interval=max(iterations // 20, 50),
        opacity_reset_interval=10 * iterations,
        freq_warmup_iterations=max(iterations // 10, 20),
        single_view_weight_from_iter=max(iterations // 3, 100),
        multi_view_weight_from_iter=max(iterations // 2, 100),
        multi_view_sample_num=1024,
    )
    print(f"[pipeline] training chunk_{ci}_{cj}", flush=True)
    train(model_cfg, pipe_cfg, opt_cfg, save_iterations=(iterations,), log_every=log_every, device=device)
    ply_path = os.path.join(model_dir, "point_cloud", f"iteration_{iterations}", "point_cloud.ply")
    d = load_gaussian_arrays(ply_path)
    shs = np.concatenate([d["sh_dc"][:, None, :], d["sh_rest"]], axis=1)
    h = build_hierarchy(
        d["xyz"], d["rotation"], np.exp(d["scaling"]),
        1.0 / (1.0 + np.exp(-d["opacity"])), shs,
    )
    write_hier(hier_path, h)
    print(f"[pipeline] chunk_{ci}_{cj}: {h.num_points} gaussians → {hier_path}", flush=True)
    return hier_path


def _fanout_chunks(chunks, source_path: str, output_path: str, workers: int, **kw) -> None:
    """Run each chunk's training in its own subprocess, `workers` at a time.

    Subprocesses invoke `python -m hidegs_tpu_torch.pipeline --chunk i j
    ... --device <kw["device"]>`, which routes to train_one_chunk and exits.
    A failed worker is retried once (idempotent resume: finished chunks
    short-circuit); a second failure raises."""
    def cmd_for(ch):
        return [
            sys.executable, "-m", "hidegs_tpu_torch.pipeline",
            "--source_path", source_path,
            "--output_path", output_path,
            "--chunk", str(ch.i), str(ch.j),
            "--chunk_size", str(kw["chunk_size"]),
            "--min_n_cams", str(kw["min_n_cams"]),
            "--iterations", str(kw["iterations"]),
            "--capacity", str(kw["capacity"]),
            "--max_instances", str(kw["max_instances"]),
            "--backend", kw["backend"],
            "--resolution", str(kw["resolution"]),
            "--skybox_num", str(kw["skybox_num"]),
            "--scaffold_dir", kw.get("scaffold_dir", ""),
            "--device", str(kw["device"]),
        ]

    pending = list(chunks)
    retried = set()
    running = {}  # popen -> chunk
    t0 = time.time()
    try:
        while pending or running:
            while pending and len(running) < workers:
                ch = pending.pop(0)
                p = subprocess.Popen(cmd_for(ch), env=dict(os.environ))
                running[p] = ch
                print(f"[pipeline] worker started for chunk_{ch.i}_{ch.j} "
                      f"(pid {p.pid}, {len(running)} running)", flush=True)
            done = [p for p in running if p.poll() is not None]
            if not done:
                time.sleep(0.5)
                continue
            for p in done:
                ch = running.pop(p)
                if p.returncode != 0:
                    key = (ch.i, ch.j)
                    if key in retried:
                        raise RuntimeError(f"chunk_{ch.i}_{ch.j} worker failed twice (rc={p.returncode})")
                    retried.add(key)
                    print(f"[pipeline] chunk_{ch.i}_{ch.j} failed (rc={p.returncode}) — retrying", flush=True)
                    pending.append(ch)
                else:
                    print(f"[pipeline] chunk_{ch.i}_{ch.j} worker done ({time.time()-t0:.0f}s)", flush=True)
    finally:
        # a raise leaves no worker running behind it
        for p in running:
            p.kill()
            p.wait()


def run_pipeline(
    source_path: str,
    output_path: str,
    chunk_size: float = 30.0,
    min_n_cams: int = 4,
    iterations: int = 1000,
    post_opt_iterations: int = 0,
    capacity: int = 0,
    max_instances: int = 1 << 18,
    backend: str = "jnp",
    resolution: int = -1,
    skybox_num: int = 0,
    add_far_cams: bool = True,
    log_every: int = 200,
    eval_taus=(0.0, 3.0, 6.0, 15.0),
    workers: int = 1,
    coarse_iterations: int = 0,
    device: DeviceLike = "cuda",
):
    """Returns the path of the merged global hierarchy."""
    dev = resolve_device(device)
    t0 = time.time()
    os.makedirs(output_path, exist_ok=True)

    # ---- 1. chunk the scene (make_chunk.py equivalent) -----------------
    sparse = os.path.join(source_path, "sparse", "0")
    cams, imgs, (xyz, rgb, err, _ids) = colmap.read_model(sparse)
    chunks = chunking.compute_chunks(
        cams, imgs, xyz, err, chunk_size=chunk_size, min_n_cams=min_n_cams,
        add_far_cams=add_far_cams,
    )
    if not chunks:
        raise RuntimeError("no viable chunks (lower --min_n_cams or raise --chunk_size)")
    chunks_dir = os.path.join(output_path, "chunks")
    chunking.write_chunks(chunks, cams, imgs, xyz, rgb, err, chunks_dir)
    print(f"[pipeline] {len(chunks)} chunks ({time.time()-t0:.0f}s)", flush=True)

    # ---- 1.5 coarse global model → per-chunk scaffold ------------------
    # The reference trains each chunk against a frozen border scaffold cut
    # from a coarse whole-scene model (gaussian_model.py:235-274); the
    # scaffold explains the border pixels showing out-of-cell content so
    # the chunk-AABB cull can ship ON (see train_one_chunk's note).
    scaffold_dir = ""
    if coarse_iterations > 0:
        coarse_out = os.path.join(output_path, "coarse")
        sdir = os.path.join(coarse_out, "point_cloud", f"iteration_{coarse_iterations}")
        if os.path.exists(os.path.join(sdir, "point_cloud.ply")):
            print("[pipeline] coarse model exists, skipping", flush=True)
        else:
            print(f"[pipeline] coarse global model ({coarse_iterations} iters)", flush=True)
            train(
                ModelConfig(
                    source_path=source_path, model_path=coarse_out,
                    resolution=resolution, skybox_num=skybox_num,
                ),
                PipelineConfig(
                    raster_backend=backend, max_instances=max_instances,
                    capacity=capacity,
                ),
                OptimizationConfig(
                    iterations=coarse_iterations,
                    densify_from_iter=max(coarse_iterations // 10, 50),
                    densify_until_iter=int(coarse_iterations * 0.8),
                    densification_interval=max(coarse_iterations // 10, 50),
                    opacity_reset_interval=10 * coarse_iterations,
                    freq_warmup_iterations=max(coarse_iterations // 10, 20),
                    single_view_weight=0.0,
                    multi_view_ncc_weight=0.0,
                ),
                save_iterations=(coarse_iterations,), log_every=log_every, device=dev,
            )
        scaffold_dir = sdir
        print(f"[pipeline] scaffold source: {scaffold_dir} ({time.time()-t0:.0f}s)", flush=True)

    # ---- 2. per-chunk training + hierarchy build -----------------------
    # Sequential in-process by default; `workers > 1` fans each chunk out to
    # its own subprocess — chunks share nothing but the filesystem, and
    # already-built chunk hierarchies are skipped so a crashed fan-out
    # resumes where it left off.
    centers = [ch.center for ch in chunks]
    extents = [ch.extent for ch in chunks]
    if workers > 1:
        _fanout_chunks(
            chunks, source_path, output_path, workers,
            chunk_size=chunk_size, min_n_cams=min_n_cams,
            iterations=iterations, capacity=capacity,
            max_instances=max_instances, backend=backend,
            resolution=resolution, skybox_num=skybox_num,
            scaffold_dir=scaffold_dir, device=dev,
        )
        hier_paths = []
        for ch in chunks:
            p = os.path.join(chunks_dir, f"chunk_{ch.i}_{ch.j}", "hierarchy.hier")
            if not os.path.exists(p):
                raise RuntimeError(f"chunk worker produced no hierarchy: {p}")
            hier_paths.append(p)
    else:
        hier_paths = []
        for ch in chunks:
            hier_paths.append(train_one_chunk(
                source_path, chunks_dir, ch.i, ch.j,
                iterations=iterations, capacity=capacity,
                max_instances=max_instances, backend=backend,
                resolution=resolution, skybox_num=skybox_num,
                log_every=log_every, scaffold_dir=scaffold_dir, device=dev,
            ))
            print(f"[pipeline] chunk_{ch.i}_{ch.j} done ({time.time()-t0:.0f}s)", flush=True)

    # ---- 3. merge into the global hierarchy ----------------------------
    merged = merge_hierarchies([read_hier(p) for p in hier_paths], centers, extents)
    merged_path = os.path.join(output_path, "merged.hier")
    write_hier(merged_path, merged)
    print(f"[pipeline] merged {len(hier_paths)} chunks → {merged.num_points} "
          f"gaussians, {merged.num_nodes} nodes → {merged_path}", flush=True)

    # ---- 4. optional global post-optimization --------------------------
    if post_opt_iterations > 0:
        scene = load_scene(source_path, resolution=resolution, cache_all=True)
        views = [scene.train_cameras[i] for i in range(len(scene.train_cameras))]
        h = read_hier(merged_path)
        # exposure trained during post-opt: per-chunk exposure compensation
        # does not survive the merge, so the global hierarchy re-fits
        # per-image exposure from identity here
        ts = post_optimize(
            h, [v.cam_params(device=dev) for v in views], [v.image for v in views],
            iterations=post_opt_iterations,
            raster_cfg=RasterConfig(backend=port_backend(backend), max_instances=max_instances),
            log_every=log_every, optimize_exposure=True, device=dev,
        )
        write_hier(os.path.join(output_path, "merged_opt.hier"), hierarchy_from_state(ts, h))
        print("[pipeline] post-optimized hierarchy → merged_opt.hier", flush=True)

    # ---- 5. LOD render evaluation (render_post flow, §3.4) --------------
    lod_report = evaluate_lod(
        os.path.join(output_path, "merged_opt.hier") if post_opt_iterations > 0 else merged_path,
        source_path, resolution=resolution, backend=backend,
        max_instances=max_instances, taus=eval_taus, device=dev,
    )
    for row in lod_report:
        print(f"[pipeline] LOD tau={row['tau']}: cut={row['mean_cut']:.0f} "
              f"gaussians, PSNR={row['psnr']:.2f}", flush=True)

    with open(os.path.join(output_path, "pipeline.json"), "w") as f:
        json.dump(
            {
                "chunks": [[int(c.i), int(c.j)] for c in chunks],
                "merged": merged_path,
                "num_points": int(merged.num_points),
                "num_nodes": int(merged.num_nodes),
                "lod_eval": lod_report,
                "seconds": time.time() - t0,
            },
            f,
            indent=1,
        )
    return merged_path


def lod_sweep(h: Hierarchy, cams, images, taus, config: RasterConfig):
    """The τ sweep of hierarchy `h` over the views `cams` (camera params on
    one device) against `images` ((H, W, 3) float tensors on that device).
    The hierarchy and its attribute matrix are packed once; each (tau, view)
    is one cut under JAX's budget rule and one render, and the host reads
    the clipped renders' PSNRs, the cut sizes, the frames' instance counts
    and overflows once per tau. Returns one dict per tau: `tau`, `psnr` and
    `mean_cut` (means over the views), and the per-view lists `cuts` and
    `instances` and the summed `overflow`."""
    dev = images[0].device
    P = int(h.num_points)
    budget = 1 << max(int(np.ceil(np.log2(max(P, 2)))), 10)
    nodes, boxes, *arrays = hierarchy_tensors(h, dev)
    packed = pack_hierarchy(nodes, boxes)
    attrs = pack_attributes(*arrays)
    sweep = []
    with torch.no_grad():
        for tau in taus:
            rows = []
            for cp, gt in zip(cams, images):
                # taus are PIXEL granularities (reference convention); 0 = leaves
                target = 0.0 if tau == 0 else tau_to_target_size(tau, float(cp.fx))
                cut = expand_packed(packed, target, cp.camera_center, budget=budget, num_points=P)
                out = render_hierarchy(cut, *arrays, cp, config=config, attrs=attrs)
                img = torch.clamp(out["render"], 0.0, 1.0)
                rows.append(torch.stack([psnr(img, gt).double(), cut.valid.sum().double(),
                                         out["num_instances"].double(), out["overflow"].double()]))
            psnrs, cuts, instances, overflow = torch.stack(rows).T.tolist()
            sweep.append({
                "tau": float(tau),
                "psnr": float(np.mean(psnrs)),
                "mean_cut": float(np.mean(cuts)),
                "cuts": [int(c) for c in cuts],
                "instances": [int(n) for n in instances],
                "overflow": int(sum(overflow)),
            })
    return sweep


def evaluate_lod(
    hier_path: str,
    source_path: str,
    resolution: int = -1,
    backend: str = "jnp",
    max_instances: int = 1 << 18,
    taus=(0.0, 3.0, 6.0, 15.0),
    max_views: int = 8,
    device: DeviceLike = "cuda",
):
    """Render the global hierarchy at several granularities (`tau`, the
    projected node-size threshold of expand_to_size — 0 = full detail) and
    report PSNR + mean cut size per tau, the render_post evaluation flow
    (reference §3.4; h3dgs render_hierarchy.py pattern): `lod_sweep` over
    the scene's first `max_views` training views, whose images are uploaded
    once."""
    dev = resolve_device(device)
    h = read_hier(hier_path)
    scene = load_scene(source_path, resolution=resolution, cache_all=False)
    views = [scene.train_cameras[i] for i in range(min(len(scene.train_cameras), max_views))]
    cfg = RasterConfig(backend=port_backend(backend), max_instances=max_instances)
    sweep = lod_sweep(h, [cam.cam_params(device=dev) for cam in views],
                      [torch.as_tensor(cam.image, device=dev) for cam in views], taus, cfg)
    return [{k: r[k] for k in ("tau", "psnr", "mean_cut")} for r in sweep]


def main(argv=None):
    ap = argparse.ArgumentParser("hidegs_tpu_torch large-scene pipeline")
    ap.add_argument("--source_path", required=True)
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--chunk_size", type=float, default=30.0)
    ap.add_argument("--min_n_cams", type=int, default=100)
    ap.add_argument("--iterations", type=int, default=30_000)
    ap.add_argument("--post_opt_iterations", type=int, default=0)
    ap.add_argument("--capacity", type=int, default=0)
    ap.add_argument("--max_instances", type=int, default=1 << 20)
    ap.add_argument("--backend", default="jnp")
    ap.add_argument("--resolution", type=int, default=-1)
    ap.add_argument("--skybox_num", type=int, default=0)
    ap.add_argument("--eval_taus", type=float, nargs="*", default=[0.0, 3.0, 6.0, 15.0])
    ap.add_argument("--workers", type=int, default=1,
                    help="concurrent per-chunk training subprocesses (the "
                         "SLURM-fan-out analog; 1 = sequential in-process)")
    ap.add_argument("--chunk", type=int, nargs=2, default=None, metavar=("I", "J"),
                    help="worker mode: train ONLY chunk (i, j) from an "
                         "already-chunked output dir, then exit")
    ap.add_argument("--coarse_iterations", type=int, default=0,
                    help="train a coarse whole-scene model first and use its "
                         "border annulus as each chunk's frozen scaffold "
                         "(enables the chunk-AABB cull, reference pairing)")
    ap.add_argument("--scaffold_dir", default="",
                    help="worker mode: scaffold checkpoint dir for the chunk")
    ap.add_argument("--device", default="cuda",
                    help="device of every stage, and of the chunk workers; cuda unless the CPU is asked for")
    args = ap.parse_args(argv)
    if args.chunk is not None:
        train_one_chunk(
            args.source_path, os.path.join(args.output_path, "chunks"),
            args.chunk[0], args.chunk[1],
            iterations=args.iterations, capacity=args.capacity,
            max_instances=args.max_instances, backend=args.backend,
            resolution=args.resolution, skybox_num=args.skybox_num,
            scaffold_dir=args.scaffold_dir, device=args.device,
        )
        return
    run_pipeline(
        args.source_path, args.output_path,
        chunk_size=args.chunk_size, min_n_cams=args.min_n_cams,
        iterations=args.iterations, post_opt_iterations=args.post_opt_iterations,
        capacity=args.capacity, max_instances=args.max_instances,
        backend=args.backend, resolution=args.resolution, skybox_num=args.skybox_num,
        eval_taus=tuple(args.eval_taus), workers=args.workers,
        coarse_iterations=args.coarse_iterations, device=args.device,
    )


if __name__ == "__main__":
    main()
