"""Standalone viewer server, `python -m hidegs_tpu_torch.viewer`.

Port of hidegs_tpu/viewer/__main__.py. Two frontends over one render path,
the trained model's latest (or `--iteration`) PLY rendered on `--device`
(default cuda, which raises without a card):
  * the SIBR socket protocol (default), the reference's network_gui wire
    format, so the SIBR remote viewer connects unchanged:
        python -m hidegs_tpu_torch.viewer --model_path /out/run1 [--port 6009]
  * the browser viewer (viewer/http_viewer.py):
        python -m hidegs_tpu_torch.viewer --model_path /out/run1 --http 8080

On a card every frame of both frontends replays the render's CUDA graph
(raster/compiled.py:CompiledRender: one capture per frame size, the four
most recent kept); `--backend oracle` renders eagerly. `--backend` takes
the JAX package's names ("jnp", the default, and "pallas" render with the
port's "blend" backend; see config.port_backend).
"""
from __future__ import annotations

import argparse
import os
import threading
import time

import numpy as np
import torch

from hidegs_tpu_torch.config import port_backend
from hidegs_tpu_torch.convert import load_gaussian_state_from_ply
from hidegs_tpu_torch.device import resolve_device
from hidegs_tpu_torch.raster.api import RasterConfig
from hidegs_tpu_torch.raster.compiled import CompiledRender, serving_render
from hidegs_tpu_torch.train.checkpoint import find_latest_iteration
from hidegs_tpu_torch.viewer.network_gui import NetworkGUI


def parse_args(argv=None):
    ap = argparse.ArgumentParser("hidegs_tpu_torch viewer server")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6009)
    ap.add_argument("--max_instances", type=int, default=1 << 20)
    ap.add_argument("--backend", default="jnp")
    ap.add_argument("--http", type=int, default=0,
                    help="serve the browser viewer on this port instead of the SIBR socket protocol")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def make_render_fn(arrays, cfg: RasterConfig):
    """render_fn(cam, msg=None) → the clipped (3, H, W) image on the model's
    device. On a card each frame of the "blend" backend is a replay of
    `render_fn.compiled`, a CompiledRender (None where `serving_render`
    gives the eager render: off the card, or the "oracle"); frames are
    rendered one at a time, the clip copying the replay's image out
    before the next frame may overwrite it."""
    fn = serving_render(arrays[0].device, cfg)
    lock = threading.Lock()

    def render_fn(cam, msg=None):
        with lock, torch.no_grad():
            return torch.clamp(fn(*arrays, cam, config=cfg)["render"], 0, 1)

    render_fn.compiled = fn if isinstance(fn, CompiledRender) else None
    return render_fn


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = RasterConfig(backend=port_backend(args.backend), max_instances=args.max_instances)
    it = args.iteration
    root = os.path.join(args.model_path, "point_cloud")
    if it == -1:
        it = find_latest_iteration(root)
    arrays = load_gaussian_state_from_ply(os.path.join(root, f"iteration_{it}", "point_cloud.ply"), device=dev)
    render_fn = make_render_fn(arrays, cfg)

    if args.http:
        from hidegs_tpu_torch.viewer.http_viewer import HttpViewer

        xyz = arrays[0].cpu().numpy()
        center = np.median(xyz, axis=0)
        dist = 2.5 * float(np.percentile(np.linalg.norm(xyz - center[None], axis=-1), 90))
        viewer = HttpViewer(
            render_fn, center=center, dist=max(dist, 1.0), host=args.host, port=args.http,
            info={"iteration": it, "n_gaussians": int(xyz.shape[0])}, device=dev,
        )
        print(f"browser viewer on http://{args.host}:{viewer.port} (iteration {it})", flush=True)
        viewer.serve_forever()
        return

    gui = NetworkGUI(args.host, args.port, device=dev)
    print(f"viewer server on {args.host}:{args.port} (iteration {it})", flush=True)
    while True:
        msg = gui.poll(render_fn, verify=args.model_path)
        if msg is None:
            time.sleep(0.005)


if __name__ == "__main__":
    main()
