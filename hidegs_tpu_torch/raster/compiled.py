"""The serving render captured as a CUDA graph.

The JAX package jits `bin_gaussians` and the blend, so a served view is a
few XLA dispatches; the port's `render` issues every operation from the
host (~740 device ops a 1920x1088 view). `CompiledRender` records the
whole render once per static key (utils/graphs.py) and replays it per
view; `serving_render` is what the serving entry points (`evaluate`,
`render_cli`, the viewers' `make_render_fn`) call: a `CompiledRender` for
the "blend" backend on a card, the eager `render` otherwise. `render` itself stays eager: training
differentiates through it, and the train steps capture it as part of
their own graphs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from hidegs_tpu_torch.core import sh as shm
from hidegs_tpu_torch.core.camera_math import CameraParams
from hidegs_tpu_torch.raster.api import RasterConfig, RenderOutputs, _check_same_device, render
from hidegs_tpu_torch.utils.graphs import GraphSet, _spec, on_card, require_cuda

# graphs kept at once: each keeps its outputs (and the pool the buffers of
# its largest render), and the viewers take any image size a client asks for
MAX_KEYS = 4


def render_key(means3d, scales, quats, opacities, shs, cam: CameraParams, background=None,
               active_sh_degree=shm.MAX_SH_DEGREE, render_geo: bool = False, colors_precomp=None,
               config: RasterConfig = RasterConfig()) -> tuple:
    """The key a render graph is captured for, what `jax.jit` retraces on:
    the config, `active_sh_degree`, `render_geo`, the specs of the five
    arrays and of `colors_precomp`, the camera's (its image size and
    frustum extent) and whether a background is given."""
    return (config, int(active_sh_degree), bool(render_geo), _spec((means3d, scales, quats, opacities, shs)),
            _spec(colors_precomp), _spec(cam), _spec(background))


class CompiledRender(GraphSet):
    """`render` under `torch.no_grad`, captured once per static key
    (`render_key`) as a CUDA graph and replayed (utils/graphs.py's
    `GraphSet.run`): preprocess, the optional visible-row compaction,
    binning, the forward blend kernel and the `render_geo` planes in one
    replay. Called as `render` is, on a model on a CUDA device.

      * the five arrays and `colors_precomp` are held by reference: the
        graphs read the tensors of the first call (236 MB at 1M gaussians,
        never copied), and a call with other tensors for them raises: use
        one CompiledRender per model;
      * the camera's tensors and the background are copied into the
        graph's static inputs before each replay;
      * the returned dict holds the graph's static tensors: the next call
        (any key: the graphs share one pool) overwrites them, so a caller
        that keeps an output past the next call clones it;
      * at most MAX_KEYS graphs are kept: a new key past them
        frees the least recently used one, recorded in `evictions`;
      * one call at a time: a caller that renders from several threads
        holds a lock across the call and its read of the outputs
        (viewer/__main__.make_render_fn does); a capture forbids unsafe
        CUDA calls in its own thread only (a viewer captures in an HTTP
        handler thread).

    There is no fallback: arrays off the card raise ValueError, as do the
    "plain" blend (it reads tile counts to the host) and the "oracle"; a
    failed capture raises RuntimeError."""

    capture_error_mode = "thread_local"

    def __init__(self):
        super().__init__("the render")
        self.evictions: List[Dict[str, Any]] = []

    @staticmethod
    def body(*args, **kwargs) -> RenderOutputs:
        """What a graph captures: `render` under no_grad."""
        with torch.no_grad():
            return render(*args, **kwargs)

    def _new_key(self, key, dev) -> None:
        while len(self._graphs) >= MAX_KEYS:
            _, old = self._graphs.popitem(last=False)
            self.evictions.append(dict(old.info, replays_at_eviction=self.replays))

    def __call__(self, means3d, scales, quats, opacities, shs, cam: CameraParams, background=None,
                 active_sh_degree=shm.MAX_SH_DEGREE, render_geo: bool = False, colors_precomp=None,
                 config: RasterConfig = RasterConfig()) -> RenderOutputs:
        arrays = (means3d, scales, quats, opacities, shs)
        dev = means3d.device
        require_cuda(dev, "the compiled render", "render")
        _check_same_device(cam, *arrays, background, colors_precomp)
        if config.backend != "blend":
            raise ValueError(f"the compiled render runs the 'blend' backend, not {config.backend!r}: the plain "
                             "blend reads tile counts to the host and the oracle is a dense reference; "
                             "call render for those")
        key = render_key(*arrays, cam, background, active_sh_degree, render_geo, colors_precomp, config)

        def body(_, c, bg):
            return self.body(*arrays, c, background=bg, active_sh_degree=active_sh_degree, render_geo=render_geo,
                             colors_precomp=colors_precomp, config=config)

        info = dict(image=(cam.height, cam.width), tile=config.tile, max_instances=config.max_instances,
                    render_geo=bool(render_geo))
        outputs, _ = self.run(key, dev, body, (cam, background), held=(arrays, colors_precomp), info=info)
        self._graphs.move_to_end(key)
        return dict(outputs)


def serving_render(device, config: RasterConfig) -> Callable[..., RenderOutputs]:
    """The render of a serving entry point that renders with `config` on
    `device`, called as `render` is under no_grad: a new CompiledRender
    (one per model) for the "blend" backend on a card; the eager `render`
    off the card and for the backends the user picked that a graph does
    not run ("plain", "oracle")."""
    return CompiledRender() if on_card(device) and config.backend == "blend" else render
