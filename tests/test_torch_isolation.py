"""hidegs_tpu_torch stands alone: it imports neither jax nor hidegs_tpu,
runs where its caller asks without falling back to the CPU, and its "blend"
backend differentiates through the autograd Function of the blend kernels,
not through plain autograd."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import hidegs_tpu_torch
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.data import synthetic as tsyn
from hidegs_tpu_torch.device import resolve_device
from hidegs_tpu_torch.raster import binning as tbin
from hidegs_tpu_torch.raster import blend_autograd, cuda_blend
from hidegs_tpu_torch.raster import preprocess as tpp
from hidegs_tpu_torch.raster.api import RasterConfig, render

torch.set_num_threads(1)

PKG = pathlib.Path(hidegs_tpu_torch.__file__).parent
REPO = PKG.parent


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    )


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'hidegs_tpu' or m.startswith('hidegs_tpu.'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 25  # the render and training slices


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+hidegs_tpu\b|from\s+hidegs_tpu\b)", re.M)
    sources = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
    assert len(sources) >= 33


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {
        "xyz": np.zeros((4, 3), np.float32), "scaling": np.zeros((4, 3), np.float32),
        "rotation": np.tile(np.array([1, 0, 0, 0], np.float32), (4, 1)),
        "opacity": np.zeros(4, np.float32), "sh_dc": np.zeros((4, 3), np.float32),
        "sh_rest": np.zeros((4, 15, 3), np.float32),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.gaussians_from_jax(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsyn.make_toy_gaussians(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsyn.nadir_grid_camera(0, 0, 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    # asked for explicitly, the CPU works
    out = convert.gaussians_from_jax(params, device="cpu")
    assert all(x.device.type == "cpu" for x in out)


def test_blend_backend_differentiates_through_the_function():
    scene = tsyn.make_toy_gaussians(40, seed=1, device="cpu")
    cam = tsyn.ring_camera(0, height=32, width=32, device="cpu")
    means = scene.means3d.clone().requires_grad_(True)
    pre = tpp.preprocess_gaussians(means, *scene[1:], cam, screen_bounds=(32, 32))
    tb = tbin.bin_gaussians(pre, 2, 2, 1 << 12, 16)
    planes = blend_autograd.blend_tiles(pre, tb, 2, 2, 16)

    def graph_nodes(fn, seen):
        if fn is None or fn in seen:
            return seen
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            graph_nodes(nxt, seen)
        return seen

    names = {type(f).__name__ for f in graph_nodes(planes["render"].grad_fn, set())}
    assert "BlendPackedBackward" in names
    # no op of the plain blend's forward (its exp / log1p / cumsum) is on
    # the graph: the Function's backward stands in for all of it
    assert not names & {"Log1PBackward0", "CumsumBackward0", "IndexAddBackward0"}
    out = render(means, *scene[1:], cam, config=RasterConfig(max_instances=1 << 12))
    out["render"].sum().backward()
    assert means.grad is not None and torch.isfinite(means.grad).all()
    assert float(means.grad.abs().sum()) > 0


def test_kernel_launcher_refuses_cpu_tensors():
    attrs = torch.zeros((4, cuda_blend.ATTR))
    i32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_blend.launch_blend_fwd(attrs, i32, i32[:1], i32[:1], 1, 16,
                                    torch.zeros((1, 256, 16)), i32)


def test_render_refuses_mixed_devices():
    scene = tsyn.make_toy_gaussians(8, seed=1, device="cpu")
    cam = tsyn.ring_camera(0, height=16, width=16, device="cpu")
    with pytest.raises(ValueError, match="one device"):
        render(*scene, cam, background=torch.zeros(3, dtype=torch.float64).to("meta"))
