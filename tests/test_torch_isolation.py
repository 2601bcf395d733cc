"""hidegs_tpu_torch stands alone: it imports neither jax nor hidegs_tpu,
runs where its caller asks without falling back to the CPU, and its "blend"
backend differentiates through the autograd Function of the blend kernels,
not through plain autograd."""
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import hidegs_tpu_torch
from hidegs_tpu_torch import convert, evaluate
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
    # the render, training, serving, trainer, LOD/viewer, pipeline and
    # multi-GPU slices
    assert int(proc.stdout.split()[0]) >= 68


def test_the_scan_covers_the_hierarchy_and_the_viewers():
    mods = _modules()
    for name in ("hier.io", "hier.build", "hier.lod", "hier.interp", "hier.streaming",
                 "viewer.network_gui", "viewer.http_viewer", "viewer.__main__"):
        assert f"hidegs_tpu_torch.{name}" in mods, name


PIPELINE_SLICE = ("model.appearance", "train.hier_trainer", "hier.refine", "hier.merge", "hier.cli", "pipeline",
                  "preprocess.align", "preprocess.chunk_refine", "preprocess.chunking", "preprocess.colmap_driver",
                  "preprocess.database", "preprocess.depth_scale", "preprocess.masks", "preprocess.monodepth",
                  "preprocess.reorient")


def test_the_scan_covers_the_pipeline_slice():
    mods = _modules()
    assert len(PIPELINE_SLICE) == 15
    for name in PIPELINE_SLICE:
        assert f"hidegs_tpu_torch.{name}" in mods, name


PARALLEL_SLICE = ("parallel.mesh", "parallel.distributed", "parallel.bands", "parallel.sharded",
                  "parallel.dryrun", "parallel.__main__", "utils.profiling")


def test_the_scan_covers_the_parallel_slice():
    mods = _modules()
    for name in PARALLEL_SLICE:
        assert f"hidegs_tpu_torch.{name}" in mods, name


def test_parallel_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """`python -m hidegs_tpu_torch.parallel` and the process group run on
    the card unless the caller asks for the CPU; NCCL is never swapped for
    gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from hidegs_tpu_torch.parallel import distributed as pdist
    from hidegs_tpu_torch.parallel import dryrun

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--nproc", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdist.initialize_distributed(init_method=dryrun.file_init_method(str(tmp_path)), world_size=1, rank=0)
    assert pdist.default_backend("cuda") == "nccl" and pdist.default_backend("cpu") == "gloo"
    launched = []
    monkeypatch.setattr(dryrun, "launch", lambda *a, **k: launched.append(a) or "")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per rank"):
        dryrun.main(["--nproc", "2"])
    dryrun.main(["--nproc", "2", "--backend", "gloo"])
    assert launched[0][2][1:3] == ("gloo", "cuda")


def test_chunk_workers_run_the_port_on_the_parents_device(monkeypatch, tmp_path):
    """_fanout_chunks starts `python -m hidegs_tpu_torch.pipeline --chunk i
    j ... --device <the parent's>` (never the JAX module), with the
    parent's environment untouched: no platform probe picks a device."""
    from types import SimpleNamespace

    from hidegs_tpu_torch import pipeline

    started = []

    class Done:
        def __init__(self, cmd, env):
            started.append((cmd, env))
            self.pid, self.returncode = len(started), 0

        def poll(self):
            return 0

    monkeypatch.setattr(pipeline.subprocess, "Popen", Done)
    chunks = [SimpleNamespace(i=0, j=1), SimpleNamespace(i=2, j=0)]
    kw = dict(chunk_size=14.0, min_n_cams=3, iterations=3, capacity=256, max_instances=4096, backend="jnp",
              resolution=1, skybox_num=0, scaffold_dir="")
    for device in ("cuda", "cpu"):
        started.clear()
        pipeline._fanout_chunks(chunks, "scene", str(tmp_path), 2, device=torch.device(device), **kw)
        assert len(started) == 2
        for (cmd, env), ch in zip(started, chunks):
            assert cmd[1:3] == ["-m", "hidegs_tpu_torch.pipeline"] and "hidegs_tpu.pipeline" not in cmd
            assert cmd[cmd.index("--chunk") + 1:cmd.index("--chunk") + 3] == [str(ch.i), str(ch.j)]
            assert cmd[cmd.index("--device") + 1] == device
            assert env == dict(os.environ)


def test_pipeline_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from hidegs_tpu_torch import pipeline
    from hidegs_tpu_torch.hier import cli, io
    from hidegs_tpu_torch.model import appearance
    from hidegs_tpu_torch.preprocess import monodepth
    from hidegs_tpu_torch.train import hier_trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.main(["--source_path", "scene", "--output_path", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.evaluate_lod("merged.hier", "scene")
    h = io.Hierarchy(np.zeros((1, 3), np.float32), np.array([[1, 0, 0, 0]], np.float32), np.zeros((1, 3), np.float32),
                     np.ones(1, np.float32), np.zeros((1, 16, 3), np.float32),
                     np.array([[0, -1, 0, 1, 0, -1, 0]], np.int32), np.zeros((1, 2, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hier_trainer.post_optimize(h, [], [], iterations=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        appearance.init_app_model(2)
    (tmp_path / "images").mkdir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        monodepth.main(["--images_dir", str(tmp_path / "images"), "--out_dir", str(tmp_path / "depths")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        monodepth.generate_depth_maps(str(tmp_path / "images"), str(tmp_path / "depths"))
    scene = tmp_path / "scene"
    tsyn.write_synthetic_colmap_scene(str(scene), tsyn.make_toy_gaussians(20, seed=1, device="cpu"),
                                      [tsyn.ring_camera(0, height=16, width=16, device="cpu")],
                                      RasterConfig(max_instances=1 << 10))
    ply = tmp_path / "point_cloud.ply"
    from hidegs_tpu_torch.utils.ply import gaussian_properties, write_ply

    write_ply(str(ply), gaussian_properties(np.zeros((4, 3), np.float32) + np.arange(4)[:, None],
                                            np.zeros((4, 3), np.float32), np.zeros((4, 15, 3), np.float32),
                                            np.zeros(4, np.float32), np.full((4, 3), -2.0, np.float32),
                                            np.tile(np.array([1, 0, 0, 0], np.float32), (4, 1))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["create", "--ply", str(ply), "--out", str(tmp_path / "h.hier"), "--cameras", str(scene)])
    cli.main(["create", "--ply", str(ply), "--out", str(tmp_path / "h.hier"), "--cameras", str(scene),
              "--device", "cpu"])
    assert (tmp_path / "anchors.bin").exists()


def test_native_builder_never_resolves_a_path_of_the_jax_package(monkeypatch, tmp_path):
    """The port's hierarchy builder compiles its own copy of
    hier_builder.cpp into build/hier/ and loads that library, never the JAX
    package's source or its libhier_builder.so."""
    import ctypes

    from hidegs_tpu_torch.hier import build as tbuild

    jax_pkg = (REPO / "hidegs_tpu").resolve()
    for path in (tbuild.SRC, tbuild.BUILD_DIR, tbuild.lib_path()):
        assert jax_pkg not in path.resolve().parents, path
    assert tbuild.SRC.read_bytes() == (jax_pkg / "hier" / "native" / "hier_builder.cpp").read_bytes()
    loaded, commands = [], []
    real_cdll, real_run = ctypes.CDLL, tbuild.subprocess.run
    monkeypatch.setattr(tbuild.ctypes, "CDLL", lambda path, *a, **k: loaded.append(path) or real_cdll(path, *a, **k))
    monkeypatch.setattr(tbuild.subprocess, "run", lambda cmd, **k: commands.append(cmd) or real_run(cmd, **k))
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build" / "hier")
    monkeypatch.setattr(tbuild, "_lib", None)
    h = tbuild.build_hierarchy(*tsyn.make_toy_gaussians(20, seed=3, device="cpu")[:1],
                               np.tile(np.array([1, 0, 0, 0], np.float32), (20, 1)), np.full((20, 3), 0.1, np.float32),
                               np.full(20, 0.5, np.float32), np.zeros((20, 16, 3), np.float32), use_native=True)
    assert h.num_nodes == 39
    assert loaded == [str(tmp_path / "build" / "hier" / tbuild.lib_path().name)]
    assert len(commands) == 1 and all(jax_pkg not in pathlib.Path(a).resolve().parents
                                      for a in commands[0] if a.startswith("/"))


def test_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+hidegs_tpu\b|from\s+hidegs_tpu\b)", re.M)
    sources = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
    assert len(sources) >= 71


def test_serving_path_needs_no_pillow(tmp_path):
    """Write a COLMAP scene and a model directory, evaluate it and render it
    through the port's entry points on the CPU, in a process where Pillow
    cannot be imported: the PNG codec of utils/png.py carries the path."""
    code = f"""
import sys
sys.modules["PIL"] = None
import json, os
import torch
from hidegs_tpu_torch import config, evaluate, render_cli
from hidegs_tpu_torch.data import synthetic as tsyn
from hidegs_tpu_torch.raster.api import RasterConfig
from hidegs_tpu_torch.utils.ply import gaussian_properties, write_ply
root = {str(tmp_path)!r}
scene = tsyn.make_toy_gaussians(120, seed=2, device="cpu")
cams = [tsyn.ring_camera(i, n_cams=2, height=32, width=40, device="cpu") for i in range(2)]
tsyn.write_synthetic_colmap_scene(root + "/scene", scene, cams, RasterConfig(max_instances=1 << 12))
os.makedirs(root + "/model/point_cloud/iteration_7")
op = scene.opacities.numpy()
write_ply(root + "/model/point_cloud/iteration_7/point_cloud.ply", gaussian_properties(
    scene.means3d.numpy(), scene.shs[:, 0].numpy(), scene.shs[:, 1:].numpy(), (torch.log(scene.opacities)
    - torch.log1p(-scene.opacities)).numpy(), torch.log(scene.scales).numpy(), scene.quats.numpy()))
config.save_cfg_args(root + "/model", config.ModelConfig(source_path=root + "/scene"),
                     config.PipelineConfig(tile=16, max_instances=1 << 12), config.OptimizationConfig())
report = evaluate.main(["--model_path", root + "/model", "--source_path", root + "/scene", "--resolution", "1", "--device", "cpu"])
render_cli.main(["--model_path", root + "/model", "--source_path", root + "/scene", "--resolution", "1", "--device", "cpu",
                 "--max_instances", "4096", "--output_path", root + "/renders"])
print("RESULT", json.dumps([[v["psnr"] for v in report["train"]["per_view"]], sorted(os.listdir(root + "/renders"))]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    psnrs, renders = json.loads(proc.stdout.split("RESULT", 1)[1])
    assert len(psnrs) == 2 and min(psnrs) > 35.0  # the model is the scene: only 8-bit rounding differs
    assert renders == ["00000.png", "00001.png"]


def test_training_path_needs_no_pillow(tmp_path):
    """Write a terrain scene (16-bit monodepth maps) and train it with the
    multi-view terms, depth supervision and a debug panel through the
    port's trainer on the CPU, in a process where Pillow cannot be
    imported."""
    code = f"""
import sys
sys.modules["PIL"] = None
import json, os
import torch
from hidegs_tpu_torch.data import synthetic as tsyn
from hidegs_tpu_torch.train import trainer
root = {str(tmp_path)!r}
cams = [tsyn.nadir_grid_camera(ix, iy, 2, 2, height=32, width=40, device="cpu") for iy in range(2) for ix in range(2)]
tsyn.write_terrain_colmap_scene(root + "/scene", cams, n_points=300)
ts = trainer.main(["--source_path", root + "/scene", "--model_path", root + "/model", "--depths", "depths",
                   "--iterations", "4", "--device", "cpu", "--freq_warmup_iterations", "0",
                   "--single_view_weight_from_iter", "0", "--multi_view_weight_from_iter", "1",
                   "--depth_from_iter", "0", "--multi_view_sample_num", "128", "--debug_panel_every", "4",
                   "--save_iterations", "4", "--max_instances", "4096"])
print("RESULT", json.dumps([int(ts.step), sorted(os.listdir(root + "/model/freq_debug")),
                            sorted(os.listdir(root + "/model/point_cloud"))]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    step, panels, ckpts = json.loads(proc.stdout.split("RESULT", 1)[1])
    assert step == 4 and len(panels) == 1 and ckpts == ["iteration_4"]


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
    from hidegs_tpu_torch.train import lpips

    with pytest.raises(RuntimeError, match="no CUDA device"):
        lpips.default_lpips_fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--model_path", "model", "--source_path", "scene"])
    from hidegs_tpu_torch.train import trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.main(["--source_path", "scene", "--model_path", "model"])
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


def test_float32_matmuls_stay_full_precision():
    """Importing the package turns TF32 off for matmuls and convolutions:
    the multi-view homographies and reprojections are float32 3x3 products
    whose rounding moves samples across the pixel-noise threshold."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


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


def test_the_scan_covers_the_preprocess_kernels():
    """The preprocess kernels' module is scanned for jax imports; its
    source sits beside the blend kernels', builds into build/kernels/ and
    uses no atomics."""
    from hidegs_tpu_torch import kernel_sources

    assert "hidegs_tpu_torch.raster.preprocess_autograd" in _modules()
    src = kernel_sources.SOURCES["preprocess"]
    assert src.parent == cuda_blend.CSRC and src.exists() and "atomicAdd" not in src.read_text()
    assert cuda_blend._lib_path(src).parent == cuda_blend.BUILD_DIR


def test_every_kernel_source_builds_together_and_the_adam_kernel_has_no_atomics():
    """Every source of kernel_sources.SOURCES exists and builds into
    build/kernels/, so the first launch of any kernel builds them all at
    once; the masked Adam's source sits under model/csrc and writes each
    float from one thread, with no atomics."""
    from hidegs_tpu_torch import kernel_sources
    from hidegs_tpu_torch.model import adam

    assert set(cuda_blend.SOURCES) < set(kernel_sources.SOURCES)
    for src in kernel_sources.SOURCES.values():
        assert src.exists() and cuda_blend._lib_path(src).parent == cuda_blend.BUILD_DIR
    src = kernel_sources.SOURCES["masked_adam"]
    assert src.parent == pathlib.Path(adam.__file__).parent / "csrc"
    assert not re.search(r"atomic\w*\s*\(", src.read_text())


def test_preprocess_on_cpu_tensors_takes_the_plain_path():
    """On CPU tensors preprocess_gaussians is the plain forward under
    autograd (no PreprocessFn node); the kernels' launchers refuse CPU
    tensors."""
    from hidegs_tpu_torch.raster import preprocess_autograd

    scene = tsyn.make_toy_gaussians(40, seed=1, device="cpu")
    cam = tsyn.ring_camera(0, height=32, width=32, device="cpu")
    means = scene.means3d.clone().requires_grad_(True)
    pre = tpp.preprocess_gaussians(means, *scene[1:], cam, screen_bounds=(32, 32))
    assert type(pre.conic.grad_fn).__name__ != "PreprocessFnBackward"
    n = 4
    f32 = torch.zeros((n, 3))
    with pytest.raises(ValueError, match="CUDA"):
        preprocess_autograd.launch_preprocess_fwd(f32, f32, torch.zeros((n, 4)), torch.zeros(n), f32, None,
                                                  torch.zeros(23), None, None, None, None, 0, 0, 0.1, 0.2, 0.0,
                                                  0.0, {})
    with pytest.raises(ValueError, match="CUDA"):
        preprocess_autograd.launch_preprocess_bwd(f32, f32, torch.zeros((n, 4)), torch.zeros(n), f32,
                                                  torch.zeros(23), None, torch.zeros(n, dtype=torch.bool), {}, 0,
                                                  0, 0.1, 0.2, {})
