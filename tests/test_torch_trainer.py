"""The port's scene trainer against the JAX package's: the config and
budget helpers, the initial state (skybox, scaffold), the view batch's
depth mask, a 3-iteration `train()` of both packages on one COLMAP scene,
the budget grow / shrink run, resuming a JAX checkpoint, and
`python -m hidegs_tpu_torch.train` with the multi-view terms on, whose
model directory both packages' evaluate read. The scene writers are in
tests/test_torch_scenes.py.

Tolerances: the helpers are exact; the initial state rtol 1e-6 (the KNN
scales of both packages are float32 sums in the same order); evaluate's
PSNR within 0.05 dB; the trained parameters as in tests/test_torch_train.py
(losses rtol 1e-3, the first step's gradients normalised atol 5e-3, the
parameters within 1e-2·lr where the gradient is signal).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hidegs_tpu import config as jconfig
from hidegs_tpu.data.scene import load_scene as jload_scene
from hidegs_tpu.train import trainer as jtrainer
from hidegs_tpu_torch import config as tconfig
from hidegs_tpu_torch.data import synthetic as tsyn
from hidegs_tpu_torch.data.scene import load_scene as tload_scene
from hidegs_tpu_torch.raster.api import RasterConfig
from hidegs_tpu_torch.train import budgets as tbudgets
from hidegs_tpu_torch.train import loop as tl
from hidegs_tpu_torch.train import trainer as ttrainer
from hidegs_tpu_torch.utils.ply import gaussian_properties, write_ply

torch.set_num_threads(1)

H = W = 48
N_VIEWS = 6
FIELDS = ("xyz", "sh_dc", "sh_rest", "scaling", "rotation", "opacity")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    """A toy scene's renders as a COLMAP dataset: six views 22.5° apart on a
    ring, so each has neighbours for the multi-view terms."""
    root = tmp_path_factory.mktemp("scene")
    scene = tsyn.make_toy_gaussians(120, seed=11, device="cpu")
    cams = [tsyn.ring_camera(i, n_cams=16, height=H, width=W, device="cpu") for i in range(N_VIEWS)]
    tsyn.write_synthetic_colmap_scene(str(root), scene, cams, RasterConfig(max_instances=1 << 13), point_stride=2)
    return str(root)


def _opt(cls, **kw):
    base = dict(iterations=3, densify_from_iter=1000, freq_warmup_iterations=0, single_view_weight_from_iter=0,
                multi_view_weight_from_iter=1000, multi_view_sample_num=256, depth_from_iter=10_000)
    base.update(kw)
    return cls(**base)


def test_train_config_from_opt_matches_jax():
    for kw in ({}, dict(multi_view_sample_num=50_000, multi_view_patch_size=5, iterations=77)):
        jopt, topt = jconfig.OptimizationConfig(**kw), tconfig.OptimizationConfig(**kw)
        for backend in ("jnp", "pallas"):
            jc = jtrainer.train_config_from_opt(jopt, jconfig.PipelineConfig(raster_backend=backend), 5000)
            tc = ttrainer.train_config_from_opt(topt, tconfig.PipelineConfig(raster_backend=backend), 5000)
            jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
            jr, tr = jd.pop("raster"), td.pop("raster")
            jd["densify"], td["densify"] = dict(jd["densify"]._asdict()), dict(td["densify"]._asdict())
            assert td == jd
            assert tr["backend"] == "blend" and tr["max_blocks"] == 0
            for key in ("max_instances", "antialias", "tile", "depth_sort_bits", "max_visible"):
                assert tr[key] == jr[key], key
    jc = jtrainer.train_config_from_opt(jopt, jconfig.PipelineConfig(max_instances=0), 5000)
    tc = ttrainer.train_config_from_opt(topt, tconfig.PipelineConfig(max_instances=0), 5000)
    assert tc.raster.max_instances == jc.raster.max_instances


def test_budget_helpers_match_jax(capsys):
    for n, cap in ((0, 1 << 20), (100, 512), (5000, 1 << 20), (1 << 20, 1 << 20), (700_000, 1 << 23)):
        assert ttrainer.fit_row_budget(n, cap) == jtrainer.fit_row_budget(n, cap)
    for peak, rows in ((0, 4_000_000), (100_000, 1_000_000), (100_000, 4_000_000), (3_000_000, 4_000_000)):
        assert tbudgets.fit_visible_budget(peak, rows) == jtrainer._fit_visible_budget(peak, rows)
    cases = [(1 << 20, 0, 0, 100_000, 0, 0), (1 << 20, 4096, 1000, 900_000, 800, 0),
             (1 << 20, 0, 3_000_000, 100_000, 0, 1_000_000), (1 << 16, 0, 0, 60_000, 0, 0)]
    for max_inst, max_blocks, max_visible, win_inst, win_blocks, win_vis in cases:
        jr = jtrainer.RasterConfig(backend="jnp", max_instances=max_inst, max_blocks=max_blocks,
                                   max_visible=max_visible)
        tr = RasterConfig(max_instances=max_inst, max_blocks=max_blocks, max_visible=max_visible)
        jc, js = jtrainer._maybe_shrink_budgets(jtrainer.TrainConfig(raster=jr), win_inst, win_blocks, 9,
                                                win_max_visible=win_vis, row_budget=4_000_000)
        jout = capsys.readouterr().out
        tr, ts = tbudgets.shrink_budgets(tr, win_inst, win_blocks, win_max_visible=win_vis, row_budget=4_000_000)
        assert capsys.readouterr().out == jout
        assert ts == js
        for key in ("max_instances", "max_blocks", "max_visible"):
            assert getattr(tr, key) == getattr(jc.raster, key), key


def _write_scaffold(source, tmp_path):
    """A neighbour model for the scaffold: rows around the scene and a
    skybox tail, center.txt / extent.txt in the scene directory."""
    rng = np.random.default_rng(3)
    n = 200
    model = tmp_path / "neighbour"
    model.mkdir()
    xyz = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    write_ply(str(model / "point_cloud.ply"), gaussian_properties(
        xyz, rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 15, 3)).astype(np.float32) * 0.1,
        rng.normal(size=n).astype(np.float32), rng.uniform(-4, -2, (n, 3)).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32)))
    (model / "pc_info.txt").write_text("4\n")
    np.savetxt(os.path.join(source, "center.txt"), np.array([0.5, -0.25, 0.0]))
    np.savetxt(os.path.join(source, "extent.txt"), np.array([3.0, 3.0, 1.0]))
    return str(model)


def test_init_gaussians_from_scene_matches_jax(colmap_scene, tmp_path):
    """The initial state with a skybox, and with a scaffold loaded through
    utils/storage.py, against JAX."""
    source = str(tmp_path / "scene")
    import shutil

    shutil.copytree(colmap_scene, source)
    jscene, tscene = jload_scene(source), tload_scene(source)
    for kw in (dict(skybox_num=16), dict(skybox_num=4, scaffold_file=_write_scaffold(source, tmp_path))):
        jm = jconfig.ModelConfig(source_path=source, **kw)
        tm = tconfig.ModelConfig(source_path=source, **kw)
        js = jtrainer.init_gaussians_from_scene(jscene, jm, 512)
        ts = ttrainer.init_gaussians_from_scene(tscene, tm, 512, device="cpu")
        assert int(ts.alive.sum()) == int(np.asarray(js.alive).sum()) >= 60 + kw["skybox_num"]
        for f in FIELDS:
            np.testing.assert_allclose(getattr(ts.params, f).numpy(), np.asarray(getattr(js.params, f)),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{kw} {f}")
        for f in ("alive", "protected"):
            assert np.array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f))), f
        assert float(ts.spatial_lr_scale) == pytest.approx(float(js.spatial_lr_scale), rel=1e-7)
        if "scaffold_file" in kw:
            raw = ttrainer.load_scene_scaffold(tm)
            jraw = jtrainer.load_scene_scaffold(jm)
            assert raw.keys() == jraw.keys() and all(np.array_equal(raw[k], jraw[k]) for k in raw)
            assert int(ts.protected.sum()) == kw["skybox_num"] + len(raw["xyz"])


def test_build_view_batch_builds_pixel_depth_mask():
    """tests/test_train.py:test_build_view_batch_builds_pixel_depth_mask on
    the port: the per-pixel mask is invdepth > 0 and the alpha mask; the
    view's tensors are copied to the device once."""
    import types

    invd = np.zeros((H, W), np.float32)  # top half: monodepth holes
    invd[H // 2:] = 0.5
    alpha = np.ones((H, W), np.float32)
    alpha[:, : W // 4] = 0.0
    cam = types.SimpleNamespace(
        info=types.SimpleNamespace(image_path="view_0.png"), width=W, height=H,
        cam_params=lambda device: tsyn.ring_camera(0, n_cams=4, height=H, width=W, device=device),
        image=np.zeros((3, H, W), np.float32), invdepth=invd, depth_reliable=True, alpha_mask=alpha,
        grayscale=lambda: np.zeros((H, W), np.float32),
    )
    cache = ttrainer.ViewCache("cpu")
    batch = ttrainer.build_view_batch(cache, cam, 0)
    dm = batch.depth_mask.numpy()
    assert dm[0, W // 2] == 0.0  # alpha-valid but no depth sample (top half)
    assert dm[H // 2, W // 2] == 1.0  # depth present + alpha valid
    assert dm[H // 2, 0] == 0.0  # depth present but alpha-masked
    assert batch.invdepth is not None and batch.alpha_mask is not None and batch.multi_view is None
    again = ttrainer.build_view_batch(cache, cam, 0, src_cam=cam)
    assert again.image is batch.image and again.image_idx is batch.image_idx
    assert again.multi_view.src_plane_depth is None and again.multi_view.src_image_gray.shape == (H, W)
    unreliable = types.SimpleNamespace(**{**vars(cam), "depth_reliable": False,
                                          "info": types.SimpleNamespace(image_path="view_1.png")})
    assert ttrainer.build_view_batch(cache, unreliable, 1).depth_mask is None


def _recorder(module, monkeypatch, to_host):
    """Wrap `module.train_step` to keep each step's new state and metrics."""
    runs = []
    original = module.train_step

    def step(*args, **kwargs):
        ts, metrics = original(*args, **kwargs)
        runs.append((to_host(ts), {k: np.asarray(v) for k, v in metrics.items()}))
        return ts, metrics

    monkeypatch.setattr(module, "train_step", step)
    return runs


def test_three_iteration_train_matches_jax(colmap_scene, monkeypatch):
    """train() of both packages on one scene with the same seed (the view
    order is Python's random.Random(seed) in both), the multi-view terms
    off: every step's losses, the first step's gradients and the final
    parameters."""
    jruns = _recorder(jtrainer, monkeypatch, lambda ts: jax.tree.map(np.asarray, ts))
    truns = _recorder(ttrainer, monkeypatch, lambda ts: ts)
    pipe = dict(raster_backend="jnp", max_instances=1 << 13, capacity=512)
    jtrainer.train(jconfig.ModelConfig(source_path=colmap_scene), jconfig.PipelineConfig(**pipe),
                   _opt(jconfig.OptimizationConfig), save_iterations=(), log_every=1000, seed=4)
    ttrainer.train(tconfig.ModelConfig(source_path=colmap_scene), tconfig.PipelineConfig(**pipe),
                   _opt(tconfig.OptimizationConfig), save_iterations=(), log_every=1000, seed=4, device="cpu")
    assert len(jruns) == len(truns) == 3
    lr = tl.TrainConfig().lr
    extent = float(truns[0][0].gaussians.spatial_lr_scale)
    leaf_lr = {"xyz": lr.position_lr_init * extent, "sh_dc": lr.feature_lr,
               "sh_rest": lr.feature_lr / lr.feature_rest_div, "scaling": lr.scaling_lr,
               "rotation": lr.rotation_lr, "opacity": lr.opacity_lr}
    for k, ((jts, jm), (tts, tm)) in enumerate(zip(jruns, truns)):
        for key in ("total", "photo", "freq", "single_view"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-3, err_msg=f"step {k} {key}")
        for key in ("overflow", "num_instances", "num_visible"):
            assert int(tm[key]) == int(jm[key]), (k, key)
    jts, tts = jruns[0][0], truns[0][0]
    for f in FIELDS:  # the first step's gradients, through Adam's m = 0.1·g
        want = np.asarray(getattr(jts.opt.m, f))
        np.testing.assert_allclose(getattr(tts.opt.m, f).numpy() / np.abs(want).max(), want / np.abs(want).max(),
                                   atol=5e-3, err_msg=f"step-1 grad {f}")
    jts, tts = jruns[-1][0], truns[-1][0]
    for f in FIELDS:
        got, want = getattr(tts.gaussians.params, f).numpy(), np.asarray(getattr(jts.gaussians.params, f))
        m_steps = [np.abs(np.asarray(getattr(run[0].opt.m, f))) for run in jruns]
        signal = np.all([m > 1e-1 * m.max() for m in m_steps], axis=0)
        still = np.all([m == 0 for m in m_steps], axis=0)
        assert signal.any() or still.all(), f  # sh_rest has no gradient at SH degree 0
        np.testing.assert_allclose(got[signal], want[signal], rtol=0, atol=1e-2 * leaf_lr[f], err_msg=f)
        assert np.array_equal(got[still], want[still]), f"{f} moved without gradient"


def test_budget_grow_then_shrink(colmap_scene, tmp_path, monkeypatch, capsys):
    """tests/test_e2e.py:test_budget_grow_then_shrink on the port: budgets
    grow on overflow and re-fit downward after a clean window."""
    monkeypatch.setattr(tbudgets, "SHRINK_WINDOW", 3)
    model_cfg = tconfig.ModelConfig(source_path=colmap_scene, model_path=str(tmp_path / "m"))
    opt_cfg = _opt(tconfig.OptimizationConfig, iterations=10, freq_warmup_iterations=1000,
                   single_view_weight_from_iter=1000)
    pipe_big = tconfig.PipelineConfig(raster_backend="jnp", max_instances=1 << 15, capacity=256)
    ttrainer.train(model_cfg, pipe_big, opt_cfg, save_iterations=(), log_every=1000, device="cpu")
    out = capsys.readouterr().out
    assert "shrinking max_instances" in out
    assert "budget trajectory" in out
    pipe_small = tconfig.PipelineConfig(raster_backend="jnp", max_instances=64, capacity=256)
    ttrainer.train(dataclasses.replace(model_cfg, model_path=str(tmp_path / "m2")), pipe_small, opt_cfg,
                   save_iterations=(), log_every=1000, device="cpu")
    out = capsys.readouterr().out
    assert "growing max_instances" in out
    assert "instances and 0 kernel blocks were dropped" in out


def test_port_resumes_a_jax_checkpoint(colmap_scene, tmp_path, capsys):
    """A JAX run saves iteration 2; the port's trainer on the same model
    directory resumes from it and trains to iteration 4."""
    model = str(tmp_path / "model")
    pipe = dict(raster_backend="jnp", max_instances=1 << 13, capacity=512)
    jtrainer.train(jconfig.ModelConfig(source_path=colmap_scene, model_path=model), jconfig.PipelineConfig(**pipe),
                   _opt(jconfig.OptimizationConfig, iterations=2), save_iterations=(2,), log_every=1000)
    capsys.readouterr()
    ts = ttrainer.train(tconfig.ModelConfig(source_path=colmap_scene, model_path=model),
                        tconfig.PipelineConfig(**pipe), _opt(tconfig.OptimizationConfig, iterations=4),
                        save_iterations=(4,), log_every=2, device="cpu")
    out = capsys.readouterr().out
    assert "resumed from iteration 2" in out and "[4/4] loss=" in out
    assert int(ts.step) == 4
    # the JAX checkpoint carries no generator states: both are seeded from its key
    with np.load(os.path.join(model, "point_cloud", "iteration_2", "state.npz")) as data:
        key = data["rng"].astype(np.uint64)
    assert ts.generator.initial_seed() == int((key[0] << np.uint64(32)) | key[1]) > 0
    assert os.path.exists(os.path.join(model, "point_cloud", "iteration_4", "state.npz"))


def test_python_m_train_with_multi_view_then_both_evaluates(colmap_scene, tmp_path):
    """`python -m hidegs_tpu_torch.train` on the CPU with the multi-view
    terms (differentiable source) on from iteration 2, a densify round and
    a debug panel; then the port's and the JAX package's evaluate read the
    model directory and agree."""
    model = str(tmp_path / "model")
    args = ["--source_path", colmap_scene, "--model_path", model, "--iterations", "6", "--device", "cpu",
            "--freq_warmup_iterations", "0", "--single_view_weight_from_iter", "0",
            "--multi_view_weight_from_iter", "2", "--multi_view_sample_num", "256", "--densify_from_iter", "1",
            "--densify_until_iter", "5", "--densification_interval", "5", "--save_iterations", "6",
            "--capacity", "512", "--max_instances", "8192", "--debug_panel_every", "3", "--eval"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, torch; torch.set_num_threads(1); from hidegs_tpu_torch.train import trainer; "
            "from hidegs_tpu_torch.train import loop; seen = []; step = trainer.train_step\n"
            "def spy(ts, batch, *a, **k):\n"
            "    out = step(ts, batch, *a, **k); seen.append((batch.multi_view is not None, float(out[1]['total'])))\n"
            "    return out\n"
            "trainer.train_step = spy; import runpy; sys.argv = ['train'] + sys.argv[1:]\n"
            "runpy.run_module('hidegs_tpu_torch.train', run_name='__main__')\n"
            "import json; print('STEPS', json.dumps(seen))\n")
    proc = subprocess.run([sys.executable, "-c", code] + args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    steps = json.loads(proc.stdout.split("STEPS", 1)[1])
    assert [mv for mv, _ in steps] == [False] + [True] * 5
    assert all(np.isfinite(loss) for _, loss in steps)
    assert "densify@5" in proc.stdout
    assert os.listdir(os.path.join(model, "freq_debug"))
    assert json.load(open(os.path.join(model, "multi_view.json")))
    from hidegs_tpu.evaluate import main as jeval
    from hidegs_tpu_torch.evaluate import main as teval

    base = ["--model_path", model, "--source_path", colmap_scene, "--no_images", "--eval"]
    tr = teval(base + ["--device", "cpu"])
    jr = jeval(base)
    for split in ("train", "test"):
        assert tr[split]["mean"]["psnr"] > 10
        assert tr[split]["mean"]["psnr"] == pytest.approx(jr[split]["mean"]["psnr"], abs=0.05)
        assert tr[split]["mean"]["ssim"] == pytest.approx(jr[split]["mean"]["ssim"], abs=1e-3)
