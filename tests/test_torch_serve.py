"""The port's serving entry points against the JAX package's: LPIPS,
`evaluate.main` and `render_cli.main` on one model directory.

The model directory is what a JAX training run leaves: `cfg_args.json`
(raster_backend "jnp") and `point_cloud/iteration_N/point_cloud.ply`, here
a toy scene through the inverse activations with seeded noise, beside a
COLMAP scene the JAX writer rendered from the noise-free model. The port
runs on the CPU (`--device cpu`), where its "blend" backend is the plain
blend. Tolerances, and why:
  * LPIPS on the same weights (carried across with
    convert.lpips_params_from_jax, or one .npz both packages load): 1e-5
    (the VGG16 trunk's float32 convolutions sum in another order);
  * per-view PSNR 1e-3 dB, SSIM 1e-5: the renders agree at the blend
    tolerance (atol 3e-4 / rtol 1e-3);
  * the PNGs: within 1 level of 255 on at most 0.5% of pixels (8-bit
    rounding of renders that agree at that tolerance).
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hidegs_tpu import config as jconfig
from hidegs_tpu import evaluate as jevaluate
from hidegs_tpu import render_cli as jrender_cli
from hidegs_tpu.data.synthetic import make_toy_gaussians as jtoy
from hidegs_tpu.data.synthetic import ring_camera as jring_camera
from hidegs_tpu.data.synthetic import write_synthetic_colmap_scene as jwrite_scene
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu.train import lpips as jlpips
from hidegs_tpu.utils.ply import gaussian_properties, write_ply
from hidegs_tpu_torch import config as tconfig
from hidegs_tpu_torch import convert
from hidegs_tpu_torch import evaluate as tevaluate
from hidegs_tpu_torch import render_cli as trender_cli
from hidegs_tpu_torch.train import lpips as tlpips
from hidegs_tpu_torch.utils import png

torch.set_num_threads(1)

H, W, N_VIEWS, ITER = 48, 64, 3, 30_000
LPIPS_TOL = 1e-5


def _images(seed):
    rng = np.random.default_rng(seed)
    a = rng.random((3, H, W)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_lpips_matches_jax_on_carried_weights():
    """The JAX package's random-vgg weights (jax.random.PRNGKey(0)) carried
    across: the same distance within 1e-5."""
    jparams = jlpips.random_lpips_params(jax.random.PRNGKey(0))
    params = convert.lpips_params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    jfn = jax.jit(lambda a, b: jlpips.lpips_distance(jparams, a, b))
    for seed in (0, 1):
        a, b = _images(seed)
        want = float(jfn(jnp.asarray(a), jnp.asarray(b)))
        got = float(tlpips.lpips_distance(params, torch.tensor(a), torch.tensor(b)))
        assert abs(got - want) <= LPIPS_TOL, (got, want)
        assert want > 0
    with pytest.raises(KeyError, match="lin4_w"):
        convert.lpips_params_from_jax({k: np.asarray(v) for k, v in jparams.items() if k != "lin4_w"}, "cpu")


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """Converted-weight file both packages load: seeded numpy weights of
    the VGG16 layout with non-uniform heads."""
    rng = np.random.default_rng(7)
    arrays, in_ch, i = {}, 3, 0
    for ch, n in jlpips.VGG16_BLOCKS:
        for _ in range(n):
            arrays[f"conv{i}_w"] = (rng.normal(size=(ch, in_ch, 3, 3)) * 0.3 / np.sqrt(in_ch * 9)).astype(np.float32)
            arrays[f"conv{i}_b"] = (rng.normal(size=(ch,)) * 0.01).astype(np.float32)
            in_ch, i = ch, i + 1
    for j, (ch, _) in enumerate(jlpips.VGG16_BLOCKS):
        arrays[f"lin{j}_w"] = rng.random((1, ch, 1, 1)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz")
    np.savez(path, **arrays)
    return path


def test_lpips_npz_loads_in_both_packages(lpips_npz):
    jfn = jlpips.load_lpips(lpips_npz)
    tfn, kind = tlpips.default_lpips_fn(lpips_npz, device="cpu")
    assert kind == "calibrated-vgg"
    a, b = _images(2)
    want, got = float(jfn(jnp.asarray(a), jnp.asarray(b))), float(tfn(torch.tensor(a), torch.tensor(b)))
    assert abs(got - want) <= LPIPS_TOL and want > 0, (got, want)
    assert float(tfn(torch.tensor(a), torch.tensor(a))) == 0.0


def test_random_vgg_is_seeded_and_labelled():
    """The fallback draws from numpy's default_rng(0) (not the JAX key's
    draws, ROADMAP C6): the same weights every run, labelled random-vgg."""
    fn, kind = tlpips.default_lpips_fn("", device="cpu")
    assert kind == "random-vgg"
    a, b = _images(3)
    d = float(fn(torch.tensor(a), torch.tensor(b)))
    assert d > 0 and np.isfinite(d)
    p0, p1 = tlpips.random_lpips_params(0, "cpu"), tlpips.random_lpips_params(0, "cpu")
    assert p0.keys() == p1.keys() and all(torch.equal(p0[k], p1[k]) for k in p0)
    assert float(tlpips.default_lpips_fn("", device="cpu")[0](torch.tensor(a), torch.tensor(b))) == d


def test_lpips_constants_are_built_once_per_device():
    """LPIPS's scaling-layer constants are copied to a device once, not per
    call (a copy per served view would make the host wait)."""
    tlpips._scaling_layer.cache_clear()
    params = tlpips.random_lpips_params(0, "cpu")
    a, b = (torch.tensor(x) for x in _images(4))
    for _ in range(3):
        tlpips.lpips_distance(params, a, b)
    info = tlpips._scaling_layer.cache_info()
    assert (info.misses, info.hits) == (1, 2)
    shift, scale = tlpips._scaling_layer(torch.device("cpu"))
    assert shift.shape == (3, 1, 1) and np.array_equal(scale[:, 0, 0].numpy(), tlpips.SCALE)
    assert np.array_equal(shift[:, 0, 0].numpy(), tlpips.SHIFT)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A COLMAP scene (JAX writer) and a model directory as a JAX training
    run leaves it: the ply of a noisy copy of the scene and cfg_args.json."""
    root = tmp_path_factory.mktemp("serve")
    scene = jtoy(300, seed=9)
    cams = [jring_camera(i, n_cams=N_VIEWS, height=H, width=W) for i in range(N_VIEWS)]
    source = str(root / "scene")
    jwrite_scene(source, scene, cams, render_config=JConfig(backend="jnp", max_instances=1 << 14))
    rng = np.random.default_rng(1)
    n = scene.means3d.shape[0]
    xyz = np.asarray(scene.means3d) + rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    op = np.clip(np.asarray(scene.opacities), 1e-4, 1 - 1e-4)
    shs = np.asarray(scene.shs)
    props = gaussian_properties(xyz, shs[:, 0] + rng.normal(0, 0.05, (n, 3)), shs[:, 1:], np.log(op / (1 - op)),
                                np.log(np.asarray(scene.scales)), np.asarray(scene.quats))
    model = root / "model"
    os.makedirs(model / "point_cloud" / f"iteration_{ITER}")
    write_ply(str(model / "point_cloud" / f"iteration_{ITER}" / "point_cloud.ply"), props)
    jconfig.save_cfg_args(str(model), jconfig.ModelConfig(source_path=source, eval=True),
                          jconfig.PipelineConfig(raster_backend="jnp", tile=16, max_instances=1 << 14),
                          jconfig.OptimizationConfig())
    return dict(root=root, source=source, model=str(model))


def _copy(model_dir, name):
    dst = os.path.join(model_dir["root"], name)
    if not os.path.exists(dst):
        shutil.copytree(model_dir["model"], dst)
    return dst


def _assert_pngs_close(got_path, want_path):
    want = np.asarray(Image.open(want_path)).astype(int)
    got = png.read_image(got_path).astype(int)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3, (got_path, diff.max(), (diff > 0).mean())


def test_evaluate_matches_jax(model_dir, lpips_npz):
    """Both packages' evaluate.main on copies of one model directory, with
    the same converted LPIPS weights: per-view PSNR / SSIM / LPIPS, the
    report's keys, and the saved PNGs."""
    jdir, tdir = _copy(model_dir, "model_jax"), _copy(model_dir, "model_port")
    args = ["--source_path", model_dir["source"], "--resolution", "1", "--lpips_weights", lpips_npz]
    want = jevaluate.main(["--model_path", jdir] + args)
    got = tevaluate.main(["--model_path", tdir, "--source_path", model_dir["source"], "--resolution", "1", "--lpips_weights", lpips_npz,
                          "--device", "cpu"])
    assert got.keys() == want.keys() == {"lpips_kind", "train", "test"}
    assert got["lpips_kind"] == want["lpips_kind"] == "calibrated-vgg"
    saved = json.load(open(os.path.join(tdir, f"eval_{ITER}", "results.json")))
    assert saved == json.loads(json.dumps(got))
    for split in ("train", "test"):
        assert got[split].keys() == want[split].keys()
        assert len(got[split]["per_view"]) == len(want[split]["per_view"]) == {"train": 2, "test": 1}[split]
        for g, w in zip(got[split]["per_view"], want[split]["per_view"]):
            assert g.keys() == w.keys() and g["name"] == w["name"]
            assert abs(g["psnr"] - w["psnr"]) <= 1e-3, (g, w)
            assert abs(g["ssim"] - w["ssim"]) <= 1e-5, (g, w)
            assert abs(g["lpips"] - w["lpips"]) <= LPIPS_TOL, (g, w)
            assert 15.0 < w["psnr"] < 60.0  # the noisy model: a real, imperfect render
        for i in range(len(want[split]["per_view"])):
            for kind in ("renders", "gt"):
                rel = os.path.join(f"eval_{ITER}", split, kind, f"{i:05d}.png")
                _assert_pngs_close(os.path.join(tdir, rel), os.path.join(jdir, rel))


def test_render_cli_matches_jax(model_dir):
    out_j, out_t = os.path.join(model_dir["root"], "renders_jax"), os.path.join(model_dir["root"], "renders_port")
    args = ["--model_path", model_dir["model"], "--source_path", model_dir["source"], "--resolution", "1",
            "--max_instances", str(1 << 14)]
    jrender_cli.main(args + ["--output_path", out_j])
    trender_cli.main(args + ["--output_path", out_t, "--device", "cpu"])
    names = sorted(os.listdir(out_j))
    assert names == sorted(os.listdir(out_t)) == [f"{i:05d}.png" for i in range(N_VIEWS)]
    for name in names:
        _assert_pngs_close(os.path.join(out_t, name), os.path.join(out_j, name))


def test_render_cli_refuses_the_hierarchy(model_dir, tmp_path):
    """With --hierarchy, render_cli renders that .hier file and not the
    model's PLY (tests/test_torch_hier.py holds its PNGs against the JAX
    package's), so a .hier file it cannot read is refused."""
    with pytest.raises(FileNotFoundError):
        trender_cli.main(["--model_path", model_dir["model"], "--source_path", model_dir["source"], "--hierarchy",
                          str(tmp_path / "missing.hier"), "--output_path", str(tmp_path), "--device", "cpu"])
    assert not any(tmp_path.glob("*.png"))


def test_config_reads_jax_snapshots(model_dir):
    """A cfg_args.json written by the JAX package reads the same in the
    port, and its raster_backend maps to the port's backends."""
    jm, jp, jo = jconfig.get_combined_args(model_dir["model"])
    tm, tp, to = tconfig.get_combined_args(model_dir["model"])
    import dataclasses

    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert dataclasses.asdict(to) == dataclasses.asdict(jo)
    assert [tconfig.port_backend(b) for b in ("jnp", "pallas", "oracle")] == ["blend", "blend", "oracle"]
    with pytest.raises(ValueError, match="raster_backend"):
        tconfig.port_backend("blend")
