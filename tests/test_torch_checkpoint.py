"""The port's checkpoints against the JAX package's: a checkpoint written by
either loads in the other, the port resumes bit for bit, and the
non-finite-row check scrubs and refuses as the JAX one does.

All comparisons are exact: the checkpoint holds the same float32, int32 and
bool leaves under the same keys in both packages.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidegs_tpu.data.synthetic import make_toy_gaussians as jtoy
from hidegs_tpu.model.gaussians import init_from_points as jinit
from hidegs_tpu.train import checkpoint as jckpt
from hidegs_tpu.train import loop as jl
from hidegs_tpu.utils.ply import load_gaussian_arrays as jload_ply
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.data import synthetic as tsyn
from hidegs_tpu_torch.model.gaussians import init_from_points
from hidegs_tpu_torch.raster.api import RasterConfig, render
from hidegs_tpu_torch.train import checkpoint as tckpt
from hidegs_tpu_torch.train import loop as tl
from hidegs_tpu_torch.utils.ply import load_gaussian_arrays

torch.set_num_threads(1)

FIELDS = ("xyz", "sh_dc", "sh_rest", "scaling", "rotation", "opacity")
STATE_FIELDS = ("alive", "grad_max", "grad_abs_max", "max_radii2d", "protected", "active_sh_degree",
                "spatial_lr_scale")


def _jax_state(seed=0, num_images=3, n=240):
    """A JAX TrainState whose every leaf is non-trivial: noise on the
    moments, per-row steps, stats and exposure, a few dead rows."""
    scene = jtoy(n, seed=seed)
    g = jinit(scene.means3d, jnp.full((n, 3), 0.5), capacity=n + 16, spatial_lr_scale=2.5)
    rng = np.random.default_rng(seed)

    def noise(x):
        return jnp.asarray(rng.normal(size=x.shape).astype(np.float32))

    alive = np.asarray(g.alive).copy()
    alive[[3, 7]] = False
    g = g._replace(alive=jnp.asarray(alive), grad_max=jnp.abs(noise(g.grad_max)),
                   grad_abs_max=jnp.abs(noise(g.grad_abs_max)), max_radii2d=jnp.abs(noise(g.max_radii2d)) * 9,
                   active_sh_degree=jnp.int32(2))
    ts = jl.init_train_state(g, num_images, seed=seed)
    opt = ts.opt._replace(m=jax.tree.map(noise, ts.opt.m), v=jax.tree.map(lambda x: jnp.abs(noise(x)), ts.opt.v),
                          step=jnp.asarray(rng.integers(0, 9, ts.opt.step.shape).astype(np.int32)))
    return ts._replace(opt=opt, exposure=ts.exposure + noise(ts.exposure) * 0.01, exposure_m=noise(ts.exposure_m),
                       exposure_v=jnp.abs(noise(ts.exposure_v)), step=jnp.int32(17))


def _from_jax(jts, device="cpu"):
    g = jts.gaussians
    return convert.train_state_from_jax(
        gaussians=dict(params={f: np.asarray(getattr(g.params, f)) for f in FIELDS},
                       **{f: np.asarray(getattr(g, f)) for f in STATE_FIELDS}),
        m={f: np.asarray(getattr(jts.opt.m, f)) for f in FIELDS},
        v={f: np.asarray(getattr(jts.opt.v, f)) for f in FIELDS},
        opt_step=np.asarray(jts.opt.step), exposure=np.asarray(jts.exposure),
        exposure_m=np.asarray(jts.exposure_m), exposure_v=np.asarray(jts.exposure_v), step=int(jts.step),
        device=device)


def _port_leaves(ts):
    return {k: v.numpy() for k, v in tckpt._flatten_with_paths(ts).items()}


def _jax_leaves(jts):
    leaves, _ = jckpt._flatten_with_paths(jts)
    return leaves


def test_port_leaf_keys_are_the_jax_keys():
    jts = _jax_state()
    assert list(_port_leaves(_from_jax(jts))) + ["rng"] == list(_jax_leaves(jts))


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """JAX save_train_state → the port's load_train_state equals
    convert.train_state_from_jax of the same state, leaf for leaf."""
    jts = _jax_state(seed=1)
    jckpt.save_train_state(jts, str(tmp_path), 7)
    want = _from_jax(jts)
    got, it = tckpt.load_train_state(_from_jax(_jax_state(seed=2)), str(tmp_path))
    assert it == 7
    for k, (a, b) in zip(_port_leaves(want), zip(_port_leaves(want).values(), _port_leaves(got).values())):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    # the generator is seeded from the JAX key (jax.random.PRNGKey(1) = [0, 1])
    assert got.generator.initial_seed() == 1


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port's save_train_state → the JAX load_train_state equals the
    JAX state the port's was converted from; point_cloud.ply, meta.json and
    exposure.json are the JAX writer's."""
    jts = _jax_state(seed=3)
    ts = _from_jax(jts)
    d = tckpt.save_train_state(ts, str(tmp_path / "port"), 5, extras={"note": "x"})
    back, it = jckpt.load_train_state(_jax_state(seed=4), str(tmp_path / "port"))
    assert it == 5
    want = _jax_leaves(jts)
    for k, v in _jax_leaves(back).items():
        if k == "rng":
            np.testing.assert_array_equal(v, np.array([0, 0], np.uint32))  # the generator's seed 0
            continue
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    jd = jckpt.save_train_state(jts, str(tmp_path / "jax"), 5, extras={"note": "x"})
    for f in ("meta.json", "exposure.json"):
        assert json.load(open(os.path.join(d, f))) == json.load(open(os.path.join(jd, f))), f
    a, b = load_gaussian_arrays(os.path.join(d, "point_cloud.ply")), jload_ply(os.path.join(jd, "point_cloud.ply"))
    assert a.keys() == b.keys() and a["xyz"].shape[0] == int(np.asarray(jts.gaussians.alive).sum())
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_find_latest_iteration(tmp_path):
    for it in (7, 300, 30):
        os.makedirs(tmp_path / f"iteration_{it}")
    os.makedirs(tmp_path / "iteration_x")
    assert tckpt.find_latest_iteration(str(tmp_path)) == jckpt.find_latest_iteration(str(tmp_path)) == 300
    assert tckpt.find_latest_iteration(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.load_train_state(_from_jax(_jax_state()), str(tmp_path / "none"))


@pytest.mark.parametrize("n_bad", [0, 1, 30])
def test_check_alive_finite_scrubs_and_refuses_as_jax(tmp_path, n_bad):
    """NaN/inf rows: up to 1% of the alive rows are scrubbed (marked dead)
    at save, more raise FloatingPointError, in both packages alike; dead
    rows never count."""
    jts = _jax_state(seed=5)
    g = jts.gaussians
    xyz = np.asarray(g.params.xyz).copy()
    scaling = np.asarray(g.params.scaling).copy()
    alive = np.asarray(g.alive)
    rows = [r for r in range(alive.shape[0]) if alive[r]][:n_bad]
    xyz[rows[::2], 1] = np.nan
    scaling[rows[1::2], 0] = np.inf
    xyz[3] = np.nan  # a dead row
    jg = g._replace(params=g.params._replace(xyz=jnp.asarray(xyz), scaling=jnp.asarray(scaling)))
    jts = jts._replace(gaussians=jg)
    ts = _from_jax(jts)
    n_alive = int(alive.sum())  # 238: 1% is 2.38 rows
    for max_bad in (0.01, 0.2):
        try:
            want = jckpt.check_alive_finite(jg, max_bad)
        except FloatingPointError as e:
            with pytest.raises(FloatingPointError, match="corrupt"):
                tckpt.check_alive_finite(ts.gaussians, max_bad)
            assert "corrupt" in str(e)
            continue
        n_alive, bad = tckpt.check_alive_finite(ts.gaussians, max_bad)
        assert n_alive == want[0]
        np.testing.assert_array_equal(bad.numpy(), want[1])
    if n_bad > 0.01 * n_alive:  # refused at the default 1%
        with pytest.raises(FloatingPointError):
            tckpt.save_train_state(ts, str(tmp_path), 1)
        return
    d = tckpt.save_train_state(ts, str(tmp_path), 1)
    meta = json.load(open(os.path.join(d, "meta.json")))
    assert meta["n_scrubbed_at_save"] == n_bad and meta["n_alive"] == n_alive - n_bad
    loaded, _ = tckpt.load_train_state(ts, str(tmp_path), 1)
    assert int(loaded.gaussians.alive.sum()) == n_alive - n_bad


def test_resume_is_bitexact(tmp_path):
    """K train steps against k steps, save, load into a fresh state, K - k
    more: every leaf bitwise equal (tests/test_golden.py's resume test for
    the port; the densify round at step 4 draws from the restored
    generator)."""
    rcfg = RasterConfig(max_instances=1 << 12)
    scene = tsyn.make_toy_gaussians(50, seed=1, device="cpu")
    cam = tsyn.ring_camera(0, height=32, width=32, device="cpu")
    src = tsyn.ring_camera(1, n_cams=16, height=32, width=32, device="cpu")
    cfg = tl.TrainConfig(iterations=100, raster=rcfg, freq_warmup=10_000, single_view_weight=0.0,
                         densify_from=1, densify_until=100, densify_interval=4, multi_view_from=0,
                         multi_view_sample_num=64)
    cfg = cfg.__class__(**{**cfg.__dict__, "densify": cfg.densify._replace(grad_threshold=0.0,
                                                                           clone_min_opacity=0.0)})
    with torch.no_grad():
        gt = render(*scene, cam, config=rcfg)["render"]
    # the multi-view part draws its pixel samples from the state's second
    # generator: a resume is bit-exact only if the checkpoint restores it
    from hidegs_tpu_torch.train.geometric import MultiViewBatch

    with torch.no_grad():
        src_gray = render(*scene, src, config=rcfg)["render"].mean(0)
    batch = tl.ViewBatch(cam=cam, image=gt, image_idx=torch.tensor(0),
                         multi_view=MultiViewBatch(src_image_gray=src_gray, src_cam=src))

    def fresh():
        state = init_from_points(scene.means3d, torch.full((50, 3), 0.5), capacity=128)
        return tl.init_train_state(state, num_images=1, seed=0)

    def run(ts, start, n):
        for it in range(start, start + n):
            ts, _ = tl.train_step(ts, batch, cfg)
            ts, _ = tl.maybe_host_side_schedule(ts, cfg, scene_extent=3.0, step=it + 1)
        return ts

    a = run(fresh(), 0, 6)
    b = run(fresh(), 0, 3)
    tckpt.save_train_state(b, str(tmp_path), 3)
    b2, it = tckpt.load_train_state(fresh(), str(tmp_path), 3)
    assert it == 3
    b3 = run(b2, 3, 3)
    la, lb = _port_leaves(a), _port_leaves(b3)
    for k in la:
        np.testing.assert_array_equal(lb[k], la[k], err_msg=k)
    assert torch.equal(a.generator.get_state(), b3.generator.get_state())
    assert torch.equal(a.mv_generator.get_state(), b3.mv_generator.get_state())
    assert not torch.equal(a.mv_generator.get_state(), fresh().mv_generator.get_state())
    assert int(a.step) == 6 and int(a.gaussians.alive.sum()) > 50  # the round grew the model
