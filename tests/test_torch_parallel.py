"""The port's view-parallel step in one process: parity with the JAX
package's `make_dp_train_step` on a 4-device mesh, the one-view step equal
to `train_step`, the visibility union, the camera bands, the mesh and the
render's `pre_constraint` hook.

The JAX steps run once per module on a (4, 1) mesh of the suite's virtual
CPU devices (the `jnp` backend, tests/test_parallel.py's 60-gaussian
problem at 32x32, every loss term on from step 0), K=3 steps on the
float32 and on the bf16 gradient wire; the port's step runs the same four
views in one process (mesh None: no collective), and in a one-rank gloo
group, which must give the same state to the bit. The problem and the
tolerances (tests/test_torch_train.py's) are in tests/torch_dp_problem.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidegs_tpu.data.synthetic import make_toy_gaussians as jtoy
from hidegs_tpu.data.synthetic import ring_camera as jring_camera
from hidegs_tpu.parallel import bands as jbands
from hidegs_tpu.parallel.mesh import make_mesh as jmake_mesh
from hidegs_tpu.parallel.sharded import make_dp_train_step as jmake_dp
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu.raster.api import render as jrender
from hidegs_tpu.train import geometric as jgeo
from hidegs_tpu.train import loop as jl
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.parallel import bands, distributed as pdist, mesh as pmesh, sharded
from hidegs_tpu_torch.parallel.dryrun import file_init_method
from hidegs_tpu_torch.raster.api import RasterConfig, render
from hidegs_tpu_torch.train import loop as tl
from hidegs_tpu_torch.train.geometric import MultiViewBatch, sample_pixels
from torch_dp_problem import H, JCFG, K, TCFG, V, W, check_against_jax, jax_dp_runs, make_problem, tstate

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    return make_problem()


@pytest.fixture(scope="module")
def jax_runs(problem):
    """K steps of JAX's DP step, numpy copies of each step's state and
    metrics (the step donates): float32 on a (4, 1) mesh; the bf16 wire on
    a (1, 1) mesh, where, as in the port's one process, the four views'
    gradients are summed in float32 and cross the wire rounded once (on
    four devices each view's gradient is rounded before the sum:
    tests/test_torch_distributed.py holds that against four ranks)."""
    return {None: jax_dp_runs(problem, V, 1, None), "bf16": jax_dp_runs(problem, 1, 1, jnp.bfloat16)}


@pytest.fixture(scope="module")
def port_runs(problem):
    out = {}
    for wire in (None, torch.bfloat16):
        step, _ = sharded.make_dp_train_step(TCFG, None, grad_reduce_dtype=wire)
        ts, steps = tstate(problem), []
        for _ in range(K):
            ts, m = step(ts, problem["tbatch"])
            steps.append((ts, {k: float(v) for k, v in m.items()}))
        out[wire] = steps
    return out


@pytest.mark.parametrize("wire", [None, "bf16"])
def test_dp_steps_match_jax(problem, jax_runs, port_runs, wire):
    """K=3 steps over four views against JAX's DP step (`jax_runs`)."""
    tsteps = port_runs[None if wire is None else torch.bfloat16]
    check_against_jax(problem["state"], jax_runs[wire], tsteps[0][0], tsteps[-1][0], [m for _, m in tsteps])


def test_bf16_wire_tracks_float32(problem, port_runs):
    """tests/test_parallel.py:test_dp_bf16_grad_reduction_matches_f32 on the
    port: the first step's loss within rtol 1e-4 and its update in the same
    direction (cosine > 0.99)."""
    a, ma = port_runs[None][0]
    b, mb = port_runs[torch.bfloat16][0]
    np.testing.assert_allclose(mb["loss"], ma["loss"], rtol=1e-4)
    xyz0 = problem["state"]["params"]["xyz"]
    da, db = a.gaussians.params.xyz.numpy() - xyz0, b.gaussians.params.xyz.numpy() - xyz0
    moved = (np.abs(da).max(-1) > 0) | (np.abs(db).max(-1) > 0)
    cos = (da[moved] * db[moved]).sum() / (np.linalg.norm(da[moved]) * np.linalg.norm(db[moved]) + 1e-12)
    assert cos > 0.99, cos
    # the first Adam step is lr·sign(g) in both: the rounding shows in m
    assert not torch.equal(a.opt.m.xyz, b.opt.m.xyz), "the bf16 wire changed nothing"


def _leaves(ts):
    g = ts.gaussians
    return (list(g.params) + list(ts.opt.m) + list(ts.opt.v)
            + [ts.opt.step, g.grad_max, g.grad_abs_max, g.max_radii2d, ts.exposure, ts.exposure_m, ts.step])


@pytest.mark.parametrize("wire", [None, torch.bfloat16])
def test_one_rank_group_is_bitwise_the_step_without_group(problem, port_runs, tmp_path, wire):
    """The step on a (1, 1) mesh of a one-rank gloo group: its collectives
    (the flat SUM, the MAX of the stats, the state's broadcast) change
    nothing, to the bit."""
    pdist.initialize_distributed(backend="gloo", device="cpu", init_method=file_init_method(tmp_path),
                                 world_size=1, rank=0)
    try:
        mesh = pmesh.make_mesh(1, data=1, model=1, device_type="cpu")
        step, place = sharded.make_dp_train_step(TCFG, mesh, grad_reduce_dtype=wire)
        ts, batch = place(tstate(problem), problem["tbatch"])
        for k in range(K):
            ts, m = step(ts, batch)
            want, wm = port_runs[wire][k]
            assert all(torch.equal(x, y) for x, y in zip(_leaves(ts), _leaves(want))), f"step {k}"
            assert {key: float(v) for key, v in m.items()} == wm
    finally:
        pdist.shutdown_distributed()


def test_one_view_step_is_train_step(problem):
    """V=1: the DP step is `train_step` on a finite step, to the bit, with
    and without the exposure, and with a multi-view part whose samples are
    injected (`uv`) or drawn from the state's generator."""
    ts = tstate(problem)
    view = sharded.unstack_view_batch(problem["tbatch"])[1]
    for use_exposure in (False, True):
        step, _ = sharded.make_dp_train_step(TCFG, None, use_exposure=use_exposure)
        a, ma = tl.train_step(ts, view, TCFG, use_exposure=use_exposure)
        b, mb = step(ts, sharded.stack_view_batches([view]))
        assert float(ma["step_ok"]) == 1.0
        assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b))), use_exposure
        assert float(ma["total"]) == float(mb["loss"]) == float(mb["total"])
    mv_view = view._replace(multi_view=MultiViewBatch(src_image_gray=problem["tbatch"].image[2].mean(0),
                                                      src_cam=sharded.unstack_view_batch(problem["tbatch"])[2].cam))
    cfg = dataclasses.replace(TCFG, multi_view_from=0, multi_view_sample_num=256)
    step, _ = sharded.make_dp_train_step(cfg, None)
    a, ma = tl.train_step(ts, mv_view, cfg)  # draws from a copy of ts.mv_generator
    b, mb = step(ts, sharded.stack_view_batches([mv_view]))
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert torch.equal(a.mv_generator.get_state(), b.mv_generator.get_state())
    assert float(mb["mv_ncc"]) == float(ma["mv_ncc"]) and float(mb["mv_geo"]) == float(ma["mv_geo"])
    uv = sample_pixels(torch.Generator().manual_seed(5), 256, H, W)
    a, _ = tl.train_step(ts, mv_view, cfg, uv=uv)
    b, _ = step(ts, sharded.stack_view_batches([mv_view]), uv=uv[None])
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def test_the_step_refuses_a_state_split_otherwise(problem):
    """The placement is decided once, by `make_dp_train_step`: a state
    whose rows are split over two model ranks (`shard_rows` records it)
    raises ValueError in a step that keeps the rows whole, and the
    gathered state steps again."""
    ts = tstate(problem)
    step, place = sharded.make_dp_train_step(TCFG, None, shard_gaussians=True)  # one rank: nothing to split
    placed, batch = place(ts, problem["tbatch"])
    assert placed.rows_split == 1
    with pytest.raises(ValueError, match="split over 2 model ranks"):
        step(ts._replace(rows_split=2), batch)
    new, m = step(placed, batch)
    assert new.rows_split == 1 and np.isfinite(float(m["loss"]))


def test_rows_visible_in_no_view_stay_frozen(problem):
    """tests/test_parallel.py:test_dp_visibility_union_semantics: a row no
    view sees keeps its parameters, moments and Adam step to the bit; the
    rows some view sees moved."""
    ts = tstate(problem)
    g = ts.gaussians
    # five live rows and the dead padding far above every camera's frustum
    xyz = g.params.xyz.clone()
    xyz[:5, 1] = xyz[-4:, 1] = -100.0
    g = g._replace(params=g.params._replace(xyz=xyz))
    ts = ts._replace(gaussians=g)
    union = torch.zeros(g.capacity, dtype=torch.bool)
    for view in sharded.unstack_view_batch(problem["tbatch"]):
        union |= render(g.params.xyz, g.scales, g.quats, g.opacities, g.shs, view.cam,
                        config=TCFG.raster)["visibility"]
    assert not bool(union[:5].any()) and not bool(union[-4:].any()) and int(union.sum()) > 40
    step, _ = sharded.make_dp_train_step(TCFG, None)
    new, _ = step(ts, problem["tbatch"])
    for old_leaf, new_leaf in zip(_leaves(ts)[:19], _leaves(new)[:19]):
        assert torch.equal(new_leaf[~union], old_leaf[~union])
    assert bool((new.gaussians.params.xyz[union] != g.params.xyz[union]).any(dim=1).all())


def test_camera_bands_match_jax_and_assemble_the_full_frame(problem):
    """tests/test_parallel.py:test_camera_band_split_matches_full_render on
    the port: the four band cameras equal JAX's, and their renders
    concatenate to the full frame at the JAX test's tolerance."""
    jscene = jtoy(200, seed=3)
    jcam = jring_camera(0, height=64, width=64)
    tcam = convert.camera_from_jax(*(np.asarray(x) for x in (jcam.R, jcam.t, jcam.fx, jcam.fy, jcam.cx, jcam.cy)),
                                   64, 64, device="cpu")
    for jb, tb in zip(jbands.split_camera_bands(jcam, 4), bands.split_camera_bands(tcam, 4)):
        assert (tb.height, tb.width, tb.frustum_height, tb.frustum_width) == (
            jb.height, jb.width, jb.frustum_height, jb.frustum_width)
        for f in ("R", "t", "fx", "fy", "cx", "cy"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)
    scene = [torch.tensor(np.asarray(x)) for x in jscene]
    cfg = RasterConfig(max_instances=1 << 14)
    with torch.no_grad():
        full = render(*scene, tcam, config=cfg)["render"]
        imgs = [render(*scene, b, config=cfg)["render"] for b in bands.split_camera_bands(tcam, 4)]
    np.testing.assert_allclose(bands.assemble_bands(imgs).numpy(), full.numpy(), atol=2e-4, rtol=1e-3)
    jfull = jrender(*jscene, jcam, config=JConfig(backend="jnp", max_instances=1 << 14))["render"]
    np.testing.assert_allclose(bands.assemble_bands(imgs).numpy(), np.asarray(jfull), atol=3e-4, rtol=1e-3)
    with pytest.raises(ValueError, match="divisible"):
        bands.split_camera_bands(tcam, 3)


def test_make_mesh_checks_its_shape(tmp_path):
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh(1, device_type="cpu")
    pdist.initialize_distributed(backend="gloo", device="cpu", init_method=file_init_method(tmp_path),
                                 world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
            pmesh.make_mesh(1, data=2, model=1, device_type="cpu")
        mesh = pmesh.make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        from torch.distributed.tensor import Replicate, Shard

        assert pmesh.replicated(mesh) == (Replicate(), Replicate())
        assert pmesh.view_sharded(mesh) == (Shard(0), Replicate())
        assert pmesh.gaussian_sharded(mesh) == (Replicate(), Shard(0))
        grp = sharded.mesh_groups(mesh)
        assert (grp.n_data, grp.n_model, grp.data_index, grp.model_index) == (1, 1, 0, 0)
    finally:
        pdist.shutdown_distributed()
    assert pdist.initialize_distributed(backend="gloo", device="cpu", world_size=1) is False


def test_pre_constraint_hook_leaves_the_render_as_it_was(problem):
    """`RasterConfig.pre_constraint`: None is the render as it was; the
    sharded step's gather over a group of one (`gather_preprocessed`) gives
    the same outputs and gradients to the bit."""
    g = tstate(problem).gaussians
    cam = sharded.unstack_view_batch(problem["tbatch"])[0].cam
    seen = []

    def identity(pre):
        seen.append(pre.mean2d.shape[0])
        return sharded.gather_preprocessed(pre, None, 1, 0)

    outs = []
    for cfg in (RasterConfig(max_instances=1 << 12), RasterConfig(max_instances=1 << 12, pre_constraint=identity)):
        leaves = [x.detach().clone().requires_grad_(True) for x in (g.params.xyz, g.scales, g.quats, g.opacities)]
        out = render(*leaves, g.shs, cam, render_geo=True, config=cfg)
        loss = sum((out[k] ** 2).sum() for k in ("render", "alpha", "rendered_normal", "invdepth"))
        outs.append(({k: v for k, v in out.items()}, torch.autograd.grad(loss, leaves)))
    (a, ga), (b, gb) = outs
    assert seen == [g.capacity]
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


def test_multi_view_dp_steps_match_jax_with_its_draws(problem):
    """Two views a step, each with a multi-view part whose source is the
    other view (rendered inside the loss, both views' geometry takes the
    gradient), on JAX's (2, 1) device mesh and in the port's one process:
    JAX splits each step's key into one key per view and draws each view's
    pixels from it (C26); those draws go to the port as `uv`
    (`convert.pixel_samples_from_jax`). Two steps at
    tests/test_torch_train.py's tolerances, the multi-view terms too."""
    n_views, k_steps, n_samples = 2, 2, 256
    jb = problem["jbatch"]
    take = lambda x: x[:n_views]  # noqa: E731
    jsrc = jax.tree.map(lambda x: x[jnp.array([1, 0])], jb)
    jmv = jgeo.MultiViewBatch(src_image_gray=jnp.mean(jsrc.image, axis=1), src_cam=jsrc.cam)
    jbatch = jax.tree.map(take, jb._replace(multi_view=jmv))
    jcfg = dataclasses.replace(JCFG, multi_view_from=0, multi_view_sample_num=n_samples)
    step, place = jmake_dp(jcfg, jmake_mesh(n_views, data=n_views, model=1))
    jts, jbatch = place(jl.init_train_state(jax.tree.map(jnp.copy, problem["jstate"]), num_images=V), jbatch)
    jsteps, uvs = [], []
    for _ in range(k_steps):
        _, sub = jax.random.split(jts.rng)
        draws = []
        for key in jax.random.split(sub, n_views):  # multi_view_losses' draw: k1 of split(key)
            k1, _ = jax.random.split(key)
            draws.append(np.asarray(jax.random.uniform(k1, (n_samples, 2), minval=jnp.array([2.0, 2.0]),
                                                       maxval=jnp.array([W - 2.0, H - 2.0]))))
        uvs.append(convert.pixel_samples_from_jax(draws, device="cpu"))
        jts, m = step(jts, jbatch)
        jsteps.append((jax.tree.map(np.asarray, jts), {k: float(v) for k, v in m.items()}))

    views = sharded.unstack_view_batch(problem["tbatch"])
    tbatch = sharded.stack_view_batches(
        [views[i]._replace(multi_view=MultiViewBatch(src_image_gray=views[1 - i].image.mean(0),
                                                     src_cam=views[1 - i].cam)) for i in range(n_views)])
    tcfg = dataclasses.replace(TCFG, multi_view_from=0, multi_view_sample_num=n_samples)
    tstep, _ = sharded.make_dp_train_step(tcfg, None)
    ts, tsteps = tstate(problem), []
    for uv in uvs:
        ts, m = tstep(ts, tbatch, uv=uv)
        tsteps.append((ts, {k: float(v) for k, v in m.items()}))
    assert all(js[1]["mv_geo"] > 0 for js in jsteps), "no valid multi-view sample: the check would be vacuous"
    for (_, jm), (_, tm) in zip(jsteps, tsteps):
        for key in ("mv_ncc", "mv_geo"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-3, err_msg=key)
    check_against_jax(problem["state"], jsteps, tsteps[0][0], tsteps[-1][0], [m for _, m in tsteps])
