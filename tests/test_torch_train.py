"""The port's train step: parity with the JAX package's, the finite-step
gate, the row budget and the host-side schedule, and a short learning run.

The K=3-step parity test feeds one converted state to both packages' train
steps (the JAX step on its `jnp` backend, the port's on its default "blend"
backend, which on the CPU runs the autograd Function through the plain
blend and its closed-form backward). Tolerances, and why:
  * losses: rtol 1e-3 per step;
  * first-step gradients (Adam's first moment after one step is exactly
    0.1·grad): normalised by the max |grad| of each leaf, atol 5e-3, the
    gradient tolerance of the JAX suite;
  * parameters after K steps: atol 1e-2·lr per leaf, on the elements whose
    gradient stood above 1e-1 of its leaf's largest on every step (JAX's
    Adam m). Adam moves an element by lr·m̂/(√v̂ + 1e-15), and on the first
    steps m̂/√v̂ is ±1 whatever the size of the gradient: a gradient that
    is float noise (the rotation of an isotropic gaussian has almost none)
    moves its element by a full lr in either direction in either package,
    so those elements carry no parity. Elements with no gradient on any
    step must not move in either package;
  * moments and densification stats after K steps: normalised atol 1e-2
    (they carry the same gradient noise, not amplified).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidegs_tpu.data.synthetic import make_toy_gaussians as jtoy
from hidegs_tpu.data.synthetic import ring_camera as jring_camera
from hidegs_tpu.model.gaussians import init_from_points as jinit
from hidegs_tpu.model import densify as jdens
from hidegs_tpu.model.knn import initial_scales as jinitial_scales
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu.raster.api import render as jrender
from hidegs_tpu.train import loop as jl
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.data import synthetic as tsyn
from hidegs_tpu_torch.model import densify as tdens
from hidegs_tpu_torch.model.gaussians import init_from_points
from hidegs_tpu_torch.model.knn import initial_scales
from hidegs_tpu_torch.raster.api import RasterConfig, render
from hidegs_tpu_torch.train import loop as tl
from hidegs_tpu_torch.train.losses import psnr

torch.set_num_threads(1)

H = W = 64
N_VIEWS = 4
K = 3
FIELDS = ("xyz", "sh_dc", "sh_rest", "scaling", "rotation", "opacity")


def tcam_of(cam):
    leaves = [np.asarray(x) for x in (cam.R, cam.t, cam.fx, cam.fy, cam.cx, cam.cy)]
    return convert.camera_from_jax(*leaves, cam.height, cam.width, device="cpu")


def _state_numpy(js):
    return dict(
        params={f: np.asarray(getattr(js.params, f)) for f in FIELDS}, alive=np.asarray(js.alive),
        grad_max=np.asarray(js.grad_max), grad_abs_max=np.asarray(js.grad_abs_max),
        max_radii2d=np.asarray(js.max_radii2d), protected=np.asarray(js.protected),
        active_sh_degree=int(js.active_sh_degree), spatial_lr_scale=float(js.spatial_lr_scale))


@pytest.fixture(scope="module")
def problem():
    """tests/test_train.py's toy problem: ground-truth views of a 150-gaussian
    scene, and a state initialised from jittered true points with gray
    colours, in both packages."""
    scene = jtoy(150, seed=0)
    cams = [jring_camera(i, n_cams=N_VIEWS, height=H, width=W) for i in range(N_VIEWS)]
    gts = [jrender(*scene, c, config=JConfig(backend="jnp", max_instances=1 << 14))["render"] for c in cams]
    pts = scene.means3d + 0.01 * jax.random.normal(jax.random.PRNGKey(1), scene.means3d.shape)
    js = jinit(pts, jnp.full((150, 3), 0.5), capacity=256, knn_scale=jinitial_scales(pts), spatial_lr_scale=3.0)
    return dict(jcams=cams, jgts=gts, jstate=js, tcams=[tcam_of(c) for c in cams],
                tgts=[torch.tensor(np.asarray(g)) for g in gts], state=_state_numpy(js))


def _tbatch(problem, i, image=None):
    return tl.ViewBatch(cam=problem["tcams"][i], image=problem["tgts"][i] if image is None else image,
                        image_idx=torch.tensor(i))


def _tstate(problem):
    return tl.init_train_state(convert.gaussian_state_from_jax(**problem["state"], device="cpu"), N_VIEWS)


TCFG = tl.TrainConfig(iterations=100, raster=RasterConfig(max_instances=1 << 14), freq_warmup=0,
                      single_view_from=0)


@pytest.fixture(scope="module")
def k_steps(problem):
    """K steps of both train steps from one state (the default TrainConfig
    with every loss term on from step 0); the JAX step compiles once."""
    jcfg = jl.TrainConfig(iterations=100, raster=JConfig(backend="jnp", max_instances=1 << 14),
                          freq_warmup=0, single_view_from=0)
    jts = jl.init_train_state(jax.tree.map(jnp.copy, problem["jstate"]), N_VIEWS)
    tts = _tstate(problem)
    runs = []
    for k in range(K):
        i = k % N_VIEWS
        jts, jm = jl.train_step(jts, jl.ViewBatch(cam=problem["jcams"][i], image=problem["jgts"][i],
                                                  image_idx=jnp.int32(i)), jcfg)
        tts, tm = tl.train_step(tts, _tbatch(problem, i), TCFG)
        # the JAX step donates its input state: keep numpy copies
        runs.append((jax.tree.map(np.asarray, jts), {k: np.asarray(v) for k, v in jm.items()}, tts, tm))
    return runs


def _normalised_close(got, want, atol, what):
    want = np.asarray(want)
    denom = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got.numpy() / denom, want / denom, atol=atol, err_msg=what)


def test_train_steps_match_jax(problem, k_steps):
    lr = TCFG.lr
    leaf_lr = {"xyz": lr.position_lr_init * 3.0, "sh_dc": lr.feature_lr,
               "sh_rest": lr.feature_lr / lr.feature_rest_div, "scaling": lr.scaling_lr,
               "rotation": lr.rotation_lr, "opacity": lr.opacity_lr}
    for k, (jts, jm, tts, tm) in enumerate(k_steps):
        for key in ("total", "photo", "freq", "single_view"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-3, err_msg=f"step {k} {key}")
        assert float(tm["step_ok"]) == float(jm["step_ok"]) == 1.0
        for key in ("overflow", "block_overflow", "num_instances", "num_visible"):
            assert int(tm[key]) == int(jm[key]), key
    jts, _, tts, _ = k_steps[0]
    for f in FIELDS:  # the first step's gradients, through Adam's m = 0.1·g
        _normalised_close(getattr(tts.opt.m, f), getattr(jts.opt.m, f), 5e-3, f"step-1 grad {f}")
    jts, _, tts, _ = k_steps[-1]
    for f in FIELDS:
        got, want = getattr(tts.gaussians.params, f).numpy(), np.asarray(getattr(jts.gaussians.params, f))
        m_steps = [np.abs(np.asarray(getattr(run[0].opt.m, f))) for run in k_steps]
        signal = np.all([m > 1e-1 * m.max() for m in m_steps], axis=0)
        still = np.all([m == 0 for m in m_steps], axis=0)
        assert signal.any() or still.all(), f"param {f}: no element with a gradient above noise"
        np.testing.assert_allclose(got[signal], want[signal], atol=1e-2 * leaf_lr[f], rtol=0,
                                   err_msg=f"param {f}")
        start = problem["state"]["params"][f]
        np.testing.assert_array_equal(got[still], start[still], err_msg=f"param {f} without gradient")
        np.testing.assert_array_equal(want[still], start[still], err_msg=f"JAX param {f} without gradient")
        _normalised_close(getattr(tts.opt.m, f), getattr(jts.opt.m, f), 1e-2, f"m {f}")
        _normalised_close(getattr(tts.opt.v, f), getattr(jts.opt.v, f), 1e-2, f"v {f}")
    np.testing.assert_array_equal(tts.opt.step.numpy(), np.asarray(jts.opt.step))
    _normalised_close(tts.gaussians.grad_max, jts.gaussians.grad_max, 1e-2, "grad_max")
    np.testing.assert_array_equal(tts.gaussians.max_radii2d.numpy(), np.asarray(jts.gaussians.max_radii2d))
    assert int(tts.step) == int(jts.step) == K


def test_train_state_converts_both_ways(k_steps):
    """A JAX TrainState after one step (moments, per-row steps and stats
    non-zero) through train_state_from_jax and back through
    train_state_to_numpy: every leaf exactly equal."""
    jts = k_steps[0][0]
    opt = jts.opt
    tts = convert.train_state_from_jax(
        gaussians=_state_numpy(jts.gaussians), m={f: getattr(opt.m, f) for f in FIELDS},
        v={f: getattr(opt.v, f) for f in FIELDS}, opt_step=opt.step, exposure=jts.exposure,
        exposure_m=jts.exposure_m, exposure_v=jts.exposure_v, step=jts.step, device="cpu")
    back = convert.train_state_to_numpy(tts)
    want = _state_numpy(jts.gaussians)
    for f in FIELDS:
        np.testing.assert_array_equal(back["gaussians"]["params"][f], want["params"][f])
        np.testing.assert_array_equal(back["m"][f], getattr(opt.m, f))
        np.testing.assert_array_equal(back["v"][f], getattr(opt.v, f))
    for f in ("alive", "grad_max", "grad_abs_max", "max_radii2d", "protected", "active_sh_degree",
              "spatial_lr_scale"):
        np.testing.assert_array_equal(back["gaussians"][f], want[f])
    for f in ("exposure", "exposure_m", "exposure_v"):
        np.testing.assert_array_equal(back[f], getattr(jts, f))
    np.testing.assert_array_equal(back["opt_step"], opt.step)
    assert back["step"] == int(jts.step) == 1
    assert float(np.abs(back["m"]["xyz"]).max()) > 0


def test_densify_round_after_training_matches_jax(problem, k_steps, monkeypatch):
    """A densify round on the state that K training steps left, in both
    packages from one converted state and with the same split draws (the
    JAX key's, injected into the port's `split_draws`): the counts, alive
    masks and Adam step counts exactly equal, the children at a few ulp,
    and every view's image after the round equal at the blend tolerance, so
    the PSNR the round costs is the JAX package's to 1e-3 dB."""
    jts = k_steps[-1][0]
    opt = jts.opt
    tts = convert.train_state_from_jax(
        gaussians=_state_numpy(jts.gaussians), m={f: getattr(opt.m, f) for f in FIELDS},
        v={f: getattr(opt.v, f) for f in FIELDS}, opt_step=opt.step, exposure=jts.exposure,
        exposure_m=jts.exposure_m, exposure_v=jts.exposure_v, step=jts.step, device="cpu")
    g = jts.gaussians
    alive = np.asarray(g.alive)
    opac = 1.0 / (1.0 + np.exp(-np.asarray(g.params.opacity)))
    score = np.asarray(g.grad_max) * np.asarray(g.max_radii2d) * np.maximum(opac, 1e-8) ** 0.2
    max_scale = np.exp(np.asarray(g.params.scaling)).max(-1)
    extent = 3.0
    # a fifth of the alive rows are candidates; those at or under the
    # median scale clone, the larger split
    cfg = jdens.DensifyConfig(grad_threshold=float(np.quantile(score[alive], 0.8)), clone_min_opacity=0.0,
                              percent_dense=float(np.median(max_scale[alive])) / extent)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    C = alive.shape[0]
    draws = (torch.tensor(np.asarray(jax.random.normal(k1, (C, 3)))),
             torch.tensor(np.asarray(jax.random.normal(k2, (C, 3)))))
    monkeypatch.setattr(tdens, "split_draws", lambda gen, cap, dev: draws)
    jn, jo, jinfo = jdens.densify_and_prune(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, opt),
                                            extent, cfg, key)
    tn, tinfo = tl.densify_step(tts, extent, dataclasses.replace(TCFG, densify=tdens.DensifyConfig(*cfg)))
    assert int(jinfo["n_clone"]) > 0 and int(jinfo["n_split"]) > 0
    for k in ("n_clone", "n_split", "n_pruned", "n_alive", "n_dropped"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    np.testing.assert_array_equal(tn.gaussians.alive.numpy(), np.asarray(jn.alive))
    np.testing.assert_array_equal(tn.opt.step.numpy(), np.asarray(jo.step))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tn.gaussians.params, f).numpy(), np.asarray(getattr(jn.params, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    jcfg = JConfig(backend="jnp", max_instances=1 << 14)
    before, after = [], []
    for i in range(N_VIEWS):
        gt = problem["tgts"][i]
        jimg = np.asarray(jrender(jn.params.xyz, jn.scales, jn.quats, jn.opacities, jn.shs, problem["jcams"][i],
                                  active_sh_degree=jn.active_sh_degree, config=jcfg)["render"])
        tg = tn.gaussians
        timg = render(tg.params.xyz, tg.scales, tg.quats, tg.opacities, tg.shs, problem["tcams"][i],
                      active_sh_degree=tg.active_sh_degree, config=TCFG.raster)["render"]
        np.testing.assert_allclose(timg.numpy(), jimg, atol=3e-4, rtol=1e-3, err_msg=f"view {i}")
        after.append(float(psnr(timg, gt)))
        assert abs(after[-1] - float(psnr(torch.tensor(jimg), gt))) < 1e-3
        g0 = tts.gaussians
        before.append(float(psnr(render(g0.params.xyz, g0.scales, g0.quats, g0.opacities, g0.shs,
                                         problem["tcams"][i], active_sh_degree=g0.active_sh_degree,
                                         config=TCFG.raster)["render"], gt)))
    assert np.mean(after) != np.mean(before)


def test_train_step_is_its_three_stages(problem):
    """step_forward, step_backward and step_update, called one after the
    other, give train_step's state and metrics to the bit."""
    ts, batch = _tstate(problem), _tbatch(problem, 1)
    a, ma = tl.train_step(ts, batch, TCFG)
    loss, aux, inputs = tl.step_forward(ts, batch, TCFG)
    b, mb = tl.step_update(ts, batch, TCFG, loss, aux, tl.step_backward(loss, inputs))
    def leaves(s):
        g = s.gaussians
        return list(g.params) + list(s.opt.m) + list(s.opt.v) + [s.opt.step, g.grad_max, g.max_radii2d]

    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)


def test_finite_step_gate_skips_poisoned_step(problem):
    """A NaN pixel in the ground truth makes the loss non-finite: the step
    is skipped whole (tests/test_train.py:330)."""
    cfg = dataclasses.replace(TCFG, single_view_weight=0.0)
    ts = _tstate(problem)
    bad = problem["tgts"][0].clone()
    bad[:, 5, 5] = float("nan")
    new, metrics = tl.train_step(ts, _tbatch(problem, 0, bad), cfg)
    assert float(metrics["step_ok"]) == 0.0
    for a, b in zip(new.gaussians.params, ts.gaussians.params):
        assert torch.equal(a, b)
    for a, b in zip(new.opt.m, ts.opt.m):
        assert torch.equal(a, b)
    assert torch.equal(new.opt.step, ts.opt.step)
    assert torch.equal(new.gaussians.grad_max, ts.gaussians.grad_max)
    new, metrics = tl.train_step(new, _tbatch(problem, 1), cfg)
    assert float(metrics["step_ok"]) == 1.0
    assert float((new.gaussians.params.xyz - ts.gaussians.params.xyz).abs().max()) > 0


def test_row_budget_matches_full_capacity(problem):
    """train_step(row_budget=R) on an alive-prefix state equals the
    full-capacity step; the dead tail stays untouched."""
    runs = []
    for rb in (0, 160):
        ts = _tstate(problem)
        for it in range(2):
            ts, metrics = tl.train_step(ts, _tbatch(problem, it), TCFG, row_budget=rb)
        runs.append((ts, metrics))
    (full, fm), (sliced, sm) = runs
    assert float(fm["total"]) == pytest.approx(float(sm["total"]), rel=1e-5)
    for f in FIELDS:
        torch.testing.assert_close(getattr(sliced.gaussians.params, f), getattr(full.gaussians.params, f),
                                   rtol=1e-4, atol=1e-6)
    assert sliced.gaussians.capacity == 256
    assert int(sliced.opt.step[160:].abs().sum()) == 0


def test_exposure_and_depth_terms_run(problem):
    ts = _tstate(problem)
    invd = torch.full((H, W), 0.2)
    batch = _tbatch(problem, 2)._replace(invdepth=invd, depth_mask=torch.ones((H, W)))
    new, metrics = tl.train_step(ts, batch, TCFG, use_exposure=True)
    assert float(metrics["step_ok"]) == 1.0 and float(metrics["depth_l1"]) > 0
    assert not torch.equal(new.exposure[2], ts.exposure[2])
    assert torch.equal(new.exposure[0], ts.exposure[0])
    # the multi-view part runs in the same step (tests/test_torch_multiview.py
    # holds it against JAX); without its pixel samples step_forward refuses it
    from hidegs_tpu_torch.train.geometric import MultiViewBatch

    mv = batch._replace(multi_view=MultiViewBatch(src_image_gray=problem["tgts"][1].mean(0),
                                                  src_cam=problem["tcams"][1]))
    with pytest.raises(ValueError, match="uv"):
        tl.step_forward(ts, mv, TCFG)
    _, mv_metrics = tl.train_step(ts, mv, dataclasses.replace(TCFG, multi_view_from=0), use_exposure=True)
    assert float(mv_metrics["step_ok"]) == 1.0 and float(mv_metrics["depth_l1"]) > 0
    assert {"mv_ncc", "mv_geo"} <= set(mv_metrics)


def test_host_side_schedule(problem):
    """SH warm-up, densify and the opacity reset with its backoff on the
    host cadence (tests/test_train.py:test_opacity_reset_backoff)."""
    cfg = dataclasses.replace(TCFG, densify_from=1, densify_until=100, densify_interval=5,
                              opacity_reset_interval=3, opacity_reset_until=3, sh_increase_interval=2)
    cfg = dataclasses.replace(cfg, densify=cfg.densify._replace(grad_threshold=0.0, clone_min_opacity=0.0))
    ts = _tstate(problem)
    alive0 = int(ts.gaussians.alive.sum())
    for it in range(1, 7):
        ts, _ = tl.train_step(ts, _tbatch(problem, 0), cfg)
        ts, info = tl.maybe_host_side_schedule(ts, cfg, scene_extent=3.0, step=it)
        assert (info is not None) == (it == 5)
        if it == 3:
            assert float(ts.opt.m.opacity.abs().max()) == 0.0
    assert float(ts.opt.m.opacity.abs().max()) > 0.0  # the step-6 reset was suppressed
    assert int(ts.gaussians.active_sh_degree) == 3
    assert int(ts.gaussians.alive.sum()) > alive0


def _mean_psnr(ts, cams, gts, cfg):
    g = ts.gaussians
    vals = []
    for c, gt in zip(cams, gts):
        out = render(g.params.xyz, g.scales, g.quats, g.opacities, g.shs, c,
                     active_sh_degree=g.active_sh_degree, config=cfg)
        vals.append(float(psnr(out["render"], gt)))
    return float(np.mean(vals))


def test_training_improves_psnr():
    """The port alone: a toy scene learned from four views
    (tests/test_train.py:test_training_improves_psnr)."""
    rcfg = RasterConfig(max_instances=1 << 14)
    scene = tsyn.make_toy_gaussians(150, seed=0, device="cpu")
    cams = [tsyn.ring_camera(i, n_cams=N_VIEWS, height=H, width=W, device="cpu") for i in range(N_VIEWS)]
    with torch.no_grad():
        gts = [render(*scene, c, config=rcfg)["render"] for c in cams]
    pts = scene.means3d + 0.01 * torch.randn(scene.means3d.shape, generator=torch.Generator().manual_seed(1))
    state = init_from_points(pts, torch.full((150, 3), 0.5), capacity=256, knn_scale=initial_scales(pts),
                             spatial_lr_scale=3.0)
    cfg = tl.TrainConfig(iterations=200, raster=rcfg, freq_warmup=50, single_view_weight=0.0,
                         densify_from=100, densify_until=150, densify_interval=50,
                         opacity_reset_interval=10_000, sh_increase_interval=60)
    ts = tl.init_train_state(state, num_images=N_VIEWS)
    p0 = _mean_psnr(ts, cams, gts, rcfg)
    for it in range(90):
        i = it % N_VIEWS
        ts, metrics = tl.train_step(ts, tl.ViewBatch(cam=cams[i], image=gts[i], image_idx=torch.tensor(i)), cfg)
        ts, _ = tl.maybe_host_side_schedule(ts, cfg, scene_extent=4.0, step=it + 1)
        assert float(metrics["step_ok"]) == 1.0
    p1 = _mean_psnr(ts, cams, gts, rcfg)
    assert np.isfinite(float(metrics["total"]))
    assert p1 > p0 + 2.5, (p0, p1)
    assert int(ts.step) == 90
