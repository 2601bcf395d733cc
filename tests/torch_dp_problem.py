"""The view-parallel parity problem shared by tests/test_torch_parallel.py
and tests/test_torch_distributed.py: tests/test_parallel.py's 60-gaussian
problem at 32x32 in both packages, JAX's DP steps on a mesh of the suite's
virtual CPU devices, and the checks of tests/test_torch_train.py.

Tolerances are tests/test_torch_train.py's, for the same reasons: losses
rtol 1e-3; the first step's gradients (Adam's m = 0.1·g) normalised atol
5e-3; the parameters after K steps atol 1e-2·lr on the elements whose
gradient stood above 1e-1 of its leaf's largest on every step, and unmoved
where they had none; moments and densification stats normalised atol 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from hidegs_tpu.data.synthetic import make_toy_gaussians as jtoy
from hidegs_tpu.data.synthetic import ring_camera as jring_camera
from hidegs_tpu.model.gaussians import init_from_points as jinit
from hidegs_tpu.model.knn import initial_scales as jinitial_scales
from hidegs_tpu.parallel.mesh import make_mesh as jmake_mesh
from hidegs_tpu.parallel.sharded import make_dp_train_step as jmake_dp
from hidegs_tpu.parallel.sharded import stack_view_batches as jstack
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu.raster.api import render as jrender
from hidegs_tpu.train import loop as jl
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.raster.api import RasterConfig
from hidegs_tpu_torch.train import loop as tl

H = W = 32
N, V, K = 60, 4, 3
FIELDS = ("xyz", "sh_dc", "sh_rest", "scaling", "rotation", "opacity")
JRCFG = JConfig(backend="jnp", max_instances=1 << 12)
TCFG = tl.TrainConfig(iterations=100, raster=RasterConfig(max_instances=1 << 12), freq_warmup=0,
                      single_view_from=0)
JCFG = jl.TrainConfig(iterations=100, raster=JRCFG, freq_warmup=0, single_view_from=0)


def state_numpy(js):
    return dict(
        params={f: np.asarray(getattr(js.params, f)) for f in FIELDS}, alive=np.asarray(js.alive),
        grad_max=np.asarray(js.grad_max), grad_abs_max=np.asarray(js.grad_abs_max),
        max_radii2d=np.asarray(js.max_radii2d), protected=np.asarray(js.protected),
        active_sh_degree=int(js.active_sh_degree), spatial_lr_scale=float(js.spatial_lr_scale))


def make_problem():
    """tests/test_parallel.py's setup: 60 toy gaussians, four ring views,
    a state at capacity 64 from the true points with gray colours; its
    scales made anisotropic, so that the rotations take a real gradient
    (an isotropic gaussian's rotation gradient is float noise, which Adam
    turns into full-lr steps of either sign: tests/test_torch_train.py)."""
    scene = jtoy(N, seed=0)
    cams = [jring_camera(i, n_cams=V, height=H, width=W) for i in range(V)]
    gts = [jrender(*scene, c, config=JRCFG)["render"] for c in cams]
    js = jinit(scene.means3d, jnp.full((N, 3), 0.5), capacity=64, knn_scale=jinitial_scales(scene.means3d))
    aniso = np.random.default_rng(0).normal(0.0, 0.3, (64, 3)).astype(np.float32)
    js = js._replace(params=js.params._replace(scaling=js.params.scaling + aniso))
    jbatch = jstack([jl.ViewBatch(cam=cams[i], image=gts[i], image_idx=jnp.int32(i)) for i in range(V)])
    c = jbatch.cam
    tbatch = convert.stacked_views_from_jax(*(np.asarray(x) for x in (c.R, c.t, c.fx, c.fy, c.cx, c.cy)), H, W,
                                            np.asarray(jbatch.image), np.asarray(jbatch.image_idx), device="cpu")
    return dict(jstate=js, jbatch=jbatch, tbatch=tbatch, state=state_numpy(js), jcams=cams)


def tstate(problem):
    return tl.init_train_state(convert.gaussian_state_from_jax(**problem["state"], device="cpu"), V)


def jax_dp_runs(problem, data, model, wire, shard_gaussians=False, steps=K):
    """`steps` steps of JAX's DP step on a (data, model) mesh: numpy copies
    of each step's state and metrics (the step donates its input)."""
    step, place = jmake_dp(JCFG, jmake_mesh(data * model, data=data, model=model), grad_reduce_dtype=wire)
    ts = jl.init_train_state(jax.tree.map(jnp.copy, problem["jstate"]), num_images=V)
    ts, batch = place(ts, problem["jbatch"], shard_gaussians=shard_gaussians)
    out = []
    for _ in range(steps):
        ts, m = step(ts, batch)
        out.append((jax.tree.map(np.asarray, ts), {k: float(v) for k, v in m.items()}))
    return out


def normalised_close(got, want, atol, what):
    want = np.asarray(want)
    denom = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(np.asarray(got) / denom, want / denom, atol=atol, err_msg=what)


def _leaf(state, group, f):
    """A leaf of a port TrainState, or of `train_state_to_numpy`'s dict."""
    if isinstance(state, dict):
        return np.asarray(state["gaussians"]["params"][f] if group == "params" else state[group][f])
    obj = state.gaussians.params if group == "params" else getattr(state.opt, group)
    return getattr(obj, f).numpy()


def _field(state, name):
    if isinstance(state, dict):
        return np.asarray(state["opt_step"] if name == "opt_step" else
                          state["step"] if name == "step" else state["gaussians"][name])
    if name == "opt_step":
        return state.opt.step.numpy()
    if name == "step":
        return state.step.numpy()
    return getattr(state.gaussians, name).numpy()


def check_against_jax(start, jsteps, t_first, t_last, t_metrics):
    """tests/test_torch_train.py's checks on K steps of both packages:
    `jsteps` from `jax_dp_runs`; the port's state after the first and the
    last step (TrainStates or `train_state_to_numpy` dicts) and its
    per-step metrics."""
    lr = TCFG.lr
    leaf_lr = {"xyz": lr.position_lr_init * float(start["spatial_lr_scale"]), "sh_dc": lr.feature_lr,
               "sh_rest": lr.feature_lr / lr.feature_rest_div, "scaling": lr.scaling_lr,
               "rotation": lr.rotation_lr, "opacity": lr.opacity_lr}
    assert len(jsteps) == len(t_metrics)
    for k, ((_, jm), tm) in enumerate(zip(jsteps, t_metrics)):
        for key in ("loss", "total", "photo", "freq", "single_view"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-3, err_msg=f"step {k} {key}")
        for key in ("overflow", "num_instances", "num_visible"):
            assert tm[key] == jm[key], key
    jts = jsteps[0][0]
    for f in FIELDS:
        normalised_close(_leaf(t_first, "m", f), getattr(jts.opt.m, f), 5e-3, f"step-1 grad {f}")
    jts = jsteps[-1][0]
    for f in FIELDS:
        got, want = _leaf(t_last, "params", f), getattr(jts.gaussians.params, f)
        m_steps = [np.abs(getattr(s[0].opt.m, f)) for s in jsteps]
        signal = np.all([m > 1e-1 * m.max() for m in m_steps], axis=0)
        still = np.all([m == 0 for m in m_steps], axis=0)
        assert signal.any() or still.all(), f"param {f}: no element with a gradient above noise"
        np.testing.assert_allclose(got[signal], want[signal], atol=1e-2 * leaf_lr[f], rtol=0, err_msg=f"param {f}")
        first = start["params"][f]
        np.testing.assert_array_equal(got[still], first[still], err_msg=f"param {f} without gradient")
        np.testing.assert_array_equal(want[still], first[still], err_msg=f"JAX param {f} without gradient")
        normalised_close(_leaf(t_last, "m", f), getattr(jts.opt.m, f), 1e-2, f"m {f}")
        normalised_close(_leaf(t_last, "v", f), getattr(jts.opt.v, f), 1e-2, f"v {f}")
    np.testing.assert_array_equal(_field(t_last, "opt_step"), jts.opt.step)
    np.testing.assert_array_equal(_field(t_last, "alive"), jts.gaussians.alive)
    normalised_close(_field(t_last, "grad_max"), jts.gaussians.grad_max, 1e-2, "grad_max")
    normalised_close(_field(t_last, "grad_abs_max"), jts.gaussians.grad_abs_max, 1e-2, "grad_abs_max")
    np.testing.assert_array_equal(_field(t_last, "max_radii2d"), jts.gaussians.max_radii2d)
    assert int(_field(t_last, "step")) == int(jts.step) == len(jsteps)
