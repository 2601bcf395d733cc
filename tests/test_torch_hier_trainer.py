"""Port parity: the hierarchy post-optimizer (train/hier_trainer.py) and the
appearance model (model/appearance.py) of hidegs_tpu_torch against
hidegs_tpu, on the CPU.

The scene is the JAX suite's (tests/test_hier_trainer.py): the hierarchy of
make_toy_gaussians(40, seed=6) with its SH scaled by 0.3, three 48x48 ring
views, the targets the JAX renders of the unscaled scene. Tolerances, as in
tests/test_torch_trainer.py: losses rtol 1e-3, the first step's gradients
normalised atol 5e-3, the parameters within 1e-2·lr where the gradient is
signal (rows that never had a gradient bitwise unchanged), `n_visible`
exactly equal, frozen rows bitwise unchanged; the appearance model atol
1e-7.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidegs_tpu.data import synthetic as jsyn
from hidegs_tpu.hier import build as jbuild
from hidegs_tpu.hier.lod import tau_to_target_size
from hidegs_tpu.model import appearance as japp
from hidegs_tpu.model.schedules import LRConfig as JLRConfig
from hidegs_tpu.model.schedules import lr_tree as jlr_tree
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu.raster.api import render as jrender
from hidegs_tpu.train import hier_trainer as jht
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.hier import interp as tinterp
from hidegs_tpu_torch.hier import io as tio
from hidegs_tpu_torch.hier import lod as tlod
from hidegs_tpu_torch.model import appearance as tapp
from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
from hidegs_tpu_torch.raster.api import RasterConfig
from hidegs_tpu_torch.train import hier_trainer as tht
from hidegs_tpu_torch.train.losses import psnr

torch.set_num_threads(1)

H = W = 48
FIELDS = ("xyz", "sh_dc", "sh_rest", "scaling", "rotation", "opacity")
LR = LRConfig()
LEAF_LR = {"xyz": LR.position_lr_init, "sh_dc": LR.feature_lr, "sh_rest": LR.feature_lr / LR.feature_rest_div,
           "scaling": LR.scaling_lr, "rotation": LR.rotation_lr, "opacity": LR.opacity_lr}
JCFG = JConfig(backend="jnp", max_instances=1 << 12)
TCFG = RasterConfig(backend="blend", max_instances=1 << 12)


def tcam_of(cam):
    leaves = [np.asarray(x) for x in (cam.R, cam.t, cam.fx, cam.fy, cam.cx, cam.cy)]
    return convert.camera_from_jax(*leaves, cam.height, cam.width, device="cpu")


@pytest.fixture(scope="module")
def problem():
    """The JAX suite's post-opt scene: (hierarchy, JAX cams, port cams,
    targets)."""
    scene = jsyn.make_toy_gaussians(40, seed=6)
    jcams = [jsyn.ring_camera(i, n_cams=3, height=H, width=W) for i in range(3)]
    gts = [np.array(jrender(*scene, c, config=JCFG)["render"]) for c in jcams]
    h = jbuild._build_hierarchy_py(np.asarray(scene.means3d), np.asarray(scene.quats), np.asarray(scene.scales),
                                   np.asarray(scene.opacities), np.asarray(scene.shs) * 0.3)
    return h, jcams, [tcam_of(c) for c in jcams], gts


def host_state(ts):
    """The fields the tests compare, as numpy arrays."""
    return {
        "params": {f: np.array(getattr(ts.params, f)) for f in FIELDS},
        "m": {f: np.array(getattr(ts.opt.m, f)) for f in FIELDS},
        "exposure": np.array(ts.exposure),
        "exposure_m": np.array(ts.exposure_m),
        "step": int(ts.step),
    }


def assert_runs_match(jruns, truns, frozen=None):
    """Per-step losses and visible counts, the first step's gradients and
    the final parameters of two runs of (state, metrics) pairs."""
    assert len(jruns) == len(truns)
    for k, ((_, jm), (_, tm)) in enumerate(zip(jruns, truns)):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-3, err_msg=f"step {k} loss")
        assert tm["n_visible"] == jm["n_visible"], k
    j0, t0 = jruns[0][0], truns[0][0]
    for f in FIELDS:  # the first step's gradients, through Adam's m = 0.1·g
        want = j0["m"][f]
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(t0["m"][f] / scale, want / scale, atol=5e-3, err_msg=f"step-1 grad {f}")
    jl, tl_ = jruns[-1][0], truns[-1][0]
    for f in FIELDS:
        got, want = tl_["params"][f], jl["params"][f]
        m_steps = [np.abs(run[0]["m"][f]) for run in jruns]
        signal = np.all([m > 1e-1 * max(m.max(), 1e-30) for m in m_steps], axis=0)
        still = np.all([m == 0 for m in m_steps], axis=0)
        assert signal.any() or still.all(), f  # sh_rest may have no gradient at all
        np.testing.assert_allclose(got[signal], want[signal], rtol=0, atol=1e-2 * LEAF_LR[f], err_msg=f)
        assert np.array_equal(got[still], want[still]), f"{f} moved without gradient"
    if frozen is not None:
        for f in FIELDS:
            assert np.array_equal(tl_["params"][f][frozen], truns[0][0]["params0"][f][frozen]), f


# ------------------------------------------------------------ appearance


def test_appearance_model_matches_jax():
    """init, apply and 5 updates on the same gradients: every field within
    1e-7 of JAX's; the loss gradients of both packages agree."""
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(3, 16, 16)).astype(np.float32)
    jm, tm = japp.init_app_model(4), tapp.init_app_model(4, device="cpu")
    for f in japp.AppModel._fields:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    for k in range(5):
        ga, gb = rng.normal(size=2).astype(np.float32)
        jm = japp.appearance_update(jm, ga, gb, 1, lr=2e-2)
        tm = tapp.appearance_update(tm, torch.tensor(ga), torch.tensor(gb), 1, lr=2e-2)
        for f in japp.AppModel._fields:
            np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), rtol=0, atol=1e-7,
                                       err_msg=f"update {k} {f}")
    np.testing.assert_allclose(tapp.apply_appearance(tm, torch.tensor(img), 1).numpy(),
                               np.asarray(japp.apply_appearance(jm, jnp.asarray(img), 1)), rtol=0, atol=1e-7)
    target = 1.3 * img + 0.05
    jg = jax.grad(lambda a, b: jnp.mean((japp.apply_appearance(jm._replace(a=a, b=b), jnp.asarray(img), 1)
                                         - target) ** 2), argnums=(0, 1))(jm.a, jm.b)
    a, b = tm.a.clone().requires_grad_(True), tm.b.clone().requires_grad_(True)
    torch.mean((tapp.apply_appearance(tm._replace(a=a, b=b), torch.tensor(img), 1) - torch.tensor(target)) ** 2).backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jg[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jg[1]), rtol=1e-5, atol=1e-7)


def test_appearance_model_fits_a_gain_and_offset():
    """tests/test_hier_trainer.py::test_appearance_model on the port."""
    app = tapp.init_app_model(4, device="cpu")
    img = torch.as_tensor(np.random.default_rng(0).uniform(size=(3, 16, 16)).astype(np.float32))
    target = 1.3 * img + 0.05
    m = app
    for _ in range(500):
        a, b = m.a.clone().requires_grad_(True), m.b.clone().requires_grad_(True)
        torch.mean((tapp.apply_appearance(m._replace(a=a, b=b), img, 1) - target) ** 2).backward()
        m = tapp.appearance_update(m, a.grad[1], b.grad[1], 1, lr=2e-2)
    assert abs(float(torch.exp(m.a[1])) - 1.3) < 0.1
    assert abs(float(m.b[1]) - 0.05) < 0.05
    assert float(m.a[0]) == 0.0


# ------------------------------------------------------------ exposures


def test_load_exposures_matches_jax(tmp_path):
    expo = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], 1)[None], (3, 1, 1)).astype(np.float32)
    expo[1, :3, :3] *= 0.8
    by_index = tmp_path / "index.json"
    by_index.write_text(json.dumps({str(i): expo[i].tolist() for i in (2, 0, 1)}))
    by_name = tmp_path / "name.json"
    by_name.write_text(json.dumps({"b.png": expo[1].tolist(), "a.png": expo[2].tolist()}))
    np.testing.assert_array_equal(tht.load_exposures(str(by_index)), jht.load_exposures(str(by_index)))
    np.testing.assert_array_equal(tht.load_exposures(str(by_index)), expo)
    names = ["a.png", "b.png", "c.png"]
    np.testing.assert_array_equal(tht.load_exposures(str(by_name), names), jht.load_exposures(str(by_name), names))
    for mod in (tht, jht):
        with pytest.raises(ValueError, match="keyed by image names"):
            mod.load_exposures(str(by_name))
        assert mod.load_exposures(str(tmp_path / "missing.json")) is None
        assert mod.load_exposures("") is None


# ------------------------------------------------------------ train steps


def _cut_target(jcam):
    """A cut that interpolates: parents with 0 < t < 1 on the first view."""
    return tau_to_target_size(3.0, float(jcam.fx))


VARIANTS = {
    "plain": dict(),
    "skybox_tail": dict(skybox_count=6),
    "frozen_anchors": dict(frozen=True),
    "exposure": dict(use_exposure=True, optimize_exposure=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_hier_train_steps_match_jax(problem, variant):
    """Three post-opt steps (views 0, 1, 2) from one hierarchy in both
    packages, on the same cuts."""
    h, jcams, tcams, gts = problem
    kw = dict(VARIANTS[variant])
    P = h.num_points
    frozen_np = None
    if kw.pop("frozen", False):
        frozen_np = np.zeros(P, bool)
        frozen_np[np.random.default_rng(3).choice(P, P // 4, replace=False)] = True
    target = _cut_target(jcams[0])
    budget = 128
    jts = jht.state_from_hierarchy(h, num_images=3)
    tts = tht.state_from_hierarchy(tio.Hierarchy(*h), num_images=3, device="cpu")
    params0 = host_state(tts)["params"]
    jruns, truns = [], []
    for k in range(3):
        jcut = jht.select_cut(jts, jcams[k], target, budget)
        tcut = tht.select_cut(tts, tcams[k], target, budget)
        for f in ("render_indices", "parent_indices", "valid", "kids"):
            np.testing.assert_array_equal(getattr(tcut, f).numpy(), np.asarray(getattr(jcut, f)), err_msg=f)
        if k == 0:
            t_slots = tcut.ts[tcut.valid].numpy()
            assert ((t_slots > 0) & (t_slots < 1)).any(), "the cut does not interpolate"
            parents_only = np.setdiff1d(tcut.parent_indices[tcut.valid].numpy(), tcut.render_indices.numpy())
        jts, jm = jht.hier_train_step(
            jts, jcut, jcams[k], jnp.asarray(gts[k]), jlr_tree(jts.step, JLRConfig(), jnp.float32(1.0)), JCFG,
            frozen=None if frozen_np is None else jnp.asarray(frozen_np), image_idx=k, **kw)
        tts, tm = tht.hier_train_step(
            tts, tcut, tcams[k], torch.as_tensor(gts[k]), lr_tree(tts.step, LR, 1.0), TCFG,
            frozen=None if frozen_np is None else torch.as_tensor(frozen_np), image_idx=k, **kw)
        jruns.append((host_state(jts), {"loss": float(jm["loss"]), "n_visible": int(jm["n_visible"])}))
        truns.append((host_state(tts), {"loss": float(tm["loss"]), "n_visible": int(tm["n_visible"])}))
    truns[0][0]["params0"] = params0
    # parents that no slot renders take gradients through the interpolation
    moved = np.abs(truns[0][0]["m"]["sh_dc"][parents_only]).max(axis=1) > 0
    assert moved.any(), parents_only
    assert_runs_match(jruns, truns, frozen=frozen_np)
    assert truns[-1][0]["step"] == 3
    if kw.get("optimize_exposure"):
        np.testing.assert_allclose(truns[-1][0]["exposure"], jruns[-1][0]["exposure"], rtol=0, atol=1e-2 * 1e-3)
        assert np.abs(truns[-1][0]["exposure"] - np.eye(3, 4)).max() > 0
    else:
        assert np.array_equal(truns[-1][0]["exposure"], jruns[0][0]["exposure"])


def test_hier_train_step_leaves_its_input_state(problem):
    h, _, tcams, gts = problem
    ts = tht.state_from_hierarchy(tio.Hierarchy(*h), num_images=3, device="cpu")
    before = host_state(ts)
    cut = tht.select_cut(ts, tcams[0], 1e-9, 128)
    a, ma = tht.hier_train_step(ts, cut, tcams[0], torch.as_tensor(gts[0]), lr_tree(ts.step, LR, 1.0), TCFG)
    b, mb = tht.hier_train_step(ts, cut, tcams[0], torch.as_tensor(gts[0]), lr_tree(ts.step, LR, 1.0), TCFG)
    after = host_state(ts)
    for f in FIELDS:
        assert np.array_equal(before["params"][f], after["params"][f]), f
        assert torch.equal(getattr(a.params, f), getattr(b.params, f)), f
        assert torch.equal(getattr(a.opt.v, f), getattr(b.opt.v, f)), f
    assert torch.equal(ma["loss"], mb["loss"]) and int(a.step) == 1 and int(ts.step) == 0


def _recorder(module, monkeypatch):
    runs = []
    original = module.hier_train_step

    def step(*args, **kwargs):
        ts, m = original(*args, **kwargs)
        runs.append((host_state(ts), {"loss": float(m["loss"]), "n_visible": int(m["n_visible"])}))
        return ts, m

    monkeypatch.setattr(module, "hier_train_step", step)
    return runs


def test_post_optimize_matches_jax(problem, monkeypatch):
    """post_optimize for 5 iterations in both packages (the same
    random.Random(0) view order), with exposure training, and
    hierarchy_from_state."""
    h, jcams, tcams, gts = problem
    jruns, truns = _recorder(jht, monkeypatch), _recorder(tht, monkeypatch)
    target = _cut_target(jcams[0])
    kw = dict(iterations=5, target_size=target, budget=128, log_every=1000, optimize_exposure=True)
    jts = jht.post_optimize(h, jcams, gts, raster_cfg=JCFG, **kw)
    tts = tht.post_optimize(tio.Hierarchy(*h), tcams, gts, raster_cfg=TCFG, device="cpu", **kw)
    assert_runs_match(jruns, truns)
    jh, th = jht.hierarchy_from_state(jts, h), tht.hierarchy_from_state(tts, tio.Hierarchy(*h))
    last = jruns[-1][0]["m"]
    for name, f, lr in (("pos", "xyz", LEAF_LR["xyz"]), ("scale", "scaling", LEAF_LR["scaling"]),
                        ("shs", None, LEAF_LR["sh_dc"])):
        got, want = getattr(th, name), getattr(jh, name)
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32, name
        if f is None:
            continue
        signal = np.abs(last[f]) > 1e-1 * np.abs(last[f]).max()
        np.testing.assert_allclose(got[signal], want[signal], rtol=0, atol=1e-2 * lr, err_msg=name)
    np.testing.assert_array_equal(th.nodes, jh.nodes)
    np.testing.assert_array_equal(th.boxes, jh.boxes)
    np.testing.assert_allclose(np.linalg.norm(th.rot, axis=1), 1.0, atol=1e-6)
    assert (th.alpha >= 0).all()


def test_post_optimize_with_anchors_keeps_them(problem):
    h, _, tcams, gts = problem
    anchors = np.arange(0, h.num_points, 5, dtype=np.int32)
    ts = tht.post_optimize(tio.Hierarchy(*h), tcams, gts, iterations=4, target_size=1e-9, budget=128,
                           raster_cfg=TCFG, log_every=2, anchors=anchors, device="cpu")
    for f, arr in zip(FIELDS, (h.pos, h.shs[:, 0], h.shs[:, 1:], h.scale, h.rot, h.alpha)):
        assert np.array_equal(getattr(ts.params, f).numpy()[anchors], arr[anchors]), f
    assert not np.array_equal(ts.params.xyz.numpy(), h.pos)


def test_post_optimize_improves_loss(problem):
    """tests/test_hier_trainer.py::test_post_optimize_improves_loss on the
    port: +1 dB after 60 iterations on the near-leaf cut."""
    h, _, tcams, gts = problem
    th = tio.Hierarchy(*h)
    ts = tht.post_optimize(th, tcams, gts, iterations=60, target_size=1e-9, budget=128, raster_cfg=TCFG,
                           log_every=1000, device="cpu")
    h2 = tht.hierarchy_from_state(ts, th)
    assert np.isfinite(h2.pos).all() and np.isfinite(h2.shs).all()

    def quality(hh):
        vals = []
        arrays = tinterp.hierarchy_tensors(hh, "cpu")
        for c, g in zip(tcams, gts):
            cut = tlod.expand_to_size(arrays[0], arrays[1], 1e-9, c.camera_center, budget=128,
                                      num_points=hh.num_points)
            out = tinterp.render_hierarchy(cut, *arrays[2:], c, config=TCFG)
            vals.append(float(psnr(out["render"], torch.as_tensor(g))))
        return np.mean(vals)

    q_before, q_after = quality(th), quality(h2)
    assert q_after > q_before + 1.0, (q_before, q_after)
