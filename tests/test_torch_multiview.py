"""The port's multi-view slice against the JAX package: the camera and
geometry helpers, `bilinear_sample` and its gradients at ties and at the
border, the homography warp, `multi_view_losses`, `compute_losses` with the
differentiable source render, a multi-view `train_step`, and a step with
the chunk box. Both packages get the same pixel samples: the port takes
JAX's `jax.random` draws as its `uv` argument.

Tolerances:
  * camera and geometry helpers: rtol 1e-5 (float32 elementwise math and
    3x3 products in another order);
  * `bilinear_sample` values and gradients: 1e-6 absolute;
  * loss values: rtol 1e-4 (the render differs from JAX's in the last bits,
    and the multi-view masks are thresholds of it);
  * gradients: normalised by the max |grad| of each leaf, atol 5e-3, the
    JAX suite's gradient tolerance;
  * a train step: the losses, the first moment after one step (0.1·grad)
    at the gradient tolerance, and the parameters within 1e-2·lr where the
    gradient is signal (tests/test_torch_train.py says why).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidegs_tpu.core import camera_math as jcm
from hidegs_tpu.core import ewa as jewa
from hidegs_tpu.core import geometry as jgeom
from hidegs_tpu.data.synthetic import make_toy_gaussians as jtoy
from hidegs_tpu.data.synthetic import ring_camera as jring_camera
from hidegs_tpu.model.gaussians import init_from_points as jinit
from hidegs_tpu.model.knn import initial_scales as jinitial_scales
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu.raster.api import render as jrender
from hidegs_tpu.train import geometric as jgeo
from hidegs_tpu.train import loop as jl
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.core import camera_math as tcm
from hidegs_tpu_torch.core import ewa as tewa
from hidegs_tpu_torch.core import geometry as tgeom
from hidegs_tpu_torch.raster.api import RasterConfig
from hidegs_tpu_torch.raster.api import render as trender
from hidegs_tpu_torch.train import geometric as tgeo
from hidegs_tpu_torch.train import loop as tl

torch.set_num_threads(1)

H = W = 64
N_VIEWS = 4
FIELDS = ("xyz", "sh_dc", "sh_rest", "scaling", "rotation", "opacity")
JRCFG = JConfig(backend="jnp", max_instances=1 << 14)
TRCFG = RasterConfig(max_instances=1 << 14)
GRAD_TOL = 5e-3


def tcam_of(cam):
    leaves = [np.asarray(x) for x in (cam.R, cam.t, cam.fx, cam.fy, cam.cx, cam.cy)]
    return convert.camera_from_jax(*leaves, cam.height, cam.width, device="cpu")


def _t(x, grad=False):
    return torch.tensor(np.asarray(x)).requires_grad_(grad)


def _close(got, want, what, rtol=1e-5, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _normalised_close(got, want, what, atol=GRAD_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    denom = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / denom, want / denom, atol=atol, err_msg=what)


def _jax_uv(key, num_samples, patch_half=1):
    """multi_view_losses' draw: k1 of split(key), uniform in the border-free box."""
    k1, _ = jax.random.split(key)
    return jax.random.uniform(
        k1, (num_samples, 2), minval=jnp.array([patch_half + 1.0, patch_half + 1.0]),
        maxval=jnp.array([W - patch_half - 1.0, H - patch_half - 1.0]))


def _tilted_camera(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    t = rng.normal(size=3) + np.array([0.0, 0.0, 6.0])
    return jcm.make_camera(R, t, fx=70.0, fy=75.0, cx=30.5, cy=33.25, height=H, width=W)


# --------------------------------------------------------------------------
# camera and geometry helpers


def test_camera_functions_match_jax():
    """world_to_camera / camera_to_world / project_points / ndc_from_pixels /
    normal_to_world / K, on the cameras of tests/test_core_camera_sh.py and
    a tilted one, with points at z = 0 and near it (the division guard)."""
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(200, 3)) * np.array([1.0, 1.0, 0.5]) + np.array([0, 0, 1.0])).astype(np.float32)
    for jcam in (jcm.make_camera(jnp.eye(3), jnp.array([0.0, 0.0, 5.0]), fx=80.0, fy=80.0, height=64, width=96),
                 _tilted_camera(1)):
        tcam = tcam_of(jcam)
        jp = jcm.world_to_camera(jnp.asarray(pts), jcam)
        tp = tcm.world_to_camera(_t(pts), tcam)
        _close(tp, jp, "world_to_camera")
        _close(tcm.camera_to_world(tp, tcam), jcm.camera_to_world(jp, jcam), "camera_to_world", atol=1e-6)
        near = np.asarray(jp).copy()
        near[:5, 2] = [0.0, 1e-7, -1e-7, 1e-6, -2e-6]
        juv, jz = jcm.project_points(jnp.asarray(near), jcam)
        tuv, tz = tcm.project_points(_t(near), tcam)
        _close(tuv, juv, "project_points uv")
        _close(tz, jz, "project_points z", rtol=0)
        _close(tcm.ndc_from_pixels(tuv, tcam), jcm.ndc_from_pixels(juv, jcam), "ndc_from_pixels", atol=1e-6)
        nrm = rng.normal(size=(7, 5, 3)).astype(np.float32)
        _close(tgeom.normal_to_world(_t(nrm), tcam), jgeom.normal_to_world(jnp.asarray(nrm), jcam),
               "normal_to_world", atol=1e-6)
        _close(tcam.K, jcam.K, "K", rtol=0)
        _close(tcam.K_inv, jnp.linalg.inv(jcam.K), "K inverse", rtol=1e-6, atol=1e-7)


def test_project_roundtrip():
    """tests/test_core_camera_sh.py:test_project_roundtrip on the port."""
    cam = tcm.make_camera(torch.eye(3), torch.tensor([0.0, 0.0, 5.0]), fx=80.0, fy=80.0, height=64, width=96,
                          device="cpu")
    pts = torch.randn((100, 3), generator=torch.Generator().manual_seed(0)) * torch.tensor([1.0, 1.0, 0.5])
    pts = pts + torch.tensor([0.0, 0.0, 1.0])
    p_cam = tcm.world_to_camera(pts, cam)
    uv, z = tcm.project_points(p_cam, cam)
    torch.testing.assert_close(z, p_cam[:, 2], atol=1e-6, rtol=0)
    torch.testing.assert_close((uv[:, 0] - cam.cx) / cam.fx * z, p_cam[:, 0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close((uv[:, 1] - cam.cy) / cam.fy * z, p_cam[:, 1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(tcm.camera_to_world(p_cam, cam), pts, rtol=1e-4, atol=1e-4)


def test_project_gaussians_matches_jax():
    rng = np.random.default_rng(2)
    n = 300
    means = (rng.normal(size=(n, 3)) * 1.5).astype(np.float32)
    A = rng.normal(size=(n, 3, 3)) * 0.2
    cov = (A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(3)).astype(np.float32)
    jcam = _tilted_camera(3)
    want = jewa.project_gaussians(jnp.asarray(means), jnp.asarray(cov), jcam)
    got = tewa.project_gaussians(_t(means), _t(cov), tcam_of(jcam))
    assert int(np.asarray(want.in_frustum).sum()) > 50
    for name in ("mean2d", "depth", "cov2d", "conic", "radius", "aa_factor", "in_frustum"):
        _close(getattr(got, name), getattr(want, name), name, rtol=1e-4, atol=1e-5)
    # the (scales, quats) form of the port agrees with the covariance form
    scales = np.exp(rng.uniform(-3, -1, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    from hidegs_tpu.core.transforms import build_covariance_3d

    jcov = build_covariance_3d(jnp.asarray(scales), jnp.asarray(quats))
    got = tewa.project_gaussians(_t(means), _t(np.asarray(jcov)), tcam_of(jcam))
    scq = tewa.project_gaussians_scq(_t(means), _t(scales), _t(quats), tcam_of(jcam))
    _close(got.conic, scq.conic, "cov form vs (scales, quats) form", rtol=1e-3, atol=1e-4)


def test_patch_offsets_match_jax():
    for h in (1, 2):
        _close(tgeom.patch_offsets(h), jgeom.patch_offsets(h), f"patch_offsets({h})", rtol=0)


def _tie_uv():
    """Samples on integer pixel centres, on pixel edges, on the border,
    just past it, far off, and at random."""
    rng = np.random.default_rng(4)
    centres = np.stack(np.meshgrid(np.arange(0, W) + 0.5, np.arange(0, H) + 0.5), -1).reshape(-1, 2)[::37]
    edges = np.stack(np.meshgrid(np.arange(0, W + 1, 7.0), np.arange(0, H + 1, 5.0)), -1).reshape(-1, 2)
    border = np.array([[0.5, 0.5], [W - 0.5, H - 0.5], [0.5, H - 0.5], [W - 0.5, 3.7], [0.4999, 2.0],
                       [W - 0.4999, 2.0], [3.0, -0.6], [3.0, H + 0.6], [-50.0, 3.0], [1e7, 5.0], [0.0, 0.0]])
    rand = rng.uniform(-2, W + 2, (60, 2))
    return np.concatenate([centres, edges, border, rand]).astype(np.float32)


@pytest.mark.parametrize("channels", [0, 3])
def test_bilinear_sample_values_and_gradients_at_ties(channels):
    """Values, the in-bounds mask, and gradients (image and coordinates) of
    a weighted sum, against jax.grad, at ties and at the border."""
    rng = np.random.default_rng(5)
    shape = (H, W) if channels == 0 else (H, W, channels)
    img = rng.uniform(-1, 1, shape).astype(np.float32)
    uv = _tie_uv()
    wts = rng.uniform(0.5, 1.5, (uv.shape[0],) + (() if channels == 0 else (channels,))).astype(np.float32)

    def jf(im, u):
        out, ok = jgeom.bilinear_sample(im, u)
        return jnp.sum(out * wts), (out, ok)

    (jv, (jout, jok)), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(jnp.asarray(img), jnp.asarray(uv))
    ti, tu = _t(img, True), _t(uv, True)
    tout, tok = tgeom.bilinear_sample(ti, tu)
    tg = torch.autograd.grad(torch.sum(tout * torch.tensor(wts)), [ti, tu])
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    _close(tout, jout, "values", rtol=0, atol=1e-6)
    _close(tg[0], jg[0], "image gradient", rtol=0, atol=1e-6)
    _close(tg[1], jg[1], "coordinate gradient", rtol=0, atol=1e-5)


def test_homography_and_warp_match_jax():
    rng = np.random.default_rng(6)
    jref, jsrc = _tilted_camera(7), _tilted_camera(8)
    n = rng.normal(size=(50, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = rng.uniform(-6, -1, 50).astype(np.float32)
    d[:3] = [0.0, 1e-9, -1e-9]  # the |d| < 1e-8 guard
    jH = jgeom.homography_from_plane(jnp.asarray(n), jnp.asarray(d), jref, jsrc)
    tH = tgeom.homography_from_plane(_t(n), _t(d), tcam_of(jref), tcam_of(jsrc))
    _close(tH, jH, "homography", rtol=1e-4, atol=1e-6 * float(np.abs(np.asarray(jH)).max()))
    uv = rng.uniform(0, W, (50, 9, 2)).astype(np.float32)
    Hm = np.asarray(jH)[3:, None]
    _close(tgeom.apply_homography(_t(Hm), _t(uv[3:])), jgeom.apply_homography(jnp.asarray(Hm), jnp.asarray(uv[3:])),
           "apply_homography", rtol=1e-4, atol=1e-4)
    # the guard on the homogeneous coordinate
    H0 = np.zeros((4, 3, 3), np.float32)
    H0[:, 0, 0] = H0[:, 1, 1] = 1.0
    H0[:, 2, 2] = [0.0, 1e-9, -1e-9, 1.0]
    _close(tgeom.apply_homography(_t(H0), _t(uv[0, :4])), jgeom.apply_homography(jnp.asarray(H0), jnp.asarray(uv[0, :4])),
           "apply_homography guard", rtol=1e-6)


# --------------------------------------------------------------------------
# the loss terms


@pytest.fixture(scope="module")
def problem():
    """tests/test_train.py's toy problem (make_problem(n=80, seed=3)): views
    of an 80-gaussian scene, and a state from jittered true points with gray
    colours, in both packages."""
    scene = jtoy(80, seed=3)
    cams = [jring_camera(i, n_cams=N_VIEWS, height=H, width=W) for i in range(N_VIEWS)]
    gts = [jrender(*scene, c, config=JRCFG)["render"] for c in cams]
    pts = scene.means3d + 0.01 * jax.random.normal(jax.random.PRNGKey(1), scene.means3d.shape)
    js = jinit(pts, jnp.full((80, 3), 0.5), capacity=128, knn_scale=jinitial_scales(pts), spatial_lr_scale=3.0)
    state = dict(
        params={f: np.asarray(getattr(js.params, f)) for f in FIELDS}, alive=np.asarray(js.alive),
        grad_max=np.asarray(js.grad_max), grad_abs_max=np.asarray(js.grad_abs_max),
        max_radii2d=np.asarray(js.max_radii2d), protected=np.asarray(js.protected),
        active_sh_degree=int(js.active_sh_degree), spatial_lr_scale=float(js.spatial_lr_scale))
    return dict(jcams=cams, jgts=gts, jstate=js, tcams=[tcam_of(c) for c in cams],
                tgts=[torch.tensor(np.asarray(g)) for g in gts], state=state)


def _tstate(problem):
    return convert.gaussian_state_from_jax(**problem["state"], device="cpu")


def test_multi_view_losses_match_jax(problem):
    """Both terms and their gradients (reference depth and normals, source
    depth) on the renders of the toy state, with JAX's draw as `uv`."""
    js = problem["jstate"]
    outs = [jrender(js.params.xyz, js.scales, js.quats, js.opacities, js.shs, c, render_geo=True, config=JRCFG)
            for c in problem["jcams"][:2]]
    ref, src = outs
    uv = _jax_uv(jax.random.PRNGKey(0), 512)
    gray_ref = jnp.mean(problem["jgts"][0], axis=0)
    gray_src = jnp.mean(problem["jgts"][1], axis=0)

    def jf(depth, normal, src_depth):
        mv = jgeo.MultiViewBatch(src_image_gray=gray_src, src_cam=problem["jcams"][1], src_plane_depth=src_depth)
        # multi_view_losses draws with k1 of split(rng): hand it the key _jax_uv used
        ncc, geo = jgeo.multi_view_losses(depth, normal, gray_ref, problem["jcams"][0], mv, jax.random.PRNGKey(0),
                                          num_samples=512)
        return ncc, geo

    arrays = [np.asarray(x) for x in (ref["plane_depth"], ref["rendered_normal"], src["plane_depth"])]
    jv, pull = jax.vjp(jax.jit(jf), *[jnp.asarray(a) for a in arrays])
    for term in (0, 1):
        jg = pull((jnp.float32(term == 0), jnp.float32(term == 1)))
        leaves = [_t(a, True) for a in arrays]
        mv = tgeo.MultiViewBatch(src_image_gray=_t(gray_src), src_cam=problem["tcams"][1], src_plane_depth=leaves[2])
        tv = tgeo.multi_view_losses(leaves[0], leaves[1], _t(gray_ref), problem["tcams"][0], mv, _t(uv))
        assert float(jv[term]) > 0, "the term is empty: the check would be vacuous"
        _close(tv[term], jv[term], f"term {term} value", rtol=1e-4)
        tg = torch.autograd.grad(tv[term], leaves, allow_unused=True)
        for name, a, b in zip(("plane_depth", "normal", "src_plane_depth"), tg, jg):
            if np.abs(np.asarray(b)).max() == 0:
                # the NCC term reaches the source depth only through masks
                assert a is None or float(a.abs().max()) == 0.0, f"term {term} {name}"
                continue
            _normalised_close(a, b, f"term {term} gradient {name}")
        if term == 1:
            assert np.abs(np.asarray(jg[2])).max() > 0, "the geometric term must reach the source depth"


def test_sample_pixels_range_and_determinism():
    gen = torch.Generator().manual_seed(3)
    uv = tgeo.sample_pixels(gen, 20_000, 48, 80, patch_half=2)
    assert uv.dtype == torch.float32 and uv.shape == (20_000, 2)
    assert float(uv[:, 0].min()) >= 3.0 and float(uv[:, 0].max()) < 77.0
    assert float(uv[:, 1].min()) >= 3.0 and float(uv[:, 1].max()) < 45.0
    again = tgeo.sample_pixels(torch.Generator().manual_seed(3), 20_000, 48, 80, patch_half=2)
    assert torch.equal(uv, again)


def _mv_cfgs(freq_warmup=10_000, single_view_weight=0.0):
    common = dict(iterations=100, freq_warmup=freq_warmup, single_view_weight=single_view_weight,
                  single_view_from=0, multi_view_from=0, multi_view_sample_num=256)
    return jl.TrainConfig(raster=JRCFG, **common), tl.TrainConfig(raster=TRCFG, **common)


def _port_grads(problem, tbatch, tcfg, uv):
    g = _tstate(problem)
    params = type(g.params)(*(p.detach().clone().requires_grad_(True) for p in g.params))
    total, aux = tl.compute_losses(g._replace(params=params), torch.zeros((1, 3, 4)), tbatch, torch.tensor(0),
                                   tcfg, torch.zeros((g.capacity, 2)), False, uv=uv)
    return total, aux, torch.autograd.grad(total, list(params), allow_unused=True)


def test_compute_losses_differentiable_source_matches_jax(problem):
    """tests/test_train.py:test_multi_view_differentiable_source_grads on
    both packages: every parameter gradient of compute_losses with the
    source view rendered inside the loss against jax.grad, and the
    detached-source gradients differ from it in both."""
    jcfg, tcfg = _mv_cfgs()
    js = problem["jstate"]
    src_depth = jrender(js.params.xyz, js.scales, js.quats, js.opacities, js.shs, problem["jcams"][1],
                        render_geo=True, config=JRCFG)["plane_depth"]
    uv = _t(_jax_uv(jax.random.PRNGKey(0), 256))
    gray = jnp.mean(problem["jgts"][1], axis=0)

    def jgrads(src):
        mv = jgeo.MultiViewBatch(src_image_gray=gray, src_plane_depth=src, src_cam=problem["jcams"][1])
        batch = jl.ViewBatch(cam=problem["jcams"][0], image=problem["jgts"][0], image_idx=jnp.int32(0),
                             multi_view=mv)

        def f(params):
            total, aux = jl.compute_losses(js._replace(params=params), jnp.zeros((1, 3, 4)), batch, 0,
                                           jax.random.PRNGKey(0), jcfg, jnp.zeros((js.capacity, 2)), False)
            return total, aux

        return jax.jit(jax.value_and_grad(f, has_aux=True))(js.params)

    def tgrads(src):
        mv = tgeo.MultiViewBatch(src_image_gray=_t(gray), src_plane_depth=src, src_cam=problem["tcams"][1])
        batch = tl.ViewBatch(cam=problem["tcams"][0], image=problem["tgts"][0], image_idx=torch.tensor(0),
                             multi_view=mv)
        return _port_grads(problem, batch, tcfg, uv)

    (jtot, jaux), jg = jgrads(None)
    ttot, taux, tg = tgrads(None)
    for key in ("total", "photo", "mv_ncc", "mv_geo"):
        _close(taux[key], jaux[key], key, rtol=1e-4)
    assert float(jaux["mv_ncc"]) > 0 and float(jaux["mv_geo"]) > 0
    for key in ("overflow", "num_instances", "num_visible"):
        assert int(taux[key]) == int(jaux[key]), key
    for f, a in zip(FIELDS, tg):
        b = getattr(jg, f)
        assert torch.isfinite(a).all(), f
        _normalised_close(a, b, f"gradient {f}")
    # the source render contributes gradient only on the differentiable path
    (_, _), jg_det = jgrads(jax.lax.stop_gradient(src_depth))
    _, _, tg_det = tgrads(_t(src_depth))
    assert np.abs(np.asarray(jg.xyz) - np.asarray(jg_det.xyz)).max() > 0
    assert float((tg[0] - tg_det[0]).abs().max()) > 0
    _normalised_close(tg_det[0], jg_det.xyz, "detached-source gradient xyz")


def _jstep_batch(problem, i, src, mv=True):
    part = None
    if mv:
        part = jgeo.MultiViewBatch(src_image_gray=jnp.mean(problem["jgts"][src], axis=0), src_cam=problem["jcams"][src])
    return jl.ViewBatch(cam=problem["jcams"][i], image=problem["jgts"][i], image_idx=jnp.int32(i), multi_view=part)


def _tstep_batch(problem, i, src, mv=True):
    part = None
    if mv:
        part = tgeo.MultiViewBatch(src_image_gray=torch.mean(problem["tgts"][src], dim=0),
                                   src_cam=problem["tcams"][src])
    return tl.ViewBatch(cam=problem["tcams"][i], image=problem["tgts"][i], image_idx=torch.tensor(i),
                        multi_view=part)


def _step_uv(jts, num_samples):
    """The draw of the JAX train step: step_rng of split(ts.rng), then
    multi_view_losses' k1 of split(step_rng)."""
    _, step_rng = jax.random.split(jts.rng)
    return _t(_jax_uv(step_rng, num_samples))


def _check_steps(runs, what):
    lr = tl.TrainConfig().lr
    leaf_lr = {"xyz": lr.position_lr_init * 3.0, "sh_dc": lr.feature_lr,
               "sh_rest": lr.feature_lr / lr.feature_rest_div, "scaling": lr.scaling_lr,
               "rotation": lr.rotation_lr, "opacity": lr.opacity_lr}
    for k, (jts, jm, tts, tm) in enumerate(runs):
        for key in jm:
            if key in ("overflow", "block_overflow", "num_instances", "num_visible", "visible_overflow"):
                assert int(tm[key]) == int(jm[key]), (what, k, key)
            elif key != "needed_blocks":
                np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-3, atol=1e-7,
                                           err_msg=f"{what} step {k} {key}")
    jts, _, tts, _ = runs[0]
    for f in FIELDS:  # the first step's gradients, through Adam's m = 0.1·g
        _normalised_close(getattr(tts.opt.m, f), getattr(jts.opt.m, f), f"{what} step-1 grad {f}")
    jts, _, tts, _ = runs[-1]
    for f in FIELDS:
        got, want = getattr(tts.gaussians.params, f).numpy(), np.asarray(getattr(jts.gaussians.params, f))
        m_steps = [np.abs(np.asarray(getattr(run[0].opt.m, f))) for run in runs]
        signal = np.all([m > 1e-1 * m.max() for m in m_steps], axis=0)
        still = np.all([m == 0 for m in m_steps], axis=0)
        np.testing.assert_allclose(got[signal], want[signal], rtol=0, atol=1e-2 * leaf_lr[f],
                                   err_msg=f"{what} param {f}")
        assert np.array_equal(got[still], want[still]), f"{what} param {f} moved without gradient"
    # the densification statistics: the screen-space gradient the terms
    # leave on the reference render's means, and the radii
    for f in ("grad_max", "grad_abs_max"):
        _normalised_close(getattr(tts.gaussians, f), getattr(jts.gaussians, f), f"{what} {f}", atol=1e-2)
    np.testing.assert_array_equal(tts.gaussians.max_radii2d.numpy(), np.asarray(jts.gaussians.max_radii2d))


def test_multi_view_train_steps_match_jax(problem):
    """Two train steps with the multi-view part (differentiable source) and
    every other term on, JAX's draws fed to the port."""
    jcfg, tcfg = _mv_cfgs(freq_warmup=0, single_view_weight=0.015)
    jts = jl.init_train_state(jax.tree.map(jnp.copy, problem["jstate"]), N_VIEWS)
    tts = tl.init_train_state(_tstate(problem), N_VIEWS)
    runs = []
    for k, (i, src) in enumerate(((0, 1), (2, 3))):
        uv = _step_uv(jts, tcfg.multi_view_sample_num)
        jts, jm = jl.train_step(jts, _jstep_batch(problem, i, src), jcfg)
        tts, tm = tl.train_step(tts, _tstep_batch(problem, i, src), tcfg, uv=uv)
        runs.append((jax.tree.map(np.asarray, jts), {k: np.asarray(v) for k, v in jm.items()}, tts, tm))
    assert all(float(run[3]["mv_geo"]) > 0 for run in runs) and any(float(run[3]["mv_ncc"]) > 0 for run in runs)
    _check_steps(runs, "multi-view")


def test_chunk_box_step_matches_jax(problem):
    """A train step with the chunk-AABB cull (C7): loss, gradients and the
    new state against JAX; the box tensors are built once per box and
    device."""
    box = ((-0.5, -1.0, -3.0), (1.5, 1.0, 3.0))
    jcfg = jl.TrainConfig(iterations=100, raster=JRCFG, freq_warmup=0, single_view_from=0, chunk_box=box)
    tcfg = tl.TrainConfig(iterations=100, raster=TRCFG, freq_warmup=0, single_view_from=0, chunk_box=box)
    jstate = problem["jstate"]
    prot = np.zeros(jstate.capacity, bool)
    prot[:5] = True  # protected rows are exempt from the box
    jstate = jstate._replace(protected=jnp.asarray(prot))
    state = dict(problem["state"], protected=prot)
    jts = jl.init_train_state(jax.tree.map(jnp.copy, jstate), N_VIEWS)
    tts = tl.init_train_state(convert.gaussian_state_from_jax(**state, device="cpu"), N_VIEWS)
    tl.chunk_box_tensors.cache_clear()
    runs = []
    for i in (0, 1):
        jts, jm = jl.train_step(jts, _jstep_batch(problem, i, 0, mv=False), jcfg)
        tts, tm = tl.train_step(tts, _tstep_batch(problem, i, 0, mv=False), tcfg)
        runs.append((jax.tree.map(np.asarray, jts), {k: np.asarray(v) for k, v in jm.items()}, tts, tm))
    # the box culls: fewer visible rows than without it
    full = tl.train_step(tl.init_train_state(convert.gaussian_state_from_jax(**state, device="cpu"), N_VIEWS),
                         _tstep_batch(problem, 0, 0, mv=False), dataclasses.replace(tcfg, chunk_box=None))[1]
    assert int(runs[0][1]["num_visible"]) < int(full["num_visible"])
    _check_steps(runs, "chunk box")
    info = tl.chunk_box_tensors.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    lo, hi = tl.chunk_box_tensors(box, torch.device("cpu"))
    assert lo.dtype == torch.float32 and lo.tolist() == [np.float32(v) for v in box[0]]
    assert hi.tolist() == [np.float32(v) for v in box[1]]
    assert tl.chunk_box_tensors(box, torch.device("cpu"))[0] is lo


def test_train_step_leaves_its_generator_and_repeats():
    """A multi-view step draws from a copy of the state's generator: the
    input state's generator does not move, two steps from one state are
    bitwise equal, and the new state carries the advanced generator."""
    from hidegs_tpu_torch.data.synthetic import make_toy_gaussians, ring_camera
    from hidegs_tpu_torch.model.gaussians import init_from_points

    scene = make_toy_gaussians(60, seed=1, device="cpu")
    cams = [ring_camera(i, n_cams=4, height=40, width=40, device="cpu") for i in range(2)]
    with torch.no_grad():
        gts = [trender(*scene, c, config=TRCFG)["render"] for c in cams]
    ts = tl.init_train_state(init_from_points(scene.means3d, torch.full((60, 3), 0.5), capacity=64), 2, seed=5)
    cfg = tl.TrainConfig(raster=TRCFG, multi_view_from=0, multi_view_sample_num=128)
    batch = tl.ViewBatch(cam=cams[0], image=gts[0], image_idx=torch.tensor(0), multi_view=tgeo.MultiViewBatch(
        src_image_gray=gts[1].mean(0), src_cam=cams[1]))
    before = ts.mv_generator.get_state()
    a, ma = tl.train_step(ts, batch, cfg)
    b, mb = tl.train_step(ts, batch, cfg)
    assert torch.equal(ts.mv_generator.get_state(), before)
    assert torch.equal(a.mv_generator.get_state(), b.mv_generator.get_state())
    assert not torch.equal(a.mv_generator.get_state(), before)
    for x, y in zip(a.gaussians.params, b.gaussians.params):
        assert torch.equal(x, y)
    assert float(ma["total"]) == float(mb["total"])
    # the draw of the step, by hand
    uv, _ = tl.draw_step_pixels(ts, batch, cfg)
    c, _ = tl.train_step(ts, batch, cfg, uv=uv)
    for x, y in zip(a.gaussians.params, c.gaussians.params):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="uv"):
        tl.step_forward(ts, batch, cfg)
