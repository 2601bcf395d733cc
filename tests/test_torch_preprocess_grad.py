"""The preprocess kernels' closed-form backward, held on the CPU.

`raster/preprocess.py:preprocess_plain_bwd` is the chain rule that the
kernel `preprocess_bwd` (csrc/preprocess.cu) computes, written term for
term in PyTorch. Here it is held, on the same numpy-seeded inputs and
cotangents:

  * against torch autograd of `preprocess_plain`, the plain forward the
    kernel `preprocess_fwd` follows: within 1e-5 of each leaf's max |grad|
    (float32 rounding in another order, nothing more);
  * against `jax.vjp` of the JAX package's `preprocess_gaussians`: within
    5e-3 of each leaf's max |grad|, the gradient tolerance of the JAX suite
    (tests/test_pallas.py);
  * on rows placed on the ties of the forward (the tangent clamp, the near
    plane, a zero covariance determinant, the radius clamp, argmin ties, a
    mean at the camera center, invisible rows with cotangents): against
    torch autograd only, whose rules at ties the kernel reproduces (the
    frameworks differ there, ROADMAP C4). NaN where autograd gives NaN.

Single-threaded, as the other CPU parity tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidegs_tpu.data.synthetic import ring_camera as jring_camera
from hidegs_tpu.raster import preprocess as jpp
from hidegs_tpu_torch.convert import camera_from_jax
from hidegs_tpu_torch.core.camera_math import make_camera
from hidegs_tpu_torch.raster import preprocess as tpp
from hidegs_tpu_torch.raster import preprocess_autograd
from hidegs_tpu_torch.raster.api import RasterConfig, render

torch.set_num_threads(1)

H, W = 64, 80
N = 240
FLOATS = ("mean2d", "conic", "depth", "inv_depth", "opacity", "rgb", "normal", "distance")
AUTOGRAD_TOL = 1e-5  # of each leaf's max |grad|
JAX_TOL = 5e-3  # of each leaf's max |grad| (tests/test_pallas.py)


def _inputs(seed, n=N, sh_layout="flat"):
    rng = np.random.default_rng(seed)
    x = dict(
        means3d=rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32),
        scales=np.exp(rng.uniform(np.log(0.01), np.log(0.3), (n, 3))).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(0.05, 0.95, n).astype(np.float32),
        shs=rng.normal(0, 0.4, (n, 16, 3)).astype(np.float32),
    )
    if sh_layout == "flat":
        x["shs"] = x["shs"].reshape(n, 48)
    return x


def _cotangents(seed, n, fields=FLOATS):
    rng = np.random.default_rng(seed)
    width = dict(mean2d=2, conic=3, rgb=3, normal=3)
    return {k: rng.normal(size=(n, width[k]) if k in width else (n,)).astype(np.float32) for k in fields}


def _ring_cams():
    jc = jring_camera(1, height=H, width=W)
    leaves = [np.asarray(v) for v in (jc.R, jc.t, jc.fx, jc.fy, jc.cx, jc.cy)]
    return jc, camera_from_jax(*leaves, H, W, device="cpu")


DIFF = ("means3d", "scales", "quats", "opacities", "shs", "colors_precomp", "mean2d_offset")

# name: (preprocess keywords, SH layout, cotangent fields)
CASES = {
    "geo0_aa0": (dict(render_geo=False, antialias=False), "flat", FLOATS),
    "geo0_aa1": (dict(render_geo=False, antialias=True), "flat", FLOATS),
    "geo1_aa0": (dict(render_geo=True, antialias=False), "flat", FLOATS),
    "geo1_aa1": (dict(render_geo=True, antialias=True), "flat", FLOATS),
    **{f"sh{d}_{layout}": (dict(render_geo=True, active_sh_degree=d), layout, FLOATS)
       for d in range(4) for layout in ("flat", "stacked")},
    "colors_precomp": (dict(render_geo=True, colors_precomp=True), "flat", FLOATS),
    "mean2d_offset": (dict(render_geo=True, mean2d_offset=True), "flat", FLOATS),
    "aabb_exempt": (dict(render_geo=True, box=True, screen_bounds=True), "flat", FLOATS),
    "some_cotangents": (dict(render_geo=True, mean2d_offset=True), "flat", ("conic", "opacity", "rgb")),
}


def _case(name, seed=0):
    kw, layout, fields = CASES[name]
    x = _inputs(seed, sh_layout=layout)
    kw = dict(kw)
    rng = np.random.default_rng(seed + 100)
    if kw.pop("colors_precomp", False):
        x["colors_precomp"] = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    if kw.pop("mean2d_offset", False):
        x["mean2d_offset"] = np.zeros((N, 2), np.float32)
    if kw.pop("box", False):
        kw["boxmin"] = np.array([-1.2, -1.0, -1.3], np.float32)
        kw["boxmax"] = np.array([1.1, 1.4, 1.0], np.float32)
        exempt = np.zeros(N, bool)
        exempt[::5] = True
        kw["box_exempt"] = exempt
    if kw.pop("screen_bounds", False):
        kw["screen_bounds"] = (W, H)
    return x, kw, _cotangents(seed + 200, N, fields)


def _torch_args(x, kw):
    """The inputs as tensors, and the keywords with colors_precomp and
    mean2d_offset among them when the case has them."""
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    for k in ("colors_precomp", "mean2d_offset"):
        if k in t:
            tkw[k] = t[k]
    return t, tkw


def _torch_call(x, kw, cam, fn):
    t, tkw = _torch_args(x, kw)
    return t, tkw, fn(t["means3d"], t["scales"], t["quats"], t["opacities"], t["shs"], cam, **tkw)


def _autograd(x, kw, cts, cam):
    t, tkw = _torch_args(x, kw)
    leaves = {k: v.clone().requires_grad_(True) for k, v in t.items()}
    for k in ("colors_precomp", "mean2d_offset"):
        if k in leaves:
            tkw[k] = leaves[k]
    pre = tpp.preprocess_plain(leaves["means3d"], leaves["scales"], leaves["quats"], leaves["opacities"],
                               leaves["shs"], cam, **tkw)
    loss = sum(torch.sum(getattr(pre, k) * torch.as_tensor(v)) for k, v in cts.items())
    loss.backward()
    return {k: v.grad for k, v in leaves.items() if v.grad is not None}, pre


def _closed_form(x, kw, cts, cam, visible):
    t, tkw = _torch_args(x, kw)
    for k in ("boxmin", "boxmax", "box_exempt", "screen_bounds"):
        tkw.pop(k, None)
    return tpp.preprocess_plain_bwd({k: torch.as_tensor(v) for k, v in cts.items()}, visible,
                                    t["means3d"], t["scales"], t["quats"], t["opacities"], t["shs"], cam, **tkw)


def _jax_vjp(x, kw, cts, jc):
    names = [k for k in DIFF if k in x]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}

    def f(*args):
        a = dict(zip(names, args))
        extra = {k: a[k] for k in ("colors_precomp", "mean2d_offset") if k in a}
        pre = jpp.preprocess_gaussians(a["means3d"], a["scales"], a["quats"], a["opacities"], a["shs"], jc,
                                       **jkw, **extra)
        return tuple(getattr(pre, k) for k in FLOATS)

    outs, vjp = jax.vjp(f, *[jnp.asarray(x[k]) for k in names])
    ct = tuple(jnp.asarray(cts[k]) if k in cts else jnp.zeros_like(o) for k, o in zip(FLOATS, outs))
    return dict(zip(names, (np.asarray(g) for g in vjp(ct))))


def _assert_grads_close(got, want, tol, what):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        g = np.asarray(got[k], np.float64)
        w = np.asarray(want[k], np.float64)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{what} {k}: NaN rows differ")
        finite = np.isfinite(w)
        scale = max(np.abs(w[finite]).max(), 1e-30)
        err = np.abs(g[finite] - w[finite]).max() / scale
        assert err <= tol, f"{what} {k}: {err:.3e} of the max |grad| (tolerance {tol})"


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_of_the_plain_forward(case):
    _, cam = _ring_cams()
    x, kw, cts = _case(case)
    want, pre = _autograd(x, kw, cts, cam)
    got = _closed_form(x, kw, cts, cam, pre.visible)
    _assert_grads_close({k: got[k] for k in want}, want, AUTOGRAD_TOL, case)
    # an input that autograd leaves without a gradient (no cotangent reaches
    # it) gets zeros
    assert set(want) <= set(got) and all(not got[k].any() for k in set(got) - set(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp(case):
    jc, cam = _ring_cams()
    x, kw, cts = _case(case)
    _, pre = _autograd(x, kw, cts, cam)
    got = _closed_form(x, kw, cts, cam, pre.visible)
    want = _jax_vjp(x, kw, cts, jc)
    if "colors_precomp" in x:
        want.pop("shs")  # JAX returns zeros for the unread coefficients
    _assert_grads_close({k: got[k] for k in want}, want, JAX_TOL, case)


def _tie_scene():
    """An axis-aligned camera (R = I, t = 0: camera coordinates are world
    coordinates, bit for bit) and rows placed on the forward's ties."""
    fx = 70.0
    cam = make_camera(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), fx, fx, W / 2, H / 2,
                      height=H, width=W, device="cpu")
    pack = tpp.camera_pack(cam)
    hix = float(pack[tpp.PACK_LIM + 1])
    loy = float(pack[tpp.PACK_LIM + 2])
    near = np.float32(tpp.NEAR_Z)
    rows = [
        # (mean, scales, quat)
        ((2 * hix, 0.1, 2.0), (0.05, 0.08, 0.1), (1.0, 0.2, -0.1, 0.3)),  # tangent clamp at +x
        ((0.1, 2 * loy, 2.0), (0.06, 0.05, 0.09), (0.9, -0.3, 0.1, 0.2)),  # tangent clamp at -y
        ((0.05, -0.04, near), (0.05, 0.07, 0.06), (1.0, 0.1, 0.2, 0.0)),  # on the near plane
        ((0.1, 0.1, 3.0), (0.3, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0)),  # det_raw = 0: aa = sqrt(0)
        ((0.0, 0.0, 2.5), (0.02, 0.02, 0.02), (1.0, 0.0, 0.0, 0.0)),  # mid² − det below the 0.1 clamp
        ((0.2, -0.1, 2.2), (0.1, 0.05, 0.05), (0.7, 0.1, -0.5, 0.2)),  # argmin tie: axes 1 and 2
        ((-0.2, 0.1, 2.4), (0.07, 0.07, 0.07), (0.3, 0.8, 0.1, -0.4)),  # argmin tie: all three
        ((0.0, 0.0, 0.0), (0.05, 0.06, 0.07), (1.0, 0.3, 0.2, 0.1)),  # mean at the camera center
        ((0.3, 0.2, -1.0), (0.05, 0.06, 0.07), (1.0, 0.3, 0.2, 0.1)),  # behind the camera: invisible
        ((4.0, 0.0, 1.0), (0.05, 0.06, 0.07), (1.0, 0.3, 0.2, 0.1)),  # off screen: invisible
    ]
    rng = np.random.default_rng(7)
    n = len(rows)
    x = dict(
        means3d=np.array([r[0] for r in rows], np.float32),
        scales=np.array([r[1] for r in rows], np.float32),
        quats=np.array([r[2] for r in rows], np.float32),
        opacities=rng.uniform(0.2, 0.9, n).astype(np.float32),
        shs=rng.normal(0, 0.4, (n, 48)).astype(np.float32),
    )
    x["means3d"][0, 0] = np.float32(2) * np.float32(hix)
    x["means3d"][1, 1] = np.float32(2) * np.float32(loy)
    return cam, x, _cotangents(8, n)


@pytest.mark.parametrize("antialias", [False, True])
def test_plain_backward_matches_autograd_on_the_ties(antialias):
    cam, x, cts = _tie_scene()
    kw = dict(render_geo=True, antialias=antialias, screen_bounds=(W, H))
    want, pre = _autograd(x, kw, cts, cam)
    # the rows sit on the ties they were placed on
    P = tpp.camera_pack(cam)
    m = torch.as_tensor(x["means3d"])
    assert float(m[0, 0] / m[0, 2]) == float(P[tpp.PACK_LIM + 1])
    assert float(m[1, 1] / m[1, 2]) == float(P[tpp.PACK_LIM + 2])
    assert float(m[2, 2]) == float(np.float32(tpp.NEAR_Z)) and not bool(pre.visible[2])
    assert not bool(pre.visible[8]) and not bool(pre.visible[9])
    got = _closed_form(x, kw, cts, cam, pre.visible)
    _assert_grads_close({k: got[k] for k in want}, want, AUTOGRAD_TOL, f"ties, antialias={antialias}")
    # autograd's sqrt at 0 gives NaN on the zero-determinant row exactly
    # when the antialias rescale is differentiated
    assert bool(torch.isnan(want["scales"][3]).any()) == antialias


def test_preprocess_on_cpu_runs_the_plain_path_and_launches_nothing():
    """On CPU tensors preprocess_gaussians is preprocess_plain under
    autograd (bitwise), renders go through it, and neither kernel's count
    moves."""
    jc, cam = _ring_cams()
    x, kw, cts = _case("geo1_aa1")
    preprocess_autograd.FWD_LAUNCHES = preprocess_autograd.BWD_LAUNCHES = 0
    t, tkw, got = _torch_call(x, kw, cam, tpp.preprocess_gaussians)
    _, _, want = _torch_call(x, kw, cam, tpp.preprocess_plain)
    for a, b in zip(got.tensors(), want.tensors()):
        assert torch.equal(a, b)
    leaves = {k: v.clone().requires_grad_(True) for k, v in t.items()}
    out = render(*(leaves[k] for k in ("means3d", "scales", "quats", "opacities", "shs")), cam, render_geo=True,
                 config=RasterConfig(backend="blend", tile=16, max_instances=1 << 14))
    (out["render"].sum() + out["rendered_distance"].sum()).backward()
    assert all(torch.isfinite(v.grad).all() for v in leaves.values())
    assert preprocess_autograd.FWD_LAUNCHES == 0 and preprocess_autograd.BWD_LAUNCHES == 0


def test_camera_pack_holds_what_the_plain_forward_reads():
    _, cam = _ring_cams()
    P = tpp.camera_pack(cam)
    assert P.dtype == torch.float32 and P.shape == (tpp.PACK_LEN,)
    assert torch.equal(P[tpp.PACK_R:tpp.PACK_R + 9], cam.R.reshape(9))
    assert torch.equal(P[tpp.PACK_T:tpp.PACK_T + 3], cam.t)
    assert torch.equal(P[tpp.PACK_F:tpp.PACK_F + 4], torch.stack([cam.fx, cam.fy, cam.cx, cam.cy]))
    lim = torch.div(cam.frustum_width, 2.0 * cam.fx)
    assert float(P[tpp.PACK_LIM + 1]) == float(1.3 * lim) == -float(P[tpp.PACK_LIM])
    assert torch.equal(P[tpp.PACK_CENTER:tpp.PACK_CENTER + 3], cam.camera_center)


def test_cuda_launchers_refuse_cpu_tensors():
    _, cam = _ring_cams()
    x = {k: torch.as_tensor(v) for k, v in _inputs(0).items()}
    with pytest.raises(ValueError, match="CUDA"):
        preprocess_autograd.preprocess_cuda(x["means3d"], x["scales"], x["quats"], x["opacities"], x["shs"], cam)
