"""Port parity of the blend's backward: the autograd Function of the "blend"
backend (on the CPU: the plain closed-form backward `blend_tiles_bwd` and
the plain fold) and autograd through the "plain" backend, against jax.grad
of the JAX package on its `jnp` backend and on its Pallas kernels in
interpret mode (the `mm` moment-matmul form, as tests/test_pallas.py runs it).

Tolerance: gradients normalised by the max |grad| of each input, atol 5e-3,
the JAX suite's own Pallas-vs-jnp gradient tolerance (tests/test_pallas.py).
The port's T_final differs from the JAX paths' near the 1e-4 cutoff (the
port sums log-transmittance in float64), and T_final·g_T enters every
instance's gradient through S; the tolerance absorbs that.

Also here: the autograd checks of the render path's core math (EWA
projection, SH, quaternion transforms, preprocess) against jax.grad, and the
fold's order (the CUDA fold kernel's) emulated on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hidegs_tpu.data.synthetic import make_toy_gaussians as jtoy
from hidegs_tpu.data.synthetic import ring_camera as jring_camera
from hidegs_tpu.raster import preprocess as jpp
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu.raster.api import render as jrender
from hidegs_tpu.raster.binning import bin_gaussians as jbin_gaussians
from hidegs_tpu.raster.binning import tile_grid as jtile_grid
from hidegs_tpu.raster.pallas_vjp import needed_blocks as jneeded_blocks
from hidegs_tpu_torch.convert import camera_from_jax
from hidegs_tpu_torch.raster import binning as tbin
from hidegs_tpu_torch.raster import blend_autograd, blend_plain
from hidegs_tpu_torch.raster import preprocess as tpp
from hidegs_tpu_torch.raster.api import RasterConfig, render

torch.set_num_threads(1)

GRAD_ATOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _cold_jax_caches():
    """Start and leave this module with JAX's compile caches empty.

    The Pallas kernels run here in interpret mode, whose io_callbacks
    dispatch JAX ops of their own. tests/test_pallas.py runs the same
    problems; when every op of its jax.grad is already compiled in the
    process, the eager backward runs ahead of the interpreted kernel and the
    two stall each other on the CPU client (seen under load in a worker
    that ran this module, then that one). Empty caches give each module
    the cold start it has alone."""
    jax.clear_caches()
    yield
    jax.clear_caches()
NAMES = ["means", "scales", "quats", "opac", "shs"]


def tcam_of(cam):
    leaves = [np.asarray(x) for x in (cam.R, cam.t, cam.fx, cam.fy, cam.cx, cam.cy)]
    return camera_from_jax(*leaves, cam.height, cam.width, cam.full_height, cam.full_width, device="cpu")


def assert_grads_close(got, want, atol=GRAD_ATOL):
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        assert np.isfinite(a).all(), name
        denom = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / denom, b / denom, atol=atol, err_msg=name)


def jax_grads(scene, cam, cfg, bg=None):
    def f(*args):
        out = jrender(*args, cam, background=bg, config=cfg)
        return jnp.mean(out["render"] ** 2)

    if cfg.backend == "pallas":
        with pltpu.force_tpu_interpret_mode():
            return jax.grad(f, argnums=(0, 1, 2, 3, 4))(*scene)
    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(*scene)


def torch_grads(scene, tcam, cfg, bg=None):
    leaves = [torch.tensor(np.asarray(x)).requires_grad_(True) for x in scene]
    out = render(*leaves, tcam, background=bg, config=cfg)
    torch.mean(out["render"] ** 2).backward()
    return [x.grad.numpy() for x in leaves]


@pytest.fixture(scope="module")
def tile32():
    """tests/test_pallas.py:65-90's problem at tile 32: jax.grad on the jnp
    backend and on the Pallas kernels (mm=True), computed once."""
    scene = jtoy(120, seed=1)
    cam = jring_camera(0, height=48, width=48)
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    ref = {
        backend: jax_grads(scene, cam, JConfig(backend=backend, max_instances=1 << 13, tile=32, mm_geom=True),
                           bg=jnp.asarray(bg))
        for backend in ("jnp", "pallas")
    }
    return scene, tcam_of(cam), torch.tensor(bg), ref


@pytest.mark.parametrize("jax_backend", ["jnp", "pallas"])
@pytest.mark.parametrize("backend", ["blend", "plain"])
def test_gradients_match_jax(tile32, backend, jax_backend):
    scene, tcam, bg, ref = tile32
    got = torch_grads(scene, tcam, RasterConfig(backend=backend, max_instances=1 << 13, tile=32), bg=bg)
    assert_grads_close(got, ref[jax_backend])


@pytest.mark.parametrize(
    "scenario,max_instances,blocks_frac",
    [
        ("ample", 1 << 13, 0.0),
        ("truncated_blocks", 1 << 13, 0.5),
        # the toy scene wants 601 instances; 512 forces a full stream
        ("saturated_instances", 1 << 9, 0.0),
    ],
)
def test_budget_scenarios_match_pallas(scenario, max_instances, blocks_frac):
    """The scenarios of tests/test_pallas.py:186-195 (tile 16): a truncated
    block budget (tiles past it render empty and get no gradient) and a
    saturated instance budget (the last instance's row must reach its
    gaussian). The Function against the Pallas kernels and against autograd
    through the plain backend."""
    scene = jtoy(400, seed=3)
    cam = jring_camera(0, height=48, width=64)
    ty, tx = jtile_grid(cam.height, cam.width)
    jtb = jbin_gaussians(jpp.preprocess_gaussians(*scene, cam), ty, tx, max_instances)
    max_blocks = int(int(jneeded_blocks(jtb.tile_count)) * blocks_frac)
    if scenario == "saturated_instances":
        assert int(jtb.overflow) > 0, "scenario must exercise a full instance stream"
    ref = jax_grads(scene, cam, JConfig(backend="pallas", max_instances=max_instances,
                                        max_blocks=max_blocks, mm_geom=True, grad_reduce="scatter"))
    tcam = tcam_of(cam)
    kw = dict(max_instances=max_instances, max_blocks=max_blocks)
    got = torch_grads(scene, tcam, RasterConfig(backend="blend", **kw))
    plain = torch_grads(scene, tcam, RasterConfig(backend="plain", **kw))
    assert_grads_close(got, ref)
    assert_grads_close(got, plain)


def _binned(seed=2, tile=16, n=300, h=48, w=64, max_instances=1 << 12):
    js = jtoy(n, seed=seed)
    jc = jring_camera(1, height=h, width=w)
    scene = [torch.tensor(np.asarray(x)) for x in js]
    ty, tx = tbin.tile_grid(h, w, tile)
    pre = tpp.preprocess_gaussians(*scene, tcam_of(jc), render_geo=True, screen_bounds=(tx * tile, ty * tile))
    return pre, tbin.bin_gaussians(pre, ty, tx, max_instances, tile), ty, tx


def test_backward_is_bitwise_reproducible():
    pre, tb, ty, tx = _binned()
    attrs = blend_plain.pack_gaussian_attrs(pre).requires_grad_(True)
    g = torch.randn((ty * tx, 256, blend_plain.OUT_CH), generator=torch.Generator().manual_seed(0))
    runs = []
    for _ in range(2):
        tile_out, _ = blend_autograd.BlendPacked.apply(attrs, tb, ty, tx, 16, 0)
        (d,) = torch.autograd.grad(tile_out, attrs, g)
        runs.append(d)
    assert torch.equal(runs[0], runs[1])
    assert float(runs[0].abs().sum()) > 0


def test_plain_backward_matches_autograd_of_plain_forward(monkeypatch):
    """The closed form of blend_tiles_bwd against autograd through the plain
    forward on the same packed rows, with random cotangents on every plane
    (rgb, invdepth, normal, distance, alpha, T_final) and a tile group size
    that splits the stream."""
    pre, tb, ty, tx = _binned(seed=4)
    monkeypatch.setattr(blend_plain, "GROUP_INSTANCES", 24)
    attrs = blend_plain.pack_gaussian_attrs(pre).requires_grad_(True)
    tile_out, _ = blend_plain.blend_tile_out(blend_plain.unpack_attrs(attrs), tb, ty, tx, 16)
    g = torch.randn(tile_out.shape, generator=torch.Generator().manual_seed(1))
    g[..., 10:] = 0.0
    (want,) = torch.autograd.grad(tile_out, attrs, g)
    g_aug = blend_plain.augment_cotangents(tile_out.detach(), g)
    view = blend_plain.unpack_attrs(attrs.detach())
    rows = blend_plain.blend_tiles_bwd(view, tb, g_aug, ty, tx, 16)
    got = blend_plain.fold_rows(blend_plain.expansion_rows(rows, tb.slot_s), tb.g_start)
    for c in range(blend_plain.GRAD_COLS):
        denom = float(want[:, c].abs().max()) + 1e-8
        torch.testing.assert_close(got[:, c] / denom, want[:, c] / denom, atol=GRAD_ATOL, rtol=0)
    assert torch.equal(got[:, blend_plain.GRAD_COLS:], torch.zeros_like(got[:, blend_plain.GRAD_COLS:]))


def test_fold_kernel_order_matches_plain_fold():
    """The fold kernel sums each gaussian's span [g_start[g], g_start[g+1])
    of the expansion-order rows in slot order; emulated here in float32, it
    equals the plain fold (a segment sum over the same spans) to the bit, on
    a stream whose instance budget is saturated."""
    pre, tb, _, _ = _binned(max_instances=256)
    assert int(tb.overflow) > 0
    N = pre.mean2d.shape[0]
    rows = torch.randn((tb.gauss_id.shape[0], blend_plain.ATTR), generator=torch.Generator().manual_seed(2))
    rows_exp = blend_plain.expansion_rows(rows, tb.slot_s)
    want = blend_plain.fold_rows(rows_exp, tb.g_start)
    g_start = tb.g_start.tolist()
    got = torch.zeros((N, blend_plain.ATTR))
    for gi in range(N):
        acc = torch.zeros(blend_plain.ATTR)
        for j in range(g_start[gi], g_start[gi + 1]):
            acc = acc + rows_exp[j]
        got[gi] = acc
    assert torch.equal(got, want)
    # every sorted row reaches the expansion slot slot_s names
    assert torch.equal(rows_exp[tb.slot_s.long()], rows)


def test_preprocess_autograd_matches_jax():
    """Autograd through EWA projection, SH evaluation (degree 3, with a view
    direction per gaussian), the quaternion math and the planar-geometry
    channels, against jax.grad of the same weighted sum of the
    preprocessed outputs."""
    js = jtoy(200, seed=7)
    rng = np.random.default_rng(0)
    shs = np.asarray(js.shs).copy()
    shs[:, 1:, :] = rng.normal(0, 0.2, shs[:, 1:, :].shape).astype(np.float32)
    quats = rng.normal(size=(200, 4)).astype(np.float32)  # unnormalized
    scene = [np.asarray(js.means3d), np.asarray(js.scales), quats, np.asarray(js.opacities), shs]
    jc = jring_camera(2, height=56, width=72)
    weights = {k: rng.normal(size=s).astype(np.float32) for k, s in
               [("mean2d", (200, 2)), ("conic", (200, 3)), ("opacity", (200,)), ("rgb", (200, 3)),
                ("normal", (200, 3)), ("distance", (200,)), ("inv_depth", (200,))]}

    def jf(*args):
        pre = jpp.preprocess_gaussians(*args, jc, render_geo=True, screen_bounds=(80, 64))
        return sum(jnp.sum(getattr(pre, k) * jnp.asarray(w)) for k, w in weights.items())

    want = jax.grad(jf, argnums=(0, 1, 2, 3, 4))(*[jnp.asarray(x) for x in scene])
    leaves = [torch.tensor(x).requires_grad_(True) for x in scene]
    pre = tpp.preprocess_gaussians(*leaves, tcam_of(jc), render_geo=True, screen_bounds=(80, 64))
    total = sum(torch.sum(getattr(pre, k) * torch.tensor(w)) for k, w in weights.items())
    total.backward()
    for name, x, w in zip(NAMES, leaves, want):
        w = np.asarray(w)
        denom = np.abs(w).max() + 1e-8
        np.testing.assert_allclose(x.grad.numpy() / denom, w / denom, atol=1e-4, err_msg=name)
