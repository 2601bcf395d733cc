"""The CUDA blend kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither jax nor the JAX package, so it also
runs where JAX is absent:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: forward planes atol 3e-4 / rtol 1e-3 and `out_observe` equal
(the JAX suite's Pallas-vs-plain tolerance); the backward kernel's
per-gaussian gradients against the plain backward on the same inputs,
normalised by the max |grad| of each attribute, atol 1e-5 (the two differ
only in the order of their float32 sums); gradients through a whole render
or train step, where the forward planes already differ by up to 1e-4,
normalised atol 1e-3; the fold kernel against the plain fold in float64
within the rounding bound of a float32 sum, k·2^-24·Σ|row| for k rows.
"""
import pytest
import torch

from hidegs_tpu_torch.data.synthetic import make_blend_boundary_scene, make_toy_gaussians, ring_camera
from hidegs_tpu_torch.raster import binning as tbin
from hidegs_tpu_torch.raster import blend_autograd, blend_plain, cuda_blend
from hidegs_tpu_torch.raster import preprocess as tpp
from hidegs_tpu_torch.raster.api import RasterConfig, render

# the JAX suite's tolerance between its Pallas kernel and its plain blend
BLEND_TOL = dict(atol=3e-4, rtol=1e-3)
GRAD_NORM_TOL = 1e-5
STEP_GRAD_TOL = 1e-3
PLANES = ["render", "invdepth", "alpha", "T_final", "normal", "distance"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _binned(dev, tile, n=300, h=72, w=96, max_instances=1 << 14):
    scene = make_toy_gaussians(n, seed=3, device=dev)
    cam = ring_camera(0, height=h, width=w, device=dev)
    ty, tx = tbin.tile_grid(h, w, tile)
    pre = tpp.preprocess_gaussians(*scene, cam, render_geo=True, screen_bounds=(tx * tile, ty * tile))
    return pre, tbin.bin_gaussians(pre, ty, tx, max_instances, tile), ty, tx


def _assert_grads_close(got, want, what):
    for c in range(blend_plain.GRAD_COLS):
        scale = float(want[:, c].abs().max()) + 1e-8
        err = float((got[:, c] - want[:, c]).abs().max()) / scale
        assert err <= GRAD_NORM_TOL, f"{what}: column {c} normalised err {err:.3e}"


def _assert_fold_within_rounding(rows_exp, g_start, got):
    want = blend_plain.fold_rows(rows_exp.double(), g_start)
    k = torch.diff(g_start.long()).double()[:, None]
    bound = k * 2.0 ** -24 * blend_plain.fold_rows(rows_exp.double().abs(), g_start)
    assert bool(((got.double() - want).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("max_blocks", [0, 3])
def test_kernel_matches_plain(cuda, tile, max_blocks):
    pre, tb, ty, tx = _binned(cuda, tile)
    before = cuda_blend.LAUNCHES
    k = blend_autograd.blend_tiles(pre, tb, ty, tx, tile, max_blocks)
    torch.cuda.synchronize()
    assert cuda_blend.LAUNCHES == before + 1
    p = blend_plain.blend_tiles(pre, tb, ty, tx, tile, max_blocks)
    for key in PLANES:
        torch.testing.assert_close(k[key], p[key], **BLEND_TOL)
    assert torch.equal(k["out_observe"], p["out_observe"])


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("max_blocks", [0, 3])
def test_backward_kernel_matches_plain(cuda, tile, max_blocks):
    pre, tb, ty, tx = _binned(cuda, tile)
    attrs = blend_plain.pack_gaussian_attrs(pre)
    count = cuda_blend.visited_count(tb, max_blocks)
    tile_out, _ = cuda_blend.blend_tile_out(attrs, tb, count, ty, tx, tile)
    gen = torch.Generator(device=cuda).manual_seed(tile + max_blocks)
    g = torch.randn(tile_out.shape, generator=gen, device=cuda)
    g_aug = blend_plain.augment_cotangents(tile_out, g)
    before = (cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES)
    rows = cuda_blend.instance_rows(attrs, tb, count, g_aug, tx, tile)
    got = cuda_blend.fold(rows, tb, attrs.shape[0])
    torch.cuda.synchronize()
    assert (cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    view = blend_plain.unpack_attrs(attrs)
    plain_rows = blend_plain.blend_tiles_bwd(view, tb, g_aug, ty, tx, tile, max_blocks)
    want = blend_plain.fold_rows(blend_plain.expansion_rows(plain_rows, tb.slot_s), tb.g_start)
    _assert_grads_close(got, want, f"tile {tile} max_blocks {max_blocks}")
    # the fold kernel against the plain fold on the same rows
    _assert_fold_within_rounding(blend_plain.expansion_rows(rows, tb.slot_s), tb.g_start, got)
    # bitwise reproducible
    again = cuda_blend.grad_attrs(attrs, tb, count, g_aug, tx, tile)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("max_blocks", [0, 3])
def test_kernels_on_the_mask_boundary_scene(cuda, tile, max_blocks):
    """Level sets that end on the kernels' 8x4 mask blocks (corners, edges,
    thin and near-singular conics, op at 1/255 and near 1): the forward
    against the plain blend with out_observe equal, the backward and fold
    against the plain versions, and two launches of each bitwise equal."""
    h, w = 64, 96
    pre = make_blend_boundary_scene(height=h, width=w, seed=7, device=cuda)
    ty, tx = tbin.tile_grid(h, w, tile)
    tb = tbin.bin_gaussians(pre, ty, tx, 1 << 16, tile)
    k = blend_autograd.blend_tiles(pre, tb, ty, tx, tile, max_blocks)
    again = blend_autograd.blend_tiles(pre, tb, ty, tx, tile, max_blocks)
    p = blend_plain.blend_tiles(pre, tb, ty, tx, tile, max_blocks)
    for key in PLANES:
        torch.testing.assert_close(k[key], p[key], **BLEND_TOL)
    for key in k:
        assert torch.equal(k[key], again[key]), key
    assert torch.equal(k["out_observe"], p["out_observe"])

    attrs = blend_plain.pack_gaussian_attrs(pre)
    count = cuda_blend.visited_count(tb, max_blocks)
    tile_out, _ = cuda_blend.blend_tile_out(attrs, tb, count, ty, tx, tile)
    gen = torch.Generator(device=cuda).manual_seed(tile + max_blocks)
    g = torch.randn(tile_out.shape, generator=gen, device=cuda)
    g_aug = blend_plain.augment_cotangents(tile_out, g)
    rows = cuda_blend.instance_rows(attrs, tb, count, g_aug, tx, tile)
    got = cuda_blend.fold(rows, tb, attrs.shape[0])
    plain_rows = blend_plain.blend_tiles_bwd(blend_plain.unpack_attrs(attrs), tb, g_aug, ty, tx, tile, max_blocks)
    want = blend_plain.fold_rows(blend_plain.expansion_rows(plain_rows, tb.slot_s), tb.g_start)
    _assert_grads_close(got, want, f"boundary scene, tile {tile} max_blocks {max_blocks}")
    _assert_fold_within_rounding(blend_plain.expansion_rows(rows, tb.slot_s), tb.g_start, got)
    assert torch.equal(cuda_blend.instance_rows(attrs, tb, count, g_aug, tx, tile), rows)
    assert torch.equal(cuda_blend.grad_attrs(attrs, tb, count, g_aug, tx, tile), got)


@pytest.mark.cuda
def test_render_blend_is_deterministic_and_matches_plain(cuda):
    scene = make_toy_gaussians(400, seed=4, device=cuda)
    cam = ring_camera(2, height=80, width=112, device=cuda)
    cfg = RasterConfig(tile=32, max_instances=1 << 14, depth_sort_bits=-1)
    a = render(*scene, cam, render_geo=True, config=cfg)
    b = render(*scene, cam, render_geo=True, config=cfg)
    p = render(*scene, cam, render_geo=True, config=RasterConfig(
        backend="plain", tile=32, max_instances=1 << 14, depth_sort_bits=-1))
    for key in a:
        assert torch.equal(a[key], b[key]), key
    for key in ["render", "invdepth", "alpha", "T_final", "rendered_normal", "rendered_distance"]:
        torch.testing.assert_close(a[key], p[key], **BLEND_TOL)
    assert torch.equal(a["out_observe"], p["out_observe"])


@pytest.mark.cuda
def test_render_gradients_come_from_the_kernels(cuda):
    scene = make_toy_gaussians(300, seed=6, device=cuda)
    cam = ring_camera(1, height=64, width=96, device=cuda)

    def grads(backend):
        leaves = [x.clone().requires_grad_(True) for x in scene]
        out = render(*leaves, cam, render_geo=True, config=RasterConfig(
            backend=backend, tile=16, max_instances=1 << 14))
        loss = out["render"].square().mean() + 0.1 * out["rendered_normal"].abs().mean()
        return torch.autograd.grad(loss, leaves)

    before = cuda_blend.BWD_LAUNCHES
    k1 = grads("blend")
    k2 = grads("blend")
    assert cuda_blend.BWD_LAUNCHES == before + 2
    p = grads("plain")
    for a, b, c in zip(k1, k2, p):
        assert torch.equal(a, b)
        scale = float(c.abs().max()) + 1e-8
        assert float((a - c).abs().max()) / scale <= STEP_GRAD_TOL


@pytest.mark.cuda
def test_launcher_validates_inputs(cuda):
    pre, tb, ty, tx = _binned(cuda, 16)
    attrs = blend_plain.pack_gaussian_attrs(pre)
    T = ty * tx
    out = torch.empty((T, 256, cuda_blend.OUT_CH), device=cuda)
    obs = torch.zeros_like(tb.gauss_id)
    args = [attrs, tb.gauss_id, tb.tile_start, tb.tile_count, tx, 16, out, obs]
    with pytest.raises(ValueError, match="dtype"):
        cuda_blend.launch_blend_fwd(attrs.double(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        cuda_blend.launch_blend_fwd(*args[:6], out[:, :128], obs)
    with pytest.raises(ValueError, match="tile"):
        cuda_blend.launch_blend_fwd(*args[:5], 8, out, obs)
    cuda_blend.launch_blend_fwd(*args)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_backward_launchers_validate_inputs(cuda):
    pre, tb, ty, tx = _binned(cuda, 16)
    attrs = blend_plain.pack_gaussian_attrs(pre)
    T, I, N = ty * tx, tb.gauss_id.shape[0], attrs.shape[0]
    g_aug = torch.zeros((T, 256, cuda_blend.OUT_CH), device=cuda)
    rows = torch.zeros((I, cuda_blend.ATTR), device=cuda)
    args = [attrs, tb.gauss_id, tb.tile_start, tb.tile_count, tx, 16, g_aug, rows]
    with pytest.raises(ValueError, match="shape"):
        cuda_blend.launch_blend_bwd(*args[:6], g_aug[:, :128], rows)
    with pytest.raises(ValueError, match="shape"):
        cuda_blend.launch_blend_bwd(*args[:7], rows[:-1])
    with pytest.raises(ValueError, match="dtype"):
        cuda_blend.launch_blend_bwd(*args[:7], rows.double())
    with pytest.raises(ValueError, match="tile"):
        cuda_blend.launch_blend_bwd(*args[:5], 8, g_aug, rows)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_blend.launch_blend_bwd(attrs.cpu(), *args[1:])
    cuda_blend.launch_blend_bwd(*args)
    out = torch.empty((N, cuda_blend.ATTR), device=cuda)
    with pytest.raises(ValueError, match="shape"):
        cuda_blend.launch_fold_rows(rows, tb.g_start[:-1], out)
    with pytest.raises(ValueError, match="dtype"):
        cuda_blend.launch_fold_rows(rows, tb.g_start.long(), out)
    cuda_blend.launch_fold_rows(rows, tb.g_start, out)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


def _train_problem(dev, n=200, hw=64):
    from hidegs_tpu_torch.model.gaussians import init_from_points
    from hidegs_tpu_torch.model.knn import initial_scales
    from hidegs_tpu_torch.train import loop as tl

    rcfg = RasterConfig(tile=16, max_instances=1 << 15)
    scene = make_toy_gaussians(n, seed=8, device=dev)
    cams = [ring_camera(i, n_cams=4, height=hw, width=hw, device=dev) for i in range(4)]
    with torch.no_grad():
        gts = [render(*scene, c, config=rcfg)["render"] for c in cams]
    pts = scene.means3d + 0.01 * torch.randn(scene.means3d.shape, generator=torch.Generator().manual_seed(1)).to(dev)
    state = init_from_points(pts, torch.full((n, 3), 0.5, device=dev), capacity=256,
                             knn_scale=initial_scales(pts), spatial_lr_scale=3.0)
    cfg = tl.TrainConfig(iterations=100, raster=rcfg, freq_warmup=0, single_view_from=0)
    batches = [tl.ViewBatch(cam=c, image=g, image_idx=torch.tensor(i, device=dev))
               for i, (c, g) in enumerate(zip(cams, gts))]
    return tl.init_train_state(state, 4), batches, cfg


def _leaves(ts):
    return (list(ts.gaussians.params) + list(ts.opt.m) + list(ts.opt.v)
            + [ts.opt.step, ts.gaussians.grad_max, ts.gaussians.grad_abs_max, ts.gaussians.max_radii2d])


@pytest.mark.cuda
def test_train_step_is_bitwise_deterministic(cuda):
    from hidegs_tpu_torch.train import loop as tl

    ts, batches, cfg = _train_problem(cuda)
    before = cuda_blend.BWD_LAUNCHES
    a, ma = tl.train_step(ts, batches[0], cfg)
    b, mb = tl.train_step(ts, batches[0], cfg)
    torch.cuda.synchronize()
    assert cuda_blend.BWD_LAUNCHES == before + 2
    assert float(ma["step_ok"]) == 1.0
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)
    assert torch.equal(ma["total"], mb["total"])


@pytest.mark.cuda
def test_train_steps_blend_match_plain(cuda):
    """Three steps with the kernels against three with the plain backend:
    losses at rtol 1e-3, first-step gradients (Adam's m = 0.1·g) normalised
    at 1e-3 (tests/test_torch_train.py states why later steps are looser)."""
    import dataclasses

    from hidegs_tpu_torch.train import loop as tl

    ts, batches, cfg = _train_problem(cuda)
    pcfg = dataclasses.replace(cfg, raster=dataclasses.replace(cfg.raster, backend="plain"))
    k, p = ts, ts
    for step in range(3):
        k, mk = tl.train_step(k, batches[step], cfg)
        p, mp = tl.train_step(p, batches[step], pcfg)
        torch.testing.assert_close(mk["total"], mp["total"], rtol=1e-3, atol=0)
        if step == 0:
            for a, b in zip(k.opt.m, p.opt.m):
                scale = float(b.abs().max()) + 1e-30
                assert float((a - b).abs().max()) / scale <= STEP_GRAD_TOL
    assert float(mk["step_ok"]) == 1.0
