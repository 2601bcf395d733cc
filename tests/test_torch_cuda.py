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
within the rounding bound of a float32 sum, k·2^-24·Σ|row| for k rows, and
bitwise against the scalar fold it replaced (tools/csrc/fold_rows_scalar.cu,
fed by a scatter of sorted-instance rows into expansion order). The
multi-view step (two blends forward and backward) is bitwise reproducible
and makes no host synchronisation with the chunk box set. The compiled
train step (train/compiled.py) is bitwise the eager step in each of its
variants, replays with no host sync, keeps an old graph across a new
key's capture, and runs the trainer (visible-row compaction included)
with no sync in a step that captures nothing. The post-opt
step of the hierarchy (train/hier_trainer.py) holds the same way, and
the pipeline runs on the card end to end. The compiled serving render
(raster/compiled.py) is bitwise the eager render in the serve
configuration and the render cell's, replays with no host sync, and is
what evaluate, render_cli and the viewers render through; the KNN scale
init makes no host sync.
"""
import dataclasses
import pathlib

import numpy as np
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


def _scalar_fold(rows_exp, g_start, num_gaussians):
    """The scalar fold of tools/csrc/fold_rows_scalar.cu on expansion-order rows."""
    src = pathlib.Path(__file__).resolve().parents[1] / "tools" / "csrc" / "fold_rows_scalar.cu"
    fn = cuda_blend.bind(cuda_blend.build({"fold_rows_scalar": src})["fold_rows_scalar"],
                         "hidegs_fold_rows_scalar", 2, 1, 0, 2)
    out = torch.empty((num_gaussians, cuda_blend.ATTR), device=rows_exp.device)
    rc = fn(rows_exp.data_ptr(), g_start.data_ptr(), num_gaussians, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return out


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


def _observe_scene(dev, case, tile, h=72, w=96):
    """A scene and its binning over an instance budget 8x the demand (the
    padding instances carry gauss_id N); "opaque": 3000 large splats at
    opacity 0.99, whose tiles saturate early."""
    if case == "opaque":
        scene = make_toy_gaussians(3000, seed=5, scale_range=(0.15, 0.4), device=dev)
        scene = scene._replace(opacities=torch.full_like(scene.opacities, 0.99))
    else:
        scene = make_toy_gaussians(300, seed=3, device=dev)
    cam = ring_camera(0, height=h, width=w, device=dev)
    ty, tx = tbin.tile_grid(h, w, tile)
    pre = tpp.preprocess_gaussians(*scene, cam, render_geo=True, screen_bounds=(tx * tile, ty * tile))
    demand = int(tbin.bin_gaussians(pre, ty, tx, 1 << 18, tile).num_instances)
    return pre, tbin.bin_gaussians(pre, ty, tx, 8 * demand, tile), ty, tx


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["slack", "max_blocks", "opaque"])
def test_kernel_sums_observe_per_gaussian(cuda, case, mode, tile):
    """The forward kernel adds each visited instance's observe count to its
    gaussian's row itself (integer atomics, no fold after it): with most of
    the instance budget padding, with max_blocks cutting tiles off, and on
    a scene whose CTAs stop early, out_observe is bitwise the plain blend's
    and bitwise equal between two launches, in both row modes."""
    pre, tb, ty, tx = _observe_scene(cuda, case, tile)
    I, N = tb.gauss_id.shape[0], pre.mean2d.shape[0]
    bf16 = mode == "bf16"
    max_blocks = 3 if case == "max_blocks" else 0
    assert int((tb.gauss_id == N).sum()) >= 7 * I // 8
    view = blend_plain.unpack_attrs(blend_plain.pack_gaussian_attrs(pre))
    if case == "max_blocks":
        visited = blend_plain.visited_tiles(tb.tile_count, I, max_blocks)
        assert bool((~visited & (tb.tile_count > 0)).any())
    if case == "opaque":  # some tile is opaque within the kernel's first batch of 256 (kBatch) and has more
        first = dataclasses.replace(tb, tile_count=tb.tile_count.clamp(max=256))
        t_final = blend_plain.blend_tile_out(view, first, ty, tx, tile, 0, bf16)[0][..., 9]
        assert bool(((t_final < 1e-4).all(dim=1) & (tb.tile_count > 256)).any())
    attrs = blend_plain.pack_gaussian_attrs(pre)
    rows = blend_plain.bf16_rows(attrs) if bf16 else attrs
    count = cuda_blend.visited_count(tb, max_blocks)
    _, observe = cuda_blend.blend_tile_out(rows, tb, count, ty, tx, tile)
    _, again = cuda_blend.blend_tile_out(rows, tb, count, ty, tx, tile)
    _, want = blend_plain.blend_tile_out(view, tb, ty, tx, tile, max_blocks, bf16)
    assert observe.dtype == torch.int32 and observe.shape == (N,)
    assert int(want.sum()) > 0
    assert torch.equal(observe, want)
    assert torch.equal(again, observe)


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
    rows_exp = cuda_blend.instance_rows(attrs, tb, count, g_aug, tx, tile)
    got = cuda_blend.fold(rows_exp, tb, attrs.shape[0])
    torch.cuda.synchronize()
    assert (cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    view = blend_plain.unpack_attrs(attrs)
    plain_rows = blend_plain.blend_tiles_bwd(view, tb, g_aug, ty, tx, tile, max_blocks)
    want = blend_plain.fold_rows(blend_plain.expansion_rows(plain_rows, tb.slot_s), tb.g_start)
    _assert_grads_close(got, want, f"tile {tile} max_blocks {max_blocks}")
    # the fold kernel against the plain fold on the same rows
    _assert_fold_within_rounding(rows_exp, tb.g_start, got)
    assert torch.equal(got, blend_plain.fold_rows(rows_exp, tb.g_start))
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
    rows_exp = cuda_blend.instance_rows(attrs, tb, count, g_aug, tx, tile)
    got = cuda_blend.fold(rows_exp, tb, attrs.shape[0])
    plain_rows = blend_plain.blend_tiles_bwd(blend_plain.unpack_attrs(attrs), tb, g_aug, ty, tx, tile, max_blocks)
    want = blend_plain.fold_rows(blend_plain.expansion_rows(plain_rows, tb.slot_s), tb.g_start)
    _assert_grads_close(got, want, f"boundary scene, tile {tile} max_blocks {max_blocks}")
    _assert_fold_within_rounding(rows_exp, tb.g_start, got)
    assert torch.equal(cuda_blend.instance_rows(attrs, tb, count, g_aug, tx, tile), rows_exp)
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
    obs = torch.zeros((attrs.shape[0],), dtype=torch.int32, device=cuda)  # per gaussian
    assert tb.gauss_id.shape[0] != attrs.shape[0]
    args = [attrs, tb.gauss_id, tb.tile_start, tb.tile_count, tx, 16, out, obs]
    with pytest.raises(ValueError, match="dtype"):
        cuda_blend.launch_blend_fwd(attrs.double(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        cuda_blend.launch_blend_fwd(*args[:6], out[:, :128], obs)
    with pytest.raises(ValueError, match="shape"):  # one count per instance is the old layout
        cuda_blend.launch_blend_fwd(*args[:7], torch.zeros_like(tb.gauss_id))
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
    args = [attrs, tb.gauss_id, tb.tile_start, tb.tile_count, tx, 16, tb.slot_s, g_aug, rows]
    with pytest.raises(ValueError, match="shape"):
        cuda_blend.launch_blend_bwd(*args[:7], g_aug[:, :128], rows)
    with pytest.raises(ValueError, match="shape"):
        cuda_blend.launch_blend_bwd(*args[:8], rows[:-1])
    with pytest.raises(ValueError, match="dtype"):
        cuda_blend.launch_blend_bwd(*args[:8], rows.double())
    with pytest.raises(ValueError, match="tile"):
        cuda_blend.launch_blend_bwd(*args[:5], 8, *args[6:])
    with pytest.raises(ValueError, match="slot_s"):
        cuda_blend.launch_blend_bwd(*args[:6], tb.slot_s[:-1], g_aug, rows)
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


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["toy", "boundary"])
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("truncated", [False, True])
def test_fold_is_bitwise_the_scalar_fold_path(cuda, scene, tile, truncated):
    """The gradient of the blend (the backward kernel writing expansion
    order, then the fold kernel) against the path it replaced: the backward
    kernel writing one row per sorted instance (an identity slot_s stores
    row k at k, the earlier kernel's layout), those rows scattered by
    blend_plain.expansion_rows and summed by the scalar fold. Bitwise, with
    and without a too-small max_blocks, and two runs bitwise equal."""
    if scene == "toy":
        pre, tb, ty, tx = _binned(cuda, tile)
    else:
        pre = make_blend_boundary_scene(height=64, width=96, seed=7, device=cuda)
        ty, tx = tbin.tile_grid(64, 96, tile)
        tb = tbin.bin_gaussians(pre, ty, tx, 1 << 16, tile)
    max_blocks = max(int(blend_plain.needed_blocks(tb.tile_count)) // 2, 1) if truncated else 0
    attrs = blend_plain.pack_gaussian_attrs(pre)
    count = cuda_blend.visited_count(tb, max_blocks)
    tile_out, _ = cuda_blend.blend_tile_out(attrs, tb, count, ty, tx, tile)
    g = torch.randn(tile_out.shape, generator=torch.Generator(device=cuda).manual_seed(tile), device=cuda)
    g_aug = blend_plain.augment_cotangents(tile_out, g)
    got = cuda_blend.grad_attrs(attrs, tb, count, g_aug, tx, tile)
    I = tb.gauss_id.shape[0]
    sorted_rows = torch.zeros((I, cuda_blend.ATTR), device=cuda)
    identity = torch.arange(I, dtype=torch.int32, device=cuda)
    cuda_blend.launch_blend_bwd(attrs, tb.gauss_id.contiguous(), tb.tile_start.contiguous(), count, tx, tile,
                                identity, g_aug, sorted_rows)
    want = _scalar_fold(blend_plain.expansion_rows(sorted_rows, tb.slot_s), tb.g_start, attrs.shape[0])
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)
    assert torch.equal(cuda_blend.grad_attrs(attrs, tb, count, g_aug, tx, tile), got)


@pytest.mark.cuda
def test_fold_spans_at_the_edges(cuda):
    """Empty spans, a span cut at the budget (g_start clamped to I), the last
    gaussian's span and one longer than the unrolled loop, on a count of
    gaussians that is not a multiple of a warp's 8: the fold kernel equals
    the plain fold bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    I = 40
    lengths = torch.tensor([0, 3, 0, 0, 9, 1, 0, 2, 0, 5, 0, 13, 4, 0, 6], device=cuda)
    starts = torch.cat([torch.zeros(1, dtype=torch.long, device=cuda), torch.cumsum(lengths, 0)])
    g_start = torch.clamp(starts, max=I).to(torch.int32)  # the spans run past I = 40 at the end
    rows_exp = torch.randn((I, cuda_blend.ATTR), generator=gen, device=cuda)
    N = lengths.numel()
    out = torch.empty((N, cuda_blend.ATTR), device=cuda)
    cuda_blend.launch_fold_rows(rows_exp, g_start, out)
    assert torch.equal(out, blend_plain.fold_rows(rows_exp, g_start))
    assert torch.equal(out[lengths == 0], torch.zeros_like(out[lengths == 0]))


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


def _multi_view_batch(batches, i, src):
    from hidegs_tpu_torch.train import loop as tl
    from hidegs_tpu_torch.train.geometric import MultiViewBatch

    return tl.ViewBatch(cam=batches[i].cam, image=batches[i].image, image_idx=batches[i].image_idx,
                        multi_view=MultiViewBatch(src_image_gray=batches[src].image.mean(0),
                                                  src_cam=batches[src].cam))


def _counts():
    return (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES)


@pytest.mark.cuda
def test_multi_view_step_is_bitwise_deterministic(cuda):
    """A step with the multi-view part renders the source view in the loss:
    two forward, backward and fold launches, and two steps from one state
    (one generator state) bitwise equal."""
    import dataclasses

    from hidegs_tpu_torch.train import loop as tl

    ts, batches, cfg = _train_problem(cuda)
    cfg = dataclasses.replace(cfg, multi_view_from=0, multi_view_sample_num=2048)
    batch = _multi_view_batch(batches, 0, 1)
    before = _counts()
    a, ma = tl.train_step(ts, batch, cfg)
    b, mb = tl.train_step(ts, batch, cfg)
    torch.cuda.synchronize()
    assert tuple(x - y for x, y in zip(_counts(), before)) == (4, 4, 4)
    assert float(ma["step_ok"]) == 1.0 and float(ma["mv_geo"]) > 0
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)
    assert torch.equal(ma["total"], mb["total"])
    assert torch.equal(a.mv_generator.get_state(), b.mv_generator.get_state())


@pytest.mark.cuda
def test_bilinear_sample_gradient_is_deterministic(cuda):
    """The image gradient of bilinear_sample with many samples per pixel
    (its backward is a sorted index_put_) is bitwise reproducible."""
    from hidegs_tpu_torch.core.geometry import bilinear_sample

    gen = torch.Generator(device=cuda).manual_seed(2)
    img = torch.rand((64, 80, 3), generator=gen, device=cuda).requires_grad_(True)
    uv = torch.rand((200_000, 2), generator=gen, device=cuda) * torch.tensor([12.0, 9.0], device=cuda) + 3.0
    w = torch.randn((200_000, 3), generator=gen, device=cuda)
    grads = []
    for _ in range(3):
        out, _ = bilinear_sample(img, uv)
        grads.append(torch.autograd.grad(torch.sum(out * w), img)[0])
    assert float(grads[0].abs().sum()) > 0
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])
    # and equal, up to float32 summation order, to the CPU's
    img_cpu = img.detach().cpu().requires_grad_(True)
    cpu = torch.autograd.grad(torch.sum(bilinear_sample(img_cpu, uv.cpu())[0] * w.cpu()), img_cpu)[0]
    torch.testing.assert_close(grads[0].cpu(), cpu, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_multi_view_steps_blend_match_plain(cuda):
    """Two multi-view steps with the kernels against two with the plain
    backend, on the same pixel draws: losses at rtol 1e-3, first-step
    gradients normalised at 1e-3."""
    import dataclasses

    from hidegs_tpu_torch.train import loop as tl

    ts, batches, cfg = _train_problem(cuda)
    cfg = dataclasses.replace(cfg, multi_view_from=0, multi_view_sample_num=2048)
    pcfg = dataclasses.replace(cfg, raster=dataclasses.replace(cfg.raster, backend="plain"))
    k, p = ts, ts
    for step, (i, src) in enumerate(((0, 1), (2, 3))):
        batch = _multi_view_batch(batches, i, src)
        k, mk = tl.train_step(k, batch, cfg)
        p, mp = tl.train_step(p, batch, pcfg)
        for key in ("total", "mv_ncc", "mv_geo"):
            torch.testing.assert_close(mk[key], mp[key], rtol=1e-3, atol=1e-6)
        if step == 0:
            for a, b in zip(k.opt.m, p.opt.m):
                scale = float(b.abs().max()) + 1e-30
                assert float((a - b).abs().max()) / scale <= STEP_GRAD_TOL
    assert float(mk["step_ok"]) == 1.0


@pytest.mark.cuda
def test_chunk_box_multi_view_step_makes_no_host_sync(cuda):
    """A train step with the chunk box and the multi-view part (the source
    render in the loss) under torch.cuda.set_sync_debug_mode("error"): no
    host-to-device copy, no read of a device value, no synchronisation."""
    import dataclasses

    from hidegs_tpu_torch.train import loop as tl

    ts, batches, cfg = _train_problem(cuda)
    cfg = dataclasses.replace(cfg, multi_view_from=0, multi_view_sample_num=2048,
                              chunk_box=((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5)))
    batch = _multi_view_batch(batches, 0, 1)
    ts, _ = tl.train_step(ts, batch, cfg)  # builds the kernels, the box and the loss constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new_ts, metrics = tl.train_step(ts, batch, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(metrics["step_ok"]) == 1.0 and float(metrics["mv_geo"]) > 0
    assert int(new_ts.step) == int(ts.step) + 1


# ---------------------------------------------------------------------------
# the compiled train step (train/compiled.py): one CUDA graph per static key


def _compiled_variant(dev, variant):
    """(state, config, use_exposure, row_budget, the K = 3 batches) of a
    variant of the compiled-step tests."""
    import dataclasses

    ts, batches, cfg = _train_problem(dev)
    mv = dataclasses.replace(cfg, multi_view_from=0, multi_view_sample_num=2048)
    compact = dataclasses.replace(cfg, raster=dataclasses.replace(cfg.raster, max_visible=160))
    return {
        "single-view": (ts, cfg, False, 0, batches[:3]),
        "multi-view": (ts, mv, False, 0, [_multi_view_batch(batches, i, s) for i, s in ((0, 1), (2, 3), (1, 2))]),
        "exposure": (ts, cfg, True, 0, [batches[2], batches[0], batches[2]]),
        "row budget": (ts, cfg, False, 224, [batches[0], batches[3], batches[1]]),
        "compaction": (ts, compact, False, 0, batches[1:4]),
    }[variant]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["single-view", "multi-view", "exposure", "row budget", "compaction"])
def test_compiled_step_is_bitwise_the_eager_step(cuda, variant):
    """Three replays against three eager train steps from one state: every
    tensor of the state and every metric bitwise equal (the multi-view
    samples drawn outside the graph from the state's generator, which
    advances alike); the returned state is the step's own buffers; one
    capture; each replay adds the graph's launches (1 or 2 of each render
    kernel, one masked Adam) to REPLAY_LAUNCHES and none to the launchers' counters."""
    from hidegs_tpu_torch.train import compiled
    from hidegs_tpu_torch.train import loop as tl
    from hidegs_tpu_torch.utils import graphs

    ts, cfg, use_exposure, row_budget, batches = _compiled_variant(cuda, variant)
    step = compiled.CompiledTrainStep()
    eager, comp = ts, ts
    per_step = 2 if batches[0].multi_view is not None else 1
    ptrs = None
    for k, batch in enumerate(batches):
        eager, em = tl.train_step(eager, batch, cfg, use_exposure, row_budget)
        replays = dict(graphs.REPLAY_LAUNCHES)
        counts = _counts()
        comp, cm = step(comp, batch, cfg, use_exposure, row_budget)
        torch.cuda.synchronize()
        if k > 0:
            assert _counts() == counts, "a replay went through the launchers"
        assert {n: graphs.REPLAY_LAUNCHES[n] - replays[n] for n in replays} == dict(
            dict.fromkeys(graphs.KERNELS, per_step), masked_adam=1)
        for n, (a, b) in enumerate(zip(graphs._tensors(comp), graphs._tensors(eager), strict=True)):
            assert torch.equal(a, b), f"{variant} step {k}: tensor {n} of the state"
        assert em.keys() == cm.keys() and all(torch.equal(em[m], cm[m]) for m in em), variant
        assert torch.equal(comp.mv_generator.get_state(), eager.mv_generator.get_state())
        now = [x.data_ptr() for x in graphs._tensors(comp)]
        assert ptrs is None or now == ptrs, "the replay returned other buffers"
        ptrs = now
    assert float(cm["step_ok"]) == 1.0 and len(step.captures) == 1 and step.replays == 3
    assert step.captures[0]["launches"] == dict(dict.fromkeys(graphs.KERNELS, per_step), masked_adam=1)
    if variant == "compaction":
        assert int(cm["num_visible"]) > 0 and int(cm["visible_overflow"]) >= 0
    if variant == "multi-view":
        assert float(cm["mv_geo"]) > 0


@pytest.mark.cuda
def test_compiled_replay_makes_no_host_sync(cuda):
    """After the capture, steady replays of a multi-view step (the samples
    drawn before each replay) under set_sync_debug_mode("error")."""
    from hidegs_tpu_torch.train import compiled

    ts, cfg, _, _, batches = _compiled_variant(cuda, "multi-view")
    step = compiled.CompiledTrainStep()
    ts, _ = step(ts, batches[0], cfg)  # warm-up and capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch in (batches[0], batches[1], batches[0]):
            ts, metrics = step(ts, batch, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(metrics["step_ok"]) == 1.0 and int(ts.step) == 4 and len(step.captures) == 1


@pytest.mark.cuda
def test_a_key_change_recaptures_and_keeps_the_old_graph(cuda):
    """A new instance budget captures a second graph in the shared pool;
    replaying the first graph afterwards still gives the eager step bitwise,
    and so does the second."""
    import dataclasses

    from hidegs_tpu_torch.train import compiled
    from hidegs_tpu_torch.train import loop as tl
    from hidegs_tpu_torch.utils import graphs

    ts, batches, cfg = _train_problem(cuda)
    wide = dataclasses.replace(cfg, raster=dataclasses.replace(cfg.raster, max_instances=2 * cfg.raster.max_instances))
    step = compiled.CompiledTrainStep()
    s, _ = step(ts, batches[0], cfg)
    s, _ = step(s, batches[1], wide)
    assert len(step.captures) == 2
    for c, batch in ((cfg, batches[2]), (wide, batches[3])):
        e, em = tl.train_step(ts, batch, c)
        k, km = step(ts, batch, c)  # a state of the caller's: copied in
        for n, (a, b) in enumerate(zip(graphs._tensors(k), graphs._tensors(e), strict=True)):
            assert torch.equal(a, b), f"max_instances {c.raster.max_instances}: tensor {n}"
        assert all(torch.equal(em[m], km[m]) for m in em)
    assert len(step.captures) == 2 and step.replays == 4


@pytest.mark.cuda
def test_trainer_with_visible_compaction_makes_no_host_sync_per_step(cuda, tmp_path, monkeypatch, capsys):
    """The trainer on the card runs the compiled step; once its first
    window turns visible-row compaction on, a step that captures nothing
    makes no host sync (compact_visible has static shapes). The toy scene's
    dead rows sit at the origin, in view, so the trainer's own policy never
    finds that compaction pays here: the budget is fixed at 1024 of the
    2048 rows."""
    import warnings

    from hidegs_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from hidegs_tpu_torch.train import budgets, compiled, trainer
    from torch_scenes import write_two_cluster_scene

    src = write_two_cluster_scene(tmp_path / "scene")
    steps = []

    class Watched(compiled.CompiledTrainStep):
        def __call__(self, ts, batch, cfg, *args, **kwargs):
            captured = len(self.captures)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out = super().__call__(ts, batch, cfg, *args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            steps.append((cfg.raster.max_visible, len(self.captures) > captured,
                          [str(w.message) for w in caught if "synchroniz" in str(w.message)]))
            return out

    monkeypatch.setattr(budgets, "fit_visible_budget", lambda peak, rows: 1024 if peak > 0 else 0)
    monkeypatch.setattr(trainer, "CompiledTrainStep", Watched)
    opt = OptimizationConfig(iterations=24, densify_from_iter=1000, freq_warmup_iterations=0,
                             single_view_weight_from_iter=0, multi_view_weight_from_iter=1000)
    ts = trainer.train(ModelConfig(source_path=src), PipelineConfig(capacity=2048, max_instances=1 << 12),
                       opt, save_iterations=(), log_every=1000, device="cuda")
    assert "enabling visible-row compaction" in capsys.readouterr().out
    assert len(steps) == 24 and ts.gaussians.alive.device.type == "cuda"
    compacted = [s for s in steps if s[0] > 0]
    assert compacted and any(captured for _, captured, _ in compacted)
    for i, (max_visible, captured, syncs) in enumerate(steps):
        if not captured:
            assert not syncs, f"iteration {i + 1} (max_visible {max_visible}) synchronised: {syncs}"


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("scene", ["toy", "mask boundary"])
def test_bf16_kernels_match_plain_bf16(cuda, tile, scene):
    """The bf16 stream (blend_plain.bf16_rows) through both kernels against
    the plain bf16 versions on the same rows, at the float32 gates: planes
    at the blend tolerance with out_observe equal, per-gaussian gradients
    within 1e-5 of the max, the fold bitwise; one launch of each."""
    if scene == "toy":
        pre, tb, ty, tx = _binned(cuda, tile)
    else:
        pre = make_blend_boundary_scene(height=64, width=96, seed=7, device=cuda)
        ty, tx = tbin.tile_grid(64, 96, tile)
        tb = tbin.bin_gaussians(pre, ty, tx, 1 << 16, tile)
    attrs = blend_plain.pack_gaussian_attrs(pre)
    rows = blend_plain.bf16_rows(attrs)
    count = cuda_blend.visited_count(tb, 0)
    before = (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES)
    tile_out, observe = cuda_blend.blend_tile_out(rows, tb, count, ty, tx, tile)
    p_out, p_obs = blend_plain.blend_tile_out(blend_plain.unpack_attrs(attrs), tb, ty, tx, tile, 0, bf16=True)
    torch.testing.assert_close(tile_out, p_out, **BLEND_TOL)
    assert torch.equal(observe, p_obs)
    f32_out, _ = cuda_blend.blend_tile_out(attrs, tb, count, ty, tx, tile)
    assert not torch.equal(f32_out, tile_out)  # the rows really were rounded
    g = torch.randn(tile_out.shape, generator=torch.Generator(device=cuda).manual_seed(tile), device=cuda)
    g[..., 10:] = 0.0
    g_aug = blend_plain.augment_cotangents(tile_out, g)
    got = cuda_blend.grad_attrs(rows, tb, count, g_aug, tx, tile)
    torch.cuda.synchronize()
    assert (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES) == (
        before[0] + 2, before[1] + 1, before[2] + 1)
    plain_rows = blend_plain.blend_tiles_bwd(blend_plain.unpack_attrs(attrs), tb, g_aug, ty, tx, tile, 0, bf16=True)
    want = blend_plain.fold_rows(blend_plain.expansion_rows(plain_rows, tb.slot_s), tb.g_start)
    _assert_grads_close(got, want, f"bf16 {scene} tile {tile}")
    assert torch.equal(cuda_blend.grad_attrs(rows, tb, count, g_aug, tx, tile), got)


def _blend_node(root):
    """The BlendPackedBackward node of an autograd graph."""
    seen, stack = set(), [root]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "BlendPackedBackward":
            return node
        stack.extend(fn for fn, _ in node.next_functions)
    raise AssertionError("no BlendPackedBackward node in the graph")


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
def test_bf16_stream_render_and_backward_run_the_bf16_kernels(cuda, tile, monkeypatch):
    """RasterConfig(bf16_stream=True) through render() and its backward on
    the card: one launch of each kernel; the blend node saves bf16_rows of
    the packed rows; its planes and d_attrs hold against the plain bf16
    versions on its own binning and cotangents, and are bitwise what the
    launchers give."""
    scene = make_toy_gaussians(300, seed=6, device=cuda)
    cam = ring_camera(1, height=64, width=96, device=cuda)
    leaves = [x.clone().requires_grad_(True) for x in scene]
    kept, got = {}, {}
    real = blend_autograd.blend_tiles

    def keep(*args, **kwargs):
        res = real(*args, **kwargs)
        kept.update(args=args, planes=res)
        return res

    monkeypatch.setattr(blend_autograd, "blend_tiles", keep)
    before = (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES)
    out = render(*leaves, cam, render_geo=True,
                 config=RasterConfig(tile=tile, max_instances=1 << 14, bf16_stream=True))
    node = _blend_node(out["render"].grad_fn)
    node.register_prehook(lambda go: got.update(saved=[x.detach() for x in node.saved_tensors],
                                                g=go[0].contiguous()))
    node.register_hook(lambda gi, go: got.update(d_attrs=gi[0]))
    (out["render"].square().mean() + 0.1 * out["rendered_normal"].abs().mean()).backward()
    torch.cuda.synchronize()
    assert (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    pre, tb, ty, tx, _, max_blocks, bf16 = kept["args"]
    assert bf16
    attrs = blend_plain.pack_gaussian_attrs(pre).detach()
    rows, tile_out = got["saved"]
    # bitwise: columns 0:4 carry the float32 mean2d's bytes, which may read as bf16 NaNs
    assert rows.dtype == torch.bfloat16
    assert torch.equal(rows.view(torch.int16), blend_plain.bf16_rows(attrs).view(torch.int16))
    observe = kept["planes"]["out_observe"]
    p_out, p_obs = blend_plain.blend_tile_out(blend_plain.unpack_attrs(attrs), tb, ty, tx, tile, max_blocks,
                                              bf16=True)
    torch.testing.assert_close(tile_out, p_out, **BLEND_TOL)
    assert torch.equal(observe, p_obs)
    count = cuda_blend.visited_count(tb, max_blocks)
    k_out, k_obs = cuda_blend.blend_tile_out(rows, tb, count, ty, tx, tile)
    assert torch.equal(k_out, tile_out) and torch.equal(k_obs, observe)
    g_aug = blend_plain.augment_cotangents(tile_out, got["g"])
    assert torch.equal(got["d_attrs"], cuda_blend.grad_attrs(rows, tb, count, g_aug, tx, tile))
    plain_rows = blend_plain.blend_tiles_bwd(blend_plain.unpack_attrs(attrs), tb, g_aug, ty, tx, tile, max_blocks,
                                             bf16=True)
    want = blend_plain.fold_rows(blend_plain.expansion_rows(plain_rows, tb.slot_s), tb.g_start)
    _assert_grads_close(got["d_attrs"], want, f"bf16 render() tile {tile}")


def _replays():
    from hidegs_tpu_torch.utils import graphs

    return tuple(graphs.REPLAY_LAUNCHES[k] for k in graphs.ALL_KERNELS)


def _lod_problem(dev, n=2000):
    """A built hierarchy of a toy scene (native builder) and a 96x128 view."""
    from hidegs_tpu_torch.hier.build import build_hierarchy

    scene = make_toy_gaussians(n, seed=5, device="cpu")
    h = build_hierarchy(*(x.numpy() for x in (scene.means3d, scene.quats, scene.scales, scene.opacities,
                                                scene.shs)), use_native=True)
    return h, ring_camera(0, height=96, width=128, device=dev)


def _eager_renderer(h, dev):
    """An AdaptiveHierRenderer that calls the eager fused_lod_frame."""
    from hidegs_tpu_torch.hier.interp import AdaptiveHierRenderer

    r = AdaptiveHierRenderer.from_hierarchy(h, dev)
    r.compiled = None
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["eager", "compiled"])
def test_lod_frame_kernel_holds_against_plain(cuda, mode):
    """One AdaptiveHierRenderer frame of a built hierarchy on the card: one
    forward launch per frame, and the same frame again bitwise equal. Eager
    (the renderer's `compiled` None): the frame's tile planes against the plain blend on
    the frame's own rows and binning. Compiled (the default on a card): the
    first frame warms up (one launch through the launcher) and captures,
    every frame is a replay that adds the graph's one launch to
    REPLAY_LAUNCHES, and the frames are bitwise the eager renderer's."""
    from hidegs_tpu_torch.hier.interp import AdaptiveHierRenderer

    h, cam = _lod_problem(cuda)
    if mode == "compiled":
        r = AdaptiveHierRenderer.from_hierarchy(h, cuda)
        eager = _eager_renderer(h, cuda)
        before, replays = _counts(), _replays()
        with torch.no_grad():
            out = {k: v.clone() for k, v in r.render(cam, 2.0).items()}
            again = r.render(cam, 2.0)
            want = eager.render(cam, 2.0)
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(replays, _replays())) == (2, 0, 0, 2, 0, 0)
        assert cuda_blend.LAUNCHES == before[0] + 1 + 1  # the warm-up's and the eager frame's
        assert len(r.compiled.captures) == 1 and r.compiled.replays == 2 and int(out["overflow"]) == 0
        for key in out:
            assert torch.equal(out[key], again[key]) and torch.equal(out[key], want[key]), key
        return
    r = _eager_renderer(h, cuda)
    kept = {}
    real = blend_autograd.blend_tiles

    def keep(*args, **kwargs):
        res = real(*args, **kwargs)
        kept.update(args=args, planes=res)
        return res

    blend_autograd.blend_tiles = keep
    try:
        before = cuda_blend.LAUNCHES
        with torch.no_grad():
            out = r.render(cam, 2.0)
            again = r.render(cam, 2.0)
        assert cuda_blend.LAUNCHES == before + 2 and int(out["overflow"]) == 0
    finally:
        blend_autograd.blend_tiles = real
    pre, tb, ty, tx, tile, max_blocks, _ = kept["args"]
    p = blend_plain.blend_tiles(pre, tb, ty, tx, tile, max_blocks)
    for key in PLANES:
        torch.testing.assert_close(kept["planes"][key], p[key], **BLEND_TOL)
    assert torch.equal(kept["planes"]["out_observe"], p["out_observe"])
    for key in out:
        assert torch.equal(out[key], again[key]), key


@pytest.mark.cuda
def test_compiled_lod_frames_are_bitwise_the_eager_frames(cuda):
    """The compiled renderer against the eager one, frame by frame at τ = 0
    and 6 on two views and back (count-cache hits and misses, the budgets
    of both renderers alike): every key of every frame bitwise equal, the
    frames cloned before the next render; one replay per frame."""
    from hidegs_tpu_torch.hier.interp import AdaptiveHierRenderer

    h, cam0 = _lod_problem(cuda)
    cams = [cam0, ring_camera(1, height=96, width=128, device=cuda)]
    r = AdaptiveHierRenderer.from_hierarchy(h, cuda)
    e = _eager_renderer(h, cuda)
    replays = _replays()
    n = 0
    with torch.no_grad():
        for tau in (0.0, 6.0, 0.0):
            for cam in cams:
                got = {k: v.clone() for k, v in r.render(cam, tau).items()}
                want = e.render(cam, tau)
                n += 1
                assert (r._budget, r._max_inst) == (e._budget, e._max_inst)
                for key in want:
                    assert torch.equal(got[key], want[key]), (tau, key)
    torch.cuda.synchronize()
    assert _replays()[0] - replays[0] == n == r.compiled.replays
    keys = [(c["budget"], c["max_instances"]) for c in r.compiled.captures]
    assert len(set(keys)) == len(keys), keys  # one capture per budget pair


@pytest.mark.cuda
def test_a_new_lod_budget_captures_a_new_key_and_keeps_the_old_graph(cuda):
    """A second cut budget captures a second frame graph in the shared
    pool; replaying the first afterwards still gives the eager frame
    bitwise, and so does the second."""
    from hidegs_tpu_torch.hier.interp import CompiledLodFrame, fused_lod_frame

    h, cam = _lod_problem(cuda)
    r = _eager_renderer(h, cuda)
    frame = CompiledLodFrame()
    args = dict(num_points=r.num_points, config=RasterConfig(max_instances=1 << 15), attrs=r._attrs)
    cams = [ring_camera(i, n_cams=6, height=96, width=128, device=cuda) for i in range(3)]
    with torch.no_grad():
        for budget, c in ((1 << 12, cams[0]), (1 << 13, cams[1]), (1 << 12, cams[2]), (1 << 13, cams[0])):
            target = r.target_size(c, 2.0)
            got = frame(r._packed, target, c, *r.arrays, budget=budget, **args)
            want = fused_lod_frame(r._packed, target, c, *r.arrays, budget=budget, **args)
            assert int(got["num_selected"]) > 0
            for key in want:
                assert torch.equal(got[key], want[key]), (budget, key)
    assert [c["budget"] for c in frame.captures] == [1 << 12, 1 << 13] and frame.replays == 4


@pytest.mark.cuda
def test_compiled_lod_frame_replay_makes_no_host_sync(cuda):
    """After the capture, replays of the frame (other cameras, a tensor
    target) under set_sync_debug_mode("error"); a frame of another
    hierarchy's arrays is refused, on the captured key and on a new one."""
    from hidegs_tpu_torch.hier.interp import CompiledLodFrame

    h, cam = _lod_problem(cuda)
    r = _eager_renderer(h, cuda)
    frame = CompiledLodFrame()
    cams = [ring_camera(i, n_cams=6, height=96, width=128, device=cuda) for i in range(3)]
    args = dict(budget=1 << 12, num_points=r.num_points, config=RasterConfig(max_instances=1 << 15),
                attrs=r._attrs)
    with torch.no_grad():
        frame(r._packed, r.target_size(cam, 2.0), cam, *r.arrays, **args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for c in cams:
                out = frame(r._packed, r.target_size(c, 2.0), c, *r.arrays, **args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert int(out["num_selected"]) > 0 and len(frame.captures) == 1 and frame.replays == 4
        for budget in (1 << 12, 1 << 13):  # the captured key and a new one
            with pytest.raises(ValueError, match="by reference"):
                frame(r._packed, r.target_size(cam, 2.0), cam, *r.arrays,
                      **dict(args, budget=budget, attrs=r._attrs.clone()))
        assert len(frame.captures) == 1


@pytest.mark.cuda
def test_recording_spans_adds_no_host_sync_to_replays(cuda):
    """With the tracer recording (utils/profiling.py `enable()`), steady
    replays of the compiled train step and of the compiled LOD frame under
    set_sync_debug_mode("error"); each replay is a `graph.replay` span."""
    from hidegs_tpu_torch.hier.interp import CompiledLodFrame
    from hidegs_tpu_torch.train import compiled
    from hidegs_tpu_torch.utils import profiling

    ts, cfg, _, _, batches = _compiled_variant(cuda, "single-view")
    step = compiled.CompiledTrainStep()
    ts, _ = step(ts, batches[0], cfg)  # warm-up and capture
    h, cam = _lod_problem(cuda)
    r = _eager_renderer(h, cuda)
    frame = CompiledLodFrame()
    args = dict(budget=1 << 12, num_points=r.num_points, config=RasterConfig(max_instances=1 << 15),
                attrs=r._attrs)
    cams = [ring_camera(i, n_cams=6, height=96, width=128, device=cuda) for i in range(3)]
    with torch.no_grad():
        frame(r._packed, r.target_size(cam, 2.0), cam, *r.arrays, **args)
    targets = [r.target_size(c, 2.0) for c in cams]
    torch.cuda.synchronize()
    profiling.clear()
    profiling.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch in batches:
            with profiling.span("train.step"):
                ts, metrics = step(ts, batch, cfg)
        with torch.no_grad():
            for c, target in zip(cams, targets):
                with profiling.span("lod.frame"):
                    out = frame(r._packed, target, c, *r.arrays, **args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        profiling.disable()
    recs = profiling.records()
    profiling.clear()
    assert float(metrics["step_ok"]) == 1.0 and int(out["num_selected"]) > 0
    assert len(step.captures) == 1 and len(frame.captures) == 1
    replays = [(x.attrs["what"], {y.id: y.name for y in recs}[x.parent]) for x in recs if x.name == "graph.replay"]
    assert len(replays) == 6 and {p for _, p in replays} == {"train.step", "lod.frame"}
    assert {w for w, p in replays if p == "lod.frame"} == {"the LOD frame"}


@pytest.mark.cuda
def test_a_profiled_lod_frame_names_its_spans(cuda, tmp_path):
    """The compiled AdaptiveHierRenderer under utils.profiling.trace: the
    trace holds the renderer's `lod.frame`, its waits and `graph.replay`
    as ranges, beside the forward blend kernel; the tracer kept the same
    spans, a frame's waits inside it."""
    import json

    from hidegs_tpu_torch.hier.interp import AdaptiveHierRenderer
    from hidegs_tpu_torch.utils import profiling

    h, cam = _lod_problem(cuda)
    r = AdaptiveHierRenderer.from_hierarchy(h, cuda)
    with torch.no_grad():
        r.render(cam, 2.0)  # warm-up and capture
        torch.cuda.synchronize()
        profiling.clear()
        with profiling.trace(str(tmp_path), device=cuda):
            for _ in range(3):
                r.render(cam, 2.0)
    recs = profiling.records()
    profiling.clear()
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    ranges = [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    for want in ("lod.frame", "lod.read_viewpoint", "lod.read_counters", "graph.replay"):
        assert ranges.count(want) == 3, (want, ranges.count(want))
    assert any("blend_fwd" in e.get("name", "") for e in events if e.get("cat") == "kernel")
    frames = [x for x in recs if x.name == "lod.frame"]
    assert [f.request for f in frames] == [1, 2, 3] and all(f.attrs["attempts"] == 1 for f in frames)
    for f in frames:
        assert sorted(x.name for x in recs if x.parent == f.id) == ["graph.replay", "lod.read_counters",
                                                                     "lod.read_viewpoint"]


def test_native_builder_builds_into_build_dir():
    """The hierarchy builder's library is compiled from the port's copy of
    hier_builder.cpp into build/hier/ of the checkout (no card needed)."""
    from hidegs_tpu_torch.hier import build as tbuild

    lib = tbuild.compile_native()
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert lib.parent == repo / "build" / "hier" and lib.exists()
    assert tbuild.SRC == repo / "hidegs_tpu_torch" / "hier" / "native" / "hier_builder.cpp"
    assert tbuild.native_available()


def _post_opt_problem(dev, n=2000, h=96, w=128):
    """The hierarchy of a toy scene (native builder) with its SH scaled by
    0.7, three views of the scene on `dev` as targets, the post-opt state
    and a cut target that interpolates (tau 2 px)."""
    from hidegs_tpu_torch.hier.build import build_hierarchy
    from hidegs_tpu_torch.hier.lod import tau_to_target_size
    from hidegs_tpu_torch.train import hier_trainer as ht

    scene = make_toy_gaussians(n, seed=5, device="cpu")
    hier = build_hierarchy(*(x.numpy() for x in (scene.means3d, scene.quats, scene.scales, scene.opacities,
                                                   scene.shs)), use_native=True)
    rcfg = RasterConfig(tile=16, max_instances=1 << 16)
    cams = [ring_camera(i, n_cams=3, height=h, width=w, device=dev) for i in range(3)]
    with torch.no_grad():
        gts = [torch.clamp(render(*(x.to(dev) for x in scene), c, config=rcfg)["render"], 0, 1) for c in cams]
    ts = ht.state_from_hierarchy(hier._replace(shs=hier.shs * 0.7), num_images=3, device=dev)
    return ts, cams, gts, rcfg, tau_to_target_size(2.0, float(cams[0].fx)), 1 << 13


def _post_opt_leaves(ts):
    return (list(ts.params) + list(ts.opt.m) + list(ts.opt.v)
            + [ts.opt.step, ts.step, ts.exposure, ts.exposure_m, ts.exposure_v])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["eager", "compiled"])
def test_post_opt_step_kernels_hold_against_plain(cuda, mode):
    """One post-opt step (exposure on). Eager: one launch of each kernel;
    the blend node's forward planes against the plain blend and its
    backward + fold against the plain backward, on the node's own rows,
    binning and cotangents; the whole step against the "plain" backend:
    loss at rtol 1e-3, Adam's first moments normalised at 1e-3. Compiled:
    the first call warms up (one launch of each kernel, masked Adam
    included, through the launchers) and captures, each replay adds one
    launch of each kernel to
    REPLAY_LAUNCHES, and the step is bitwise the eager one, which the
    eager case holds."""
    import dataclasses

    from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
    from hidegs_tpu_torch.train import hier_trainer as ht
    from hidegs_tpu_torch.train.budgets import COUNTERS

    ts, cams, gts, rcfg, target, budget = _post_opt_problem(cuda)
    cut = ht.select_cut(ts, cams[0], target, budget)
    assert bool(((cut.ts > 0) & (cut.ts < 1) & cut.valid).any())
    if mode == "compiled":
        lrs = lr_tree(ts.step, LRConfig(), 1.0)
        kw = dict(image_idx=0, use_exposure=True, optimize_exposure=True)
        step = ht.CompiledHierTrainStep()
        before, replays = _counts(), _replays()
        for k in range(2):
            got, gm = step(ts, step.select(ts, cams[0], target, budget), cams[0], gts[0], lrs, rcfg, **kw)
            torch.cuda.synchronize()
            assert tuple(b - a for a, b in zip(replays, _replays())) == (k + 1,) * 6
            assert tuple(b - a for a, b in zip(before, _counts())) == ((1, 1, 1) if k == 0 else (0, 0, 0))
            want, wm = ht.hier_train_step(ts, cut, cams[0], gts[0], lrs, rcfg, **kw)
            for x, y in zip(_post_opt_leaves(got), _post_opt_leaves(want)):
                assert torch.equal(x, y)
            assert all(torch.equal(gm[m], wm[m]) for m in wm)
            before = _counts()
        assert [c["kind"] for c in step.captures] == ["cut", "step"]
        assert step.captures[1]["launches"] == step.captures[1]["warmup_launches"] == dict.fromkeys(
            ("blend_fwd", "blend_bwd", "fold_rows", "preprocess_fwd", "preprocess_bwd", "masked_adam"), 1)
        assert all(int(gm["counters"][COUNTERS.index(c)]) == 0 for c in ("overflow", "block_overflow",
                                                                           "visible_overflow"))
        return
    before = _counts()
    loss, inputs = ht.hier_step_forward(ts, cut, cams[0], gts[0], rcfg, image_idx=0, use_exposure=True)
    node = _blend_node(loss.grad_fn)
    got = {}
    node.register_prehook(lambda go: got.update(saved=[x.detach() for x in node.saved_tensors],
                                                g=go[0].contiguous()))
    node.register_hook(lambda gi, go: got.update(d_attrs=gi[0]))
    torch.autograd.grad(loss, inputs)
    torch.cuda.synchronize()
    assert tuple(x - y for x, y in zip(_counts(), before)) == (1, 1, 1)
    attrs, tile_out = got["saved"]
    ty, tx, tile, max_blocks, _ = node.args
    p_out, p_obs = blend_plain.blend_tile_out(blend_plain.unpack_attrs(attrs), node.binning, ty, tx, tile, max_blocks)
    torch.testing.assert_close(tile_out, p_out, **BLEND_TOL)
    g_aug = blend_plain.augment_cotangents(tile_out, got["g"])
    assert torch.equal(got["d_attrs"], cuda_blend.grad_attrs(attrs, node.binning, node.count, g_aug, tx, tile))
    rows = blend_plain.blend_tiles_bwd(blend_plain.unpack_attrs(attrs), node.binning, g_aug, ty, tx, tile, max_blocks)
    want = blend_plain.fold_rows(blend_plain.expansion_rows(rows, node.binning.slot_s), node.binning.g_start)
    _assert_grads_close(got["d_attrs"], want, "post-opt step")

    lrs = lr_tree(ts.step, LRConfig(), 1.0)
    kw = dict(image_idx=0, use_exposure=True, optimize_exposure=True)
    k, mk = ht.hier_train_step(ts, cut, cams[0], gts[0], lrs, rcfg, **kw)
    p, mp = ht.hier_train_step(ts, cut, cams[0], gts[0], lrs, dataclasses.replace(rcfg, backend="plain"), **kw)
    torch.testing.assert_close(mk["loss"], mp["loss"], rtol=1e-3, atol=0)
    assert int(mk["n_visible"]) == int(mp["n_visible"]) > 0
    for a, b in zip(k.opt.m, p.opt.m):
        scale = float(b.abs().max()) + 1e-30
        assert float((a - b).abs().max()) / scale <= STEP_GRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["eager", "compiled"])
def test_post_opt_step_is_bitwise_deterministic(cuda, mode):
    """Two post-opt steps from one state: params, moments, per-row step
    counts and exposure bitwise equal (the parents' gradients are summed by
    the sorted index_put_ of the interpolation's gathers). Compiled: two
    replays, each from the caller's state copied in (a device tensor as
    the image index), the first result cloned before the second."""
    from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
    from hidegs_tpu_torch.train import hier_trainer as ht
    from hidegs_tpu_torch.utils import graphs

    ts, cams, gts, rcfg, target, budget = _post_opt_problem(cuda)
    cut = ht.select_cut(ts, cams[1], target, budget)
    lrs = lr_tree(ts.step, LRConfig(), 1.0)
    kw = dict(image_idx=1, use_exposure=True, optimize_exposure=True)
    if mode == "compiled":
        step = ht.CompiledHierTrainStep()
        kw["image_idx"] = torch.tensor(1, device=cuda)
        a, ma = graphs._map(torch.clone, step(ts, cut, cams[1], gts[1], lrs, rcfg, **kw))
        b, mb = step(ts, cut, cams[1], gts[1], lrs, rcfg, **kw)
        assert len(step.captures) == 1 and step.replays == 2
    else:
        a, ma = ht.hier_train_step(ts, cut, cams[1], gts[1], lrs, rcfg, **kw)
        b, mb = ht.hier_train_step(ts, cut, cams[1], gts[1], lrs, rcfg, **kw)
    for x, y in zip(_post_opt_leaves(a), _post_opt_leaves(b)):
        assert torch.equal(x, y)
    assert torch.equal(ma["loss"], mb["loss"]) and float(ma["loss"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["eager", "compiled"])
def test_post_opt_step_makes_no_host_sync(cuda, mode):
    """select_cut, the learning rates and a post-opt step with exposure,
    a skybox tail and frozen anchors under
    torch.cuda.set_sync_debug_mode("error"); compiled: the steady loop of
    cut and step replays over three views (image indices from a device
    tensor), after the capture."""
    from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
    from hidegs_tpu_torch.train import hier_trainer as ht

    ts, cams, gts, rcfg, target, budget = _post_opt_problem(cuda)
    frozen = torch.zeros(ts.params.xyz.shape[0], dtype=torch.bool, device=cuda)
    frozen[::7] = True
    kw = dict(frozen=frozen, skybox_count=16, use_exposure=True, optimize_exposure=True)
    ids = torch.arange(3, device=cuda)
    compiled = ht.CompiledHierTrainStep()
    select, train = (compiled.select, compiled) if mode == "compiled" else (ht.select_cut, ht.hier_train_step)

    def step(state, i=2):
        cut = select(state, cams[i], target, budget)
        idx = ids[i] if mode == "compiled" else i
        return train(state, cut, cams[i], gts[i], lr_tree(state.step, LRConfig(), 1.0), rcfg, image_idx=idx, **kw)

    ts, _ = step(ts)  # builds the kernels and the loss constants (compiled: warms up and captures)
    xyz = ts.params.xyz.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, m = step(ts)
        if mode == "compiled":
            for i in (0, 1, 2):
                new, m = step(new, i)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n = 2 if mode == "eager" else 5
    assert int(new.step) == n and bool(torch.isfinite(m["loss"]))
    assert torch.equal(new.params.xyz[frozen], xyz[frozen])
    if mode == "compiled":
        assert len(compiled.captures) == 2 and compiled.replays == 2 * n


@pytest.mark.cuda
def test_a_new_post_opt_budget_captures_a_new_key_and_keeps_the_old_graph(cuda):
    """A second cut budget captures a second cut graph and a second step
    graph in the shared pool; replaying the first pair afterwards still
    gives the eager step bitwise, and so does the second."""
    from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
    from hidegs_tpu_torch.train import hier_trainer as ht

    ts, cams, gts, rcfg, target, budget = _post_opt_problem(cuda)
    lrs = lr_tree(ts.step, LRConfig(), 1.0)
    step = ht.CompiledHierTrainStep()
    for b in (budget, 2 * budget):
        s, _ = step(ts, step.select(ts, cams[0], target, b), cams[0], gts[0], lrs, rcfg)
    assert len(step.captures) == 4
    for b, i in ((budget, 1), (2 * budget, 2), (budget, 0)):
        want, wm = ht.hier_train_step(ts, ht.select_cut(ts, cams[i], target, b), cams[i], gts[i], lrs, rcfg)
        got, gm = step(ts, step.select(ts, cams[i], target, b), cams[i], gts[i], lrs, rcfg)
        for x, y in zip(_post_opt_leaves(got), _post_opt_leaves(want)):
            assert torch.equal(x, y), b
        assert all(torch.equal(gm[m], wm[m]) for m in wm)
    assert len(step.captures) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "skybox_tail", "frozen_anchors", "exposure"])
def test_compiled_post_opt_step_is_bitwise_the_eager_step(cuda, variant):
    """Three steps over the three views (the cut and the step replayed)
    against three eager steps (select_cut and hier_train_step) from one
    state: the cut, every tensor of the state and both metrics bitwise
    equal after each step; the returned state is the step's own buffers;
    one capture of each graph; each replay adds one launch of each kernel
    to REPLAY_LAUNCHES and none to the launchers' counters."""
    from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
    from hidegs_tpu_torch.train import hier_trainer as ht

    ts, cams, gts, rcfg, target, budget = _post_opt_problem(cuda)
    P = ts.params.xyz.shape[0]
    frozen = torch.zeros(P, dtype=torch.bool, device=cuda)
    frozen[torch.randperm(P, generator=torch.Generator().manual_seed(3))[:P // 4].to(cuda)] = True
    kw = {"plain": dict(), "skybox_tail": dict(skybox_count=16), "frozen_anchors": dict(frozen=frozen),
          "exposure": dict(use_exposure=True, optimize_exposure=True)}[variant]
    ids = torch.arange(3, device=cuda)
    step = ht.CompiledHierTrainStep()
    eager = comp = ts
    ptrs = None
    for k in range(3):
        cut = ht.select_cut(eager, cams[k], target, budget)
        eager, em = ht.hier_train_step(eager, cut, cams[k], gts[k], lr_tree(eager.step, LRConfig(), 1.0), rcfg,
                                       image_idx=k, **kw)
        counts, replays = _counts(), _replays()
        ccut = step.select(comp, cams[k], target, budget)
        for f in cut._fields:
            assert torch.equal(getattr(ccut, f), getattr(cut, f)), f
        comp, cm = step(comp, ccut, cams[k], gts[k], lr_tree(comp.step, LRConfig(), 1.0), rcfg, image_idx=ids[k],
                        **kw)
        torch.cuda.synchronize()
        if k > 0:
            assert _counts() == counts, "a replay went through the launchers"
        assert tuple(b - a for a, b in zip(replays, _replays())) == (1,) * 6
        for n, (a, b) in enumerate(zip(_post_opt_leaves(comp), _post_opt_leaves(eager))):
            assert torch.equal(a, b), f"{variant} step {k}: leaf {n}"
        assert all(torch.equal(em[m], cm[m]) for m in em), variant
        now = [x.data_ptr() for x in _post_opt_leaves(comp)]
        assert ptrs is None or now == ptrs, "the replay returned other buffers"
        ptrs = now
    assert len(step.captures) == 2 and step.replays == 6 and float(cm["loss"]) > 0
    if "frozen" in kw:
        assert torch.equal(comp.params.xyz[frozen], ts.params.xyz[frozen])


def _refitting_post_opt(dev, monkeypatch, hold=None):
    """post_optimize on the card from an instance budget of 1024, which the
    toy views overflow: each call of the compiled step is recorded (its
    budget, whether it captured, the host syncs it made), and `hold(comp,
    args, kwargs, out)` runs after each."""
    import warnings

    from hidegs_tpu_torch.hier.io import Hierarchy
    from hidegs_tpu_torch.train import hier_trainer as ht

    ts, cams, gts, rcfg, target, budget = _post_opt_problem(dev)
    h = ht.hierarchy_from_state(ts, Hierarchy(*(None,) * 5, ts.nodes.cpu().numpy(), ts.boxes.cpu().numpy()))
    calls = []

    class Watched(ht.CompiledHierTrainStep):
        def select(self, *args, **kwargs):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out = super().select(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            self.select_syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
            return out

        def __call__(self, *args, **kwargs):
            captured = len(self.captures)
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out = super().__call__(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs = self.select_syncs + [str(w.message) for w in caught if "synchroniz" in str(w.message)]
            calls.append((args[5].max_instances, len(self.captures) > captured, syncs))
            if hold is not None:
                hold(self, args, kwargs, out)
            return out

    monkeypatch.setattr(ht, "CompiledHierTrainStep", Watched)
    start = dataclasses.replace(rcfg, max_instances=1024)
    ht.post_optimize(h, cams, gts, iterations=40, target_size=target, budget=budget, raster_cfg=start,
                     log_every=1000, optimize_exposure=True, device=dev)
    return calls


@pytest.mark.cuda
def test_post_opt_refit_captures_a_new_key_and_makes_no_host_sync_between_reads(cuda, monkeypatch, capsys):
    """post_optimize from an overflowing instance budget: the budget
    doubles at a read of the counters (every 8 iterations), each new budget
    captures one new step graph and the old graphs stay (replaying an old
    budget afterwards captures nothing), the last windows overflow no more,
    and a call that captures nothing makes no host sync."""
    from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
    from hidegs_tpu_torch.train import budgets, hier_trainer as ht

    comps, last = [], []

    def hold(comp, args, kwargs, out):
        if not comps:
            comps.append(comp)
        last[:] = [out[1]["counters"]]

    calls = _refitting_post_opt(cuda, monkeypatch, hold=hold)
    assert "growing max_instances 1024 → 2048" in capsys.readouterr().out
    grown = [b for b, _, _ in calls]
    assert grown[0] == 1024 and grown[-1] > 1024 and grown == sorted(grown)
    for k, b in enumerate(grown):  # a budget changes only at a read
        assert k % budgets.OVERFLOW_CHECK_EVERY == 0 or b == grown[k - 1], k
    keys = sorted(set(grown))
    comp = comps[0]
    assert [c["max_instances"] for c in comp.captures if c["kind"] == "step"] == keys
    assert all(captured == (k == 0 or grown[k] != grown[k - 1]) for k, (_, captured, _) in enumerate(calls))
    for k, (b, captured, syncs) in enumerate(calls):
        if not captured:
            assert not syncs, f"iteration {k + 1} (max_instances {b}) synchronised: {syncs}"
    assert int(last[0][budgets.COUNTERS.index("overflow")]) == 0
    n = len(comp.captures)
    ts, cams, gts, rcfg, target, budget = _post_opt_problem(cuda)
    # the first budget's graph is still held: a call at it replays
    for b in (keys[0], keys[-1]):
        comp(ts, ht.select_cut(ts, cams[0], target, budget), cams[0], gts[0], lr_tree(ts.step, LRConfig(), 1.0),
             dataclasses.replace(rcfg, max_instances=b), image_idx=0, use_exposure=True, optimize_exposure=True)
    assert len(comp.captures) == n


@pytest.mark.cuda
def test_post_opt_replays_are_the_eager_step_at_a_grown_budget(cuda, monkeypatch):
    """Each call of the compiled step inside a re-fitting post_optimize,
    held against select_cut and hier_train_step from the same state at the
    budget in force: the cut, every tensor of the new state and the
    metrics bitwise equal, at the start budget and at the grown ones."""
    from hidegs_tpu_torch.train import hier_trainer as ht
    from hidegs_tpu_torch.utils import graphs

    held = []

    def hold(comp, args, kwargs, out):
        _, cut, cam, gt, lrs, rcfg = args
        state0 = held_state[-1]
        want_cut = ht.select_cut(state0, cam, cut_target[0], cut.valid.shape[0])
        assert all(torch.equal(getattr(cut, f), getattr(want_cut, f)) for f in cut._fields)
        want, wm = ht.hier_train_step(state0, want_cut, cam, gt, lrs, rcfg, **kwargs)
        got, gm = out
        for n, (a, b) in enumerate(zip(_post_opt_leaves(got), _post_opt_leaves(want))):
            assert torch.equal(a, b), (rcfg.max_instances, n)
        assert all(torch.equal(gm[m], wm[m]) for m in wm)
        held.append(rcfg.max_instances)

    held_state, cut_target = [], []
    orig_select = ht.CompiledHierTrainStep.select

    def select(self, ts, cam, target, budget):
        # the state the coming step starts from, cloned before the replay
        held_state.append(ts._replace(**dict(zip(ht._STEP_FIELDS, graphs._map(torch.clone, ht._written(ts))))))
        cut_target[:] = [target]
        return orig_select(self, ts, cam, target, budget)

    monkeypatch.setattr(ht.CompiledHierTrainStep, "select", select)
    _refitting_post_opt(cuda, monkeypatch, hold=hold)
    assert len(held) == 40 and len(set(held)) > 1


@pytest.mark.cuda
def test_pipeline_runs_on_the_card(cuda, tmp_path):
    """run_pipeline on the two-cluster scene on the card (3 chunk and 3
    post-opt iterations, eval at tau 0 and 3): two chunks, finite merged
    and post-optimized hierarchies; one backward and fold per train and
    post-opt step, and one forward more per (tau, view) of the eval. The
    chunks and the post-optimizer train on compiled steps: their steps'
    launches are replays, and each capture's warm-up step launches each
    kernel once more."""
    import json
    import os

    import numpy as np

    from hidegs_tpu_torch import pipeline
    from hidegs_tpu_torch.hier import io as hio
    from hidegs_tpu_torch.utils import graphs
    from torch_scenes import write_two_cluster_scene

    src = write_two_cluster_scene(tmp_path / "scene")
    out = str(tmp_path / "out")
    before, replays = _counts(), tuple(graphs.REPLAY_LAUNCHES[k] for k in graphs.ALL_KERNELS)
    pipeline.run_pipeline(src, out, chunk_size=14.0, min_n_cams=3, iterations=3, post_opt_iterations=3,
                          capacity=256, max_instances=1 << 12, add_far_cams=False, log_every=1000,
                          eval_taus=(0.0, 3.0), device="cuda")
    torch.cuda.synchronize()
    fwd, bwd, fold = (x - y for x, y in zip(_counts(), before))
    replayed = tuple(graphs.REPLAY_LAUNCHES[k] - r for k, r in zip(graphs.ALL_KERNELS, replays))
    meta = json.load(open(os.path.join(out, "pipeline.json")))
    assert len(meta["chunks"]) == 2 and len(meta["lod_eval"]) == 2
    n_eval = 2 * 8  # two taus, eight of the ten views
    # one capture per chunk and one of the post-opt step: each warm-up is one launch of each
    assert replayed == (3 * 2 + 3,) * 6, replayed
    assert bwd == fold == 2 + 1 and fwd == bwd + n_eval, (fwd, bwd, fold)
    for name in ("merged.hier", "merged_opt.hier"):
        h = hio.read_hier(os.path.join(out, name))
        assert all(np.isfinite(getattr(h, f)).all() for f in ("pos", "rot", "scale", "alpha", "shs"))
    assert all(np.isfinite(r["psnr"]) and r["mean_cut"] > 0 for r in meta["lod_eval"])


# ---------------------------------------------------------------------------
# the view-parallel step (parallel/sharded.py) on the card


def _dp_problem(dev, n=2000, hw=128, views=4, seed=0):
    from hidegs_tpu_torch.model.gaussians import init_from_points
    from hidegs_tpu_torch.train import loop as tl

    scene = make_toy_gaussians(n, seed=seed, device=dev)
    cams = [ring_camera(i, n_cams=views, height=hw, width=hw, device=dev) for i in range(views)]
    rcfg = RasterConfig(max_instances=1 << 17)
    with torch.no_grad():
        vs = [tl.ViewBatch(cam=c, image=render(*scene, c, config=rcfg)["render"], image_idx=torch.tensor(i, device=dev))
              for i, c in enumerate(cams)]
    state = init_from_points(scene.means3d, torch.full((n, 3), 0.5, device=dev), capacity=2048)
    cfg = tl.TrainConfig(iterations=100, raster=rcfg, freq_warmup=0, single_view_from=0)
    return tl.init_train_state(state, views), vs, cfg


def _dp_leaves(ts):
    g = ts.gaussians
    return list(g.params) + list(ts.opt.m) + list(ts.opt.v) + [ts.opt.step, g.grad_max, g.max_radii2d, ts.step]


@pytest.mark.cuda
def test_one_rank_nccl_step_is_bitwise_the_step_without_group(cuda, tmp_path):
    """Three V = 4 steps in a one-rank NCCL group, float32 and on the bf16
    wire, bitwise the steps with no group; four launches of each kernel a
    step; the bf16 wire's first step within rtol 1e-4 of float32's loss and
    its update at cosine > 0.99 (tests/test_parallel.py's bf16 check)."""
    from hidegs_tpu_torch.parallel import distributed as pdist
    from hidegs_tpu_torch.parallel import dryrun, sharded
    from hidegs_tpu_torch.parallel.mesh import make_mesh

    ts0, views, cfg = _dp_problem(cuda)
    batch = sharded.stack_view_batches(views)
    alone = {}
    for wire in (None, torch.bfloat16):
        step, _ = sharded.make_dp_train_step(cfg, None, grad_reduce_dtype=wire)
        before = (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES)
        ts, out = ts0, []
        for _ in range(3):
            ts, m = step(ts, batch)
            out.append((ts, float(m["loss"])))
        torch.cuda.synchronize()
        after = (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES)
        assert [a - b for a, b in zip(after, before)] == [12, 12, 12]
        alone[wire] = out
    pdist.initialize_distributed(backend="nccl", device=cuda, init_method=dryrun.file_init_method(str(tmp_path)),
                                 world_size=1, rank=0)
    try:
        mesh = make_mesh(1, device_type="cuda")
        for wire in (None, torch.bfloat16):
            step, place = sharded.make_dp_train_step(cfg, mesh, grad_reduce_dtype=wire)
            ts, b = place(ts0, batch)
            for want, want_loss in alone[wire]:
                ts, m = step(ts, b)
                assert float(m["loss"]) == want_loss
                assert all(torch.equal(x, y) for x, y in zip(_dp_leaves(ts), _dp_leaves(want)))
    finally:
        pdist.shutdown_distributed()
    (a, la), (b, lb) = alone[None][0], alone[torch.bfloat16][0]
    assert abs(lb - la) <= 1e-4 * abs(la)
    da = a.gaussians.params.xyz - ts0.gaussians.params.xyz
    db = b.gaussians.params.xyz - ts0.gaussians.params.xyz
    moved = (da.abs().amax(1) > 0) | (db.abs().amax(1) > 0)
    cos = float((da[moved] * db[moved]).sum() / (da[moved].norm() * db[moved].norm()))
    assert cos > 0.99, cos
    assert not torch.equal(a.opt.m.xyz, b.opt.m.xyz)


def _two_gloo_ranks(dev, runs, tmp_path, seed=0):
    from hidegs_tpu_torch.parallel import dryrun

    ts0, views, cfg = _dp_problem(dev, seed=seed)
    job = tmp_path / "job.pt"
    dryrun.save_dp_job(str(job), ts0, views, cfg, runs)
    dryrun.launch(dryrun.dp_worker, 2, (dryrun.file_init_method(str(tmp_path / "rdv")), "gloo", "cuda", str(job),
                                        str(tmp_path)), 600, str(tmp_path / "logs"))
    return ts0, views, cfg, [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_match_one_rank(cuda, tmp_path):
    """Two ranks on one card over gloo (NCCL takes one card per rank), two
    views each: the ranks bitwise equal, the losses within rtol 1e-5 and
    the parameters within 1e-5 of the one-process V = 4 run (the gradient
    sum's order differs)."""
    from hidegs_tpu_torch.parallel import sharded

    runs = [dict(name="dp", data=2, model=1, steps=3, save_steps=[3])]
    ts0, views, cfg, res = _two_gloo_ranks(cuda, runs, tmp_path)
    assert (res[0]["dp"]["digest"] == res[1]["dp"]["digest"]).all()
    step, _ = sharded.make_dp_train_step(cfg, None)
    ts, losses = ts0, []
    for _ in range(3):
        ts, m = step(ts, sharded.stack_view_batches(views))
        losses.append(float(m["loss"]))
    got = res[0]["dp"]
    torch.testing.assert_close(torch.tensor(got["losses"]), torch.tensor(losses), rtol=1e-5, atol=0)
    for f in sharded.PARAM_FIELDS:
        torch.testing.assert_close(torch.as_tensor(got["states"][3]["gaussians"]["params"][f]),
                                   getattr(ts.gaussians.params, f).cpu(), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_gloo_ranks_on_the_card_are_bitwise_one_rank(cuda, tmp_path, seed):
    """Two ranks of two views each add their halves of the views'
    gradients as the one-process V = 4 step adds them, (v0 + v1) + (v2 +
    v3): three steps' losses and parameters bitwise equal, on three toy
    scenes."""
    from hidegs_tpu_torch.parallel import sharded

    runs = [dict(name="dp", data=2, model=1, steps=3, save_steps=[1, 2, 3])]
    ts, views, cfg, res = _two_gloo_ranks(cuda, runs, tmp_path, seed=seed)
    step, _ = sharded.make_dp_train_step(cfg, None)
    got = res[0]["dp"]
    for k in range(3):
        ts, m = step(ts, sharded.stack_view_batches(views))
        assert got["losses"][k] == float(m["loss"]), k
        for f in sharded.PARAM_FIELDS:
            assert torch.equal(torch.as_tensor(got["states"][k + 1]["gaussians"]["params"][f]),
                               getattr(ts.gaussians.params, f).cpu()), (k, f)


@pytest.mark.cuda
def test_sharded_rows_on_the_card_equal_the_replicated_run(cuda, tmp_path):
    """Two gloo ranks on a (1, 2) mesh: the rows split over "model", with
    the rows gathered before the render and with the preprocessed rows
    gathered inside it, against the same mesh replicated: the first step's
    gradients (Adam's m) equal, not doubled."""
    runs = [dict(name="repl", data=1, model=2, steps=2, save_steps=[1]),
            dict(name="shard", data=1, model=2, shard=True, steps=2, save_steps=[1]),
            dict(name="pre", data=1, model=2, shard=True, replicate_preprocessed=True, steps=2, save_steps=[1])]
    _, _, _, res = _two_gloo_ranks(cuda, runs, tmp_path)
    repl, shard, pre = (res[0][n]["states"][1]["m"] for n in ("repl", "shard", "pre"))
    for f in repl:
        want = torch.as_tensor(repl[f])
        assert torch.equal(torch.as_tensor(shard[f]), want), f
        torch.testing.assert_close(torch.as_tensor(pre[f]), want, rtol=0, atol=1e-6 * float(want.abs().max()) + 1e-30)
    for n in ("repl", "shard", "pre"):
        assert (res[0][n]["digest"] == res[1][n]["digest"]).all(), n


# ---------------------------------------------------------------------------
# the compiled view-parallel step, LPIPS and densify round (parallel/compiled.py,
# train/lpips.py, train/compiled.py)


def _dp_variant(dev, variant):
    """(state, the V = 4 stacked batch, config, the step's keyword
    arguments) of a variant of the compiled view-parallel tests."""
    import dataclasses

    from hidegs_tpu_torch.parallel import sharded

    ts, views, cfg = _dp_problem(dev)
    kwargs = {"bf16": dict(grad_reduce_dtype=torch.bfloat16), "exposure": dict(use_exposure=True)}.get(variant, {})
    if variant == "multi-view":
        cfg = dataclasses.replace(cfg, multi_view_from=0, multi_view_sample_num=2048)
        views = [_multi_view_batch(views, i, (i + 1) % len(views)) for i in range(len(views))]
    return ts, sharded.stack_view_batches(views), cfg, kwargs


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32", "bf16", "exposure", "multi-view", "nccl"])
def test_compiled_dp_step_is_bitwise_the_eager_step(cuda, variant, tmp_path):
    """Three replays of the V = 4 step against three eager steps from one
    state (no group; "nccl": a one-rank NCCL group, whose collectives the
    graph records): every tensor of the state and every metric bitwise
    equal (the multi-view samples drawn before each replay from the
    state's generator, which advances alike); the returned state is the
    step's own buffers; one capture, whose warm-up launched V of each
    render kernel and one masked Adam through the launchers (2V with
    multi-view terms, whose loss renders the source view); each replay
    adds as many to REPLAY_LAUNCHES and none to the launchers' counters."""
    from hidegs_tpu_torch.parallel import compiled as pc
    from hidegs_tpu_torch.parallel import distributed as pdist
    from hidegs_tpu_torch.parallel import dryrun, sharded
    from hidegs_tpu_torch.parallel.mesh import make_mesh
    from hidegs_tpu_torch.utils import graphs

    ts0, batch, cfg, kwargs = _dp_variant(cuda, variant)
    V = sharded.num_views(batch) * (2 if batch.multi_view is not None else 1)  # a multi-view loss renders twice
    mesh = None
    if variant == "nccl":
        pdist.initialize_distributed(backend="nccl", device=cuda, init_method=dryrun.file_init_method(str(tmp_path)),
                                     world_size=1, rank=0)
        mesh = make_mesh(1, device_type="cuda")
    try:
        eager_step, place = sharded.make_dp_train_step(cfg, mesh, **kwargs)
        step, _ = pc.compile_dp_train_step(cfg, mesh, **kwargs)
        eager, _ = place(ts0, batch)
        comp, ptrs = eager, None
        for k in range(3):
            eager, em = eager_step(eager, batch)
            torch.cuda.synchronize()
            counts, replays = _counts(), _replays()
            comp, cm = step(comp, batch)
            torch.cuda.synchronize()
            assert [a - b for a, b in zip(_counts(), counts)] == ([V] * 3 if k == 0 else [0] * 3)
            assert [a - b for a, b in zip(_replays(), replays)] == [V] * 5 + [1]
            for n, (a, b) in enumerate(zip(graphs._tensors(comp), graphs._tensors(eager), strict=True)):
                assert torch.equal(a, b), f"{variant} step {k}: tensor {n} of the state"
            assert em.keys() == cm.keys() and all(torch.equal(em[m], cm[m]) for m in em), variant
            assert torch.equal(comp.mv_generator.get_state(), eager.mv_generator.get_state())
            now = [x.data_ptr() for x in graphs._tensors(comp)]
            assert ptrs is None or now == ptrs, "the replay returned other buffers"
            ptrs = now
        assert len(step.captures) == 1 and step.replays == 3
        assert step.captures[0]["launches"] == dict(dict.fromkeys(graphs.KERNELS, V), masked_adam=1)
        del step  # its graph holds the group's collectives
    finally:
        torch.cuda.synchronize()
        pdist.shutdown_distributed()


@pytest.mark.cuda
def test_compiled_dp_replay_makes_no_host_sync(cuda):
    """After the capture, steady replays of the multi-view V = 4 step (the
    samples drawn before each replay) under set_sync_debug_mode("error")."""
    from hidegs_tpu_torch.parallel import compiled as pc

    ts, batch, cfg, _ = _dp_variant(cuda, "multi-view")
    step, _ = pc.compile_dp_train_step(cfg)
    ts, _ = step(ts, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            ts, metrics = step(ts, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(metrics["loss"])) and int(ts.step) == 4 and len(step.captures) == 1


@pytest.mark.cuda
def test_compiled_dp_step_refuses_a_gloo_group_on_the_card(cuda, tmp_path):
    """gloo's collectives on CUDA tensors go through the host and cannot be
    captured: the compiled step refuses a gloo mesh when it is made, and
    the dry run's choice on it is the eager step."""
    from hidegs_tpu_torch.parallel import compiled as pc
    from hidegs_tpu_torch.parallel import distributed as pdist
    from hidegs_tpu_torch.parallel import dryrun
    from hidegs_tpu_torch.parallel.mesh import make_mesh

    _, _, cfg, _ = _dp_variant(cuda, "f32")
    pdist.initialize_distributed(backend="gloo", device=cuda, init_method=dryrun.file_init_method(str(tmp_path)),
                                 world_size=1, rank=0)
    try:
        mesh = make_mesh(1, device_type="cuda")
        with pytest.raises(ValueError, match="make_dp_train_step"):
            pc.compile_dp_train_step(cfg, mesh)
        step, _ = dryrun.dp_step(cuda, cfg, mesh)
        assert not isinstance(step, pc.CompiledDPStep)
    finally:
        pdist.shutdown_distributed()


@pytest.mark.cuda
def test_compiled_lpips_is_bitwise_eager(cuda):
    """Compiled LPIPS on two pairs of one size and one of another: bitwise
    the eager distance, one capture per size; a steady call makes no host
    sync."""
    from hidegs_tpu_torch.train import lpips

    params = lpips.random_lpips_params(0, cuda)
    fn, kind = lpips.default_lpips_fn("", device=cuda)
    assert isinstance(fn, lpips.CompiledLpips) and kind == "random-vgg"
    comp = lpips.CompiledLpips(params)
    g = torch.Generator(device=cuda).manual_seed(0)
    pairs = [tuple(torch.rand((3,) + hw, generator=g, device=cuda) for _ in range(2))
             for hw in ((96, 128), (96, 128), (64, 80))]
    for a, b in pairs:
        with torch.no_grad():
            want = lpips.lpips_distance(params, a, b)
        assert torch.equal(comp(a, b), want)
    assert len(comp.captures) == 2 and comp.replays == 3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = comp(*pairs[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(got) > 0


def _densified_problem(dev):
    """A train problem after a few steps, with thresholds that clone and
    split: (state, config)."""
    import dataclasses

    from hidegs_tpu_torch.train import loop as tl

    ts, batches, cfg = _train_problem(dev)
    for k in range(4):
        ts, _ = tl.train_step(ts, batches[k % 4], cfg)
    g = ts.gaussians
    score = g.grad_max * g.max_radii2d * torch.clamp(g.opacities, min=1e-8) ** 0.2
    max_scale = torch.amax(torch.exp(g.params.scaling), dim=-1)
    dcfg = cfg.densify._replace(grad_threshold=float(torch.quantile(score[g.alive], 0.8)), clone_min_opacity=0.0,
                                percent_dense=float(torch.median(max_scale[g.alive])) / 3.0)
    return ts, dataclasses.replace(cfg, densify=dcfg)


@pytest.mark.cuda
def test_compiled_densify_round_and_scrub_are_bitwise_eager(cuda):
    """Two densify rounds and a scrub replayed against the eager ones from
    one state (the draws drawn before each replay from the state's
    generator, which advances alike): every tensor and info value bitwise
    equal; one capture each; a steady round and scrub make no host sync."""
    from hidegs_tpu_torch.train import compiled
    from hidegs_tpu_torch.train import loop as tl
    from hidegs_tpu_torch.utils import graphs

    ts, cfg = _densified_problem(cuda)
    rounds = compiled.CompiledDensify()
    eager = ts._replace(generator=torch.Generator().manual_seed(5))
    comp = ts._replace(generator=torch.Generator().manual_seed(5))

    def same(a, b):
        return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))

    for k in range(3):
        eager, einfo = tl.densify_step(eager, 3.0, cfg) if k < 2 else tl.scrub_step(eager)
        if k == 2:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            comp, cinfo = rounds.densify_step(comp, 3.0, cfg) if k < 2 else rounds.scrub_step(comp)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for n, (a, b) in enumerate(zip(graphs._tensors(comp), graphs._tensors(eager), strict=True)):
            assert same(a, b), f"round {k}: tensor {n}"
        if k < 2:
            assert all(same(cinfo[m], einfo[m]) for m in einfo), k
        else:
            assert torch.equal(cinfo, einfo)
        assert torch.equal(comp.generator.get_state(), eager.generator.get_state())
    assert [c["kind"] for c in rounds.captures] == ["densify", "scrub"] and rounds.replays == 3
    assert int(comp.gaussians.alive.sum()) > int(ts.gaussians.alive.sum())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rounds.densify_step(comp, 3.0, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_trainer_runs_its_densify_round_on_the_compiled_pair(cuda, tmp_path, monkeypatch, capsys):
    """`trainer.train` on the card replays the compiled densify round: one
    capture and one replay for a run with one round, which reports its
    counts."""
    from hidegs_tpu_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from hidegs_tpu_torch.train import compiled, trainer
    from torch_scenes import write_two_cluster_scene

    src = write_two_cluster_scene(tmp_path / "scene")
    made = []

    class Recorded(compiled.CompiledDensify):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(trainer, "CompiledDensify", Recorded)
    opt = OptimizationConfig(iterations=12, densify_from_iter=1, densify_until_iter=10, densification_interval=10,
                             freq_warmup_iterations=0, single_view_weight_from_iter=0,
                             multi_view_weight_from_iter=1000)
    ts = trainer.train(ModelConfig(source_path=src), PipelineConfig(capacity=2048, max_instances=1 << 12),
                       opt, save_iterations=(), log_every=1000, device="cuda")
    assert "densify@10" in capsys.readouterr().out
    assert len(made) == 1 and [c["kind"] for c in made[0].captures] == ["densify"] and made[0].replays == 1
    assert ts.gaussians.alive.device.type == "cuda"


# the serve configuration (evaluate, render_cli: tile 16, no block cap, the
# exact two-key sort) and the render cell's (tile 32, a block cap, one key)
RENDER_CONFIGS = {"serve": RasterConfig(tile=16, max_instances=1 << 14),
                  "render cell": RasterConfig(tile=32, max_instances=1 << 14, max_blocks=64, depth_sort_bits=-1)}


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(RENDER_CONFIGS))
def test_compiled_render_is_bitwise_the_eager_render(cuda, config):
    """The compiled render (raster/compiled.py) against the eager render on
    four views, with render_geo off and on and with a background: every
    key bitwise, one capture per key and one replayed forward launch per
    view, the warm-up's launch once per capture."""
    from hidegs_tpu_torch.raster.compiled import CompiledRender

    cfg = RENDER_CONFIGS[config]
    scene = make_toy_gaussians(600, seed=3, device=cuda)
    cams = [ring_camera(i, height=72, width=96, device=cuda) for i in range(4)]
    comp = CompiledRender()
    bg = torch.tensor([0.2, 0.1, 0.3], device=cuda)
    direct, replays = cuda_blend.LAUNCHES, _replays()
    got = []
    for geo, background in ((False, None), (True, None), (True, bg)):
        for cam in cams:
            out = comp(*scene, cam, background=background, render_geo=geo, config=cfg)
            got.append({k: v.clone() for k, v in out.items()})
    torch.cuda.synchronize()
    assert len(comp.captures) == 3 and comp.replays == 12
    assert cuda_blend.LAUNCHES - direct == 3 and _replays()[0] - replays[0] == 12
    n = 0
    with torch.no_grad():
        for geo, background in ((False, None), (True, None), (True, bg)):
            for cam in cams:
                want = render(*scene, cam, background=background, render_geo=geo, config=cfg)
                assert set(got[n]) == set(want)
                for key in want:
                    assert torch.equal(got[n][key], want[key]), (config, geo, key)
                n += 1
    assert float(got[0]["alpha"].mean()) > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(RENDER_CONFIGS))
def test_compiled_render_replay_makes_no_host_sync(cuda, config):
    """After the capture, replays on other cameras and backgrounds under
    set_sync_debug_mode("error"); the "plain" backend and another model's
    arrays are refused."""
    from hidegs_tpu_torch.raster.compiled import CompiledRender

    cfg = RENDER_CONFIGS[config]
    scene = make_toy_gaussians(600, seed=3, device=cuda)
    comp = CompiledRender()
    bg = torch.zeros(3, device=cuda)
    comp(*scene, ring_camera(0, height=72, width=96, device=cuda), background=bg, render_geo=True, config=cfg)
    cams = [ring_camera(i, height=72, width=96, device=cuda) for i in range(1, 4)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i, cam in enumerate(cams):
            out = comp(*scene, cam, background=bg + 0.1 * i, render_geo=True, config=cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(out["overflow"]) == 0 and len(comp.captures) == 1 and comp.replays == 4
    with pytest.raises(ValueError, match="plain"):
        comp(*scene, cams[0], config=RasterConfig(backend="plain"))
    with pytest.raises(ValueError, match="by reference"):
        comp(*(x.clone() for x in scene), cams[0], background=bg, render_geo=True, config=cfg)


def _served_model(tmp_path, raster_backend):
    """A COLMAP scene of four 48x64 views of a 400-gaussian toy model and
    the model's directory (PLY, cfg_args at tile 16 with `raster_backend`)."""
    from hidegs_tpu_torch import config as tconfig
    from hidegs_tpu_torch.data.synthetic import write_synthetic_colmap_scene
    from hidegs_tpu_torch.utils.ply import gaussian_properties, write_ply

    s = make_toy_gaussians(400, seed=2, device="cpu")
    cams = [ring_camera(i, n_cams=6, height=48, width=64, device="cpu") for i in range(4)]
    write_synthetic_colmap_scene(str(tmp_path / "scene"), s, cams, render_config=RasterConfig(max_instances=1 << 13))
    model = tmp_path / "model"
    (model / "point_cloud" / "iteration_7").mkdir(parents=True)
    op = s.opacities.double()
    write_ply(str(model / "point_cloud" / "iteration_7" / "point_cloud.ply"), gaussian_properties(
        s.means3d.numpy(), s.shs[:, 0].numpy(), s.shs[:, 1:].numpy(),
        torch.log(op / (1.0 - op)).float().numpy(), torch.log(s.scales).numpy(), s.quats.numpy()))
    tconfig.save_cfg_args(str(model), tconfig.ModelConfig(source_path=str(tmp_path / "scene")),
                          tconfig.PipelineConfig(raster_backend=raster_backend, tile=16, max_instances=1 << 13),
                          tconfig.OptimizationConfig())
    return cams, model


def _record_serving(monkeypatch, *modules):
    """The renders `serving_render` makes for `modules`, in order."""
    from hidegs_tpu_torch.raster import compiled

    made = []

    def recording(device, config):
        fn = compiled.serving_render(device, config)
        made.append(fn)
        return fn

    for m in modules:
        monkeypatch.setattr(m, "serving_render", recording)
    return made


@pytest.mark.cuda
def test_serving_entry_points_render_through_replays(cuda, tmp_path, monkeypatch):
    """`evaluate.main`, `render_cli.main` and the viewers' render function
    on the card: each renders through a CompiledRender, one replay per
    view or frame and one capture; render_cli's PNGs equal evaluate's (the
    same tile and budget), the viewer's frames the eager render's."""
    from hidegs_tpu_torch import evaluate, render_cli
    from hidegs_tpu_torch.raster import compiled
    from hidegs_tpu_torch.utils import png
    from hidegs_tpu_torch.viewer import __main__ as viewer_main

    cams, model = _served_model(tmp_path, "pallas")
    made = _record_serving(monkeypatch, evaluate, render_cli)
    direct, replays = cuda_blend.LAUNCHES, _replays()
    evaluate.main(["--model_path", str(model), "--source_path", str(tmp_path / "scene"), "--resolution", "1"])
    render_cli.main(["--model_path", str(model), "--source_path", str(tmp_path / "scene"), "--resolution", "1",
                     "--max_instances", str(1 << 13), "--output_path", str(tmp_path / "cli")])
    torch.cuda.synchronize()
    assert len(made) == 2 and all(isinstance(fn, compiled.CompiledRender) for fn in made)
    assert [(len(fn.captures), fn.replays) for fn in made] == [(1, 4), (1, 4)]
    assert cuda_blend.LAUNCHES - direct == 2 and _replays()[0] - replays[0] == 8
    for i in range(4):
        assert np.array_equal(png.read_image(str(tmp_path / "cli" / f"{i:05d}.png")),
                              png.read_image(str(model / "eval_7" / "train" / "renders" / f"{i:05d}.png"))), i

    scene = make_toy_gaussians(400, seed=2, device=cuda)
    cfg = RasterConfig(max_instances=1 << 13)
    fn = viewer_main.make_render_fn(scene, cfg)
    assert isinstance(fn.compiled, compiled.CompiledRender)
    for cam in cams:
        cam = cam.to(cuda)
        with torch.no_grad():
            want = torch.clamp(render(*scene, cam, config=cfg)["render"], 0, 1)
        assert torch.equal(fn(cam), want)
    assert len(fn.compiled.captures) == 1 and fn.compiled.replays == 4


@pytest.mark.cuda
def test_oracle_entry_points_render_eagerly_on_the_card(cuda, tmp_path, monkeypatch):
    """`evaluate.main` of a model whose cfg_args asks for the "oracle",
    `render_cli.main --backend oracle` and the viewers' render function
    with the oracle, on the card: each keeps the backend the user picked
    and renders it eagerly (no CompiledRender, no capture, no forward
    blend launched); render_cli's PNGs equal evaluate's, the viewer's
    frames the eager oracle's."""
    from hidegs_tpu_torch import evaluate, render_cli
    from hidegs_tpu_torch.utils import png
    from hidegs_tpu_torch.viewer import __main__ as viewer_main

    cams, model = _served_model(tmp_path, "oracle")
    made = _record_serving(monkeypatch, evaluate, render_cli)
    direct, replays = cuda_blend.LAUNCHES, _replays()
    evaluate.main(["--model_path", str(model), "--source_path", str(tmp_path / "scene"), "--resolution", "1"])
    render_cli.main(["--model_path", str(model), "--source_path", str(tmp_path / "scene"), "--resolution", "1",
                     "--backend", "oracle", "--max_instances", str(1 << 13), "--output_path", str(tmp_path / "cli")])
    torch.cuda.synchronize()
    assert made == [render, render]
    assert cuda_blend.LAUNCHES == direct and _replays() == replays
    for i in range(4):
        got = png.read_image(str(tmp_path / "cli" / f"{i:05d}.png"))
        assert got.std() > 0 and np.array_equal(
            got, png.read_image(str(model / "eval_7" / "train" / "renders" / f"{i:05d}.png"))), i

    scene = make_toy_gaussians(400, seed=2, device=cuda)
    cfg = RasterConfig(backend="oracle", max_instances=1 << 13)
    fn = viewer_main.make_render_fn(scene, cfg)
    assert fn.compiled is None
    for cam in cams:
        cam = cam.to(cuda)
        with torch.no_grad():
            want = torch.clamp(render(*scene, cam, config=cfg)["render"], 0, 1)
        assert torch.equal(fn(cam), want)


@pytest.mark.cuda
def test_knn_init_makes_no_host_sync(cuda):
    """`mean_knn_sq_dist` on the card under set_sync_debug_mode("error"),
    within float32 rounding of the CPU result."""
    from hidegs_tpu_torch.model.knn import initial_scales, mean_knn_sq_dist

    g = torch.Generator().manual_seed(0)
    pts = torch.rand((5000, 3), generator=g) * 4.0 - 2.0
    want = mean_knn_sq_dist(pts)
    dev_pts = pts.to(cuda)
    mean_knn_sq_dist(dev_pts)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = mean_knn_sq_dist(dev_pts)
        scales = initial_scales(dev_pts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)
    assert bool(torch.isfinite(scales).all())


# ---------------------------------------------------------------------------
# the preprocess kernels (csrc/preprocess.cu, raster/preprocess_autograd.py)

RADIUS_FLIP_SHARE = 0.01  # tests/test_torch_raster.py
PRE_FLOATS = ("mean2d", "conic", "depth", "inv_depth", "opacity", "rgb", "normal", "distance")
PRE_CASES = {
    "sh_flat_geo": dict(layout="flat", render_geo=True),
    "sh_stacked_deg1": dict(layout="stacked", render_geo=False, active_sh_degree=1),
    "no_antialias": dict(layout="flat", render_geo=True, antialias=False),
    "colors_offset_box": dict(layout="flat", render_geo=True, colors=True, offset=True, box=True),
}


def _pre_problem(dev, case, n=3000, h=72, w=96):
    """A toy scene with random rotations, its leaves requiring grad, and the
    preprocess keywords of `case`."""
    spec = dict(PRE_CASES[case])
    scene = make_toy_gaussians(n, seed=4, device=dev)
    g = torch.Generator(device="cpu").manual_seed(5)
    quats = torch.randn((n, 4), generator=g).to(dev)
    shs = scene.shs + 0.2 * torch.randn(scene.shs.shape, generator=g).to(dev)
    if spec.pop("layout") == "flat":
        shs = shs.reshape(n, -1)
    leaves = dict(means3d=scene.means3d, scales=scene.scales, quats=quats, opacities=scene.opacities, shs=shs)
    kw = dict(screen_bounds=(w, h), active_sh_degree=spec.pop("active_sh_degree", 3))
    if spec.pop("colors", False):
        leaves["colors_precomp"] = torch.rand((n, 3), generator=g).to(dev)
    if spec.pop("offset", False):
        leaves["mean2d_offset"] = torch.zeros((n, 2), device=dev)
    if spec.pop("box", False):
        kw.update(boxmin=torch.full((3,), -1.2, device=dev), boxmax=torch.full((3,), 1.0, device=dev),
                  box_exempt=(torch.arange(n, device=dev) % 5) == 0)
    kw.update(spec)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
    return leaves, kw, ring_camera(2, height=h, width=w, device=dev)


def _pre_call(fn, leaves, kw, cam):
    extra = {k: leaves[k] for k in ("colors_precomp", "mean2d_offset") if k in leaves}
    return fn(leaves["means3d"], leaves["scales"], leaves["quats"], leaves["opacities"], leaves["shs"], cam,
              **kw, **extra)


def _pre_grads(pre, leaves, seed=6):
    dev = pre.mean2d.device
    g = torch.Generator(device=dev).manual_seed(seed)
    cts = [torch.randn(getattr(pre, k).shape, generator=g, device=dev) for k in PRE_FLOATS]
    names = [k for k in leaves if k != "shs" or "colors_precomp" not in leaves]
    outs = [(getattr(pre, k), ct) for k, ct in zip(PRE_FLOATS, cts) if getattr(pre, k).requires_grad]
    grads = torch.autograd.grad([o for o, _ in outs], [leaves[k] for k in names], [ct for _, ct in outs])
    return dict(zip(names, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PRE_CASES))
def test_preprocess_kernel_matches_plain_forward(cuda, case):
    """preprocess_gaussians on the card (one preprocess_fwd launch) against
    preprocess_plain on the card: floats at atol 1e-5 / rtol 1e-5, the
    visible mask equal, the radius within 1 on RADIUS_FLIP_SHARE of the
    rows at most."""
    from hidegs_tpu_torch.raster import preprocess_autograd

    leaves, kw, cam = _pre_problem(cuda, case)
    before = (preprocess_autograd.FWD_LAUNCHES, preprocess_autograd.BWD_LAUNCHES)
    got = _pre_call(tpp.preprocess_gaussians, leaves, kw, cam)
    torch.cuda.synchronize()
    assert (preprocess_autograd.FWD_LAUNCHES, preprocess_autograd.BWD_LAUNCHES) == (before[0] + 1, before[1])
    with torch.no_grad():
        want = _pre_call(tpp.preprocess_plain, leaves, kw, cam)
    assert torch.equal(got.visible, want.visible) and 0 < int(got.visible.sum()) < got.visible.shape[0]
    dr = (got.radius - want.radius).abs()
    assert int(dr.max()) <= 1 and float((dr > 0).float().mean()) <= RADIUS_FLIP_SHARE
    for k in PRE_FLOATS:
        torch.testing.assert_close(getattr(got, k), getattr(want, k), atol=1e-5, rtol=1e-5, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PRE_CASES))
def test_preprocess_backward_kernel_matches_autograd_of_plain(cuda, case):
    """The Function's gradients (one preprocess_bwd launch) against torch
    autograd of preprocess_plain on the card, on the same cotangents of all
    eight float outputs: within 5e-3 of each leaf's max |grad| (the JAX
    suite's gradient tolerance)."""
    from hidegs_tpu_torch.raster import preprocess_autograd

    leaves, kw, cam = _pre_problem(cuda, case)
    pre = _pre_call(tpp.preprocess_gaussians, leaves, kw, cam)
    before = preprocess_autograd.BWD_LAUNCHES
    got = _pre_grads(pre, leaves)
    torch.cuda.synchronize()
    assert preprocess_autograd.BWD_LAUNCHES == before + 1
    want = _pre_grads(_pre_call(tpp.preprocess_plain, leaves, kw, cam), leaves)
    assert got.keys() == want.keys()
    for k in want:
        scale = float(want[k].abs().max())
        err = float((got[k] - want[k]).abs().max()) / scale
        assert scale > 0 and err <= 5e-3, f"{case} {k}: {err:.3e} of the max |grad|"


@pytest.mark.cuda
def test_preprocess_kernels_are_bitwise_reproducible_and_sync_free(cuda):
    """Two forward and backward runs of the kernels on the same inputs are
    bitwise equal (no atomics), the second under
    set_sync_debug_mode("error"); absent cotangents are taken as they are."""
    leaves, kw, cam = _pre_problem(cuda, "colors_offset_box")
    runs = []
    for k in range(2):
        if k:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            pre = _pre_call(tpp.preprocess_gaussians, leaves, kw, cam)
            grads = _pre_grads(pre, leaves)
            again = _pre_call(tpp.preprocess_gaussians, leaves, kw, cam)
            partial = torch.autograd.grad(again.conic.sum() + again.opacity.sum(), [leaves["scales"]])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        runs.append((pre.tensors(), list(grads.values()) + list(partial)))
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_binning_owner_is_the_cummax_owner_on_the_render_cell(cuda):
    """C40: on the render cell's rows (the 1,010,240-gaussian UAV scene,
    view 0 at 1920x1088, tile 32), the searchsorted owner of every
    expansion slot is bitwise the owner of the scatter-and-cummax form it
    replaced."""
    from hidegs_tpu_torch.data.synthetic import make_uav_gaussians, nadir_grid_camera

    scene = make_uav_gaussians(n_ground=1_000_000, n_structs=64, seed=0, device=cuda)
    cam = nadir_grid_camera(0, 0, 2, 2, altitude=14.0, height=1088, width=1920, device=cuda)
    tile, max_instances = 32, 1 << 21
    ty, tx = tbin.tile_grid(1088, 1920, tile)
    with torch.no_grad():
        pre = tpp.preprocess_gaussians(*scene, cam, render_geo=True, screen_bounds=(tx * tile, ty * tile))
    tb = tbin.bin_gaussians(pre, ty, tx, max_instances, tile, depth_bits=-1)
    x0, y0, x1, y1 = tbin.compute_tight_rects(pre.mean2d, pre.conic, pre.opacity, pre.radius, ty, tx, tile)
    touched = torch.where(pre.visible, (x1 - x0) * (y1 - y0), torch.zeros_like(x0))
    starts = torch.cumsum(touched, 0, dtype=torch.int32) - touched
    total = starts[-1] + touched[-1]
    N = touched.shape[0]
    dest = torch.where((touched > 0) & (starts < max_instances), starts, max_instances)
    owner_at = torch.zeros((max_instances + 1,), dtype=torch.int32, device=cuda)
    owner_at.scatter_(0, dest.long(), torch.arange(N, dtype=torch.int32, device=cuda))
    slots = torch.arange(max_instances, dtype=torch.int32, device=cuda)
    old = torch.where(slots < total, torch.cummax(owner_at[:max_instances], 0).values, N).to(torch.int32)
    assert int(tb.overflow) == 0 and int(total) > 100_000
    assert torch.equal(tb.owner, old)


# the post-opt cell's hierarchy rows (gsbench's uav-whu-1m-hier-postopt)
ADAM_ROWS = {"small": 1001, "cell": 2_020_479}
ADAM_CASES = ("all", "none", "half", "frozen", "prefix", "unaligned")


def _adam_problem(dev, rows, case, lr_kind, seed=0):
    """Params, gradients, moments, steps, mask and learning rates of `rows`
    rows at the port's leaf widths (3, 3, 45, 3, 4, 1). Steps are 0, 1 and
    up to 2^20; v is positive. "half": a random half of the rows, gradients
    sliced out of one packed (rows, 59) matrix (the post-opt step's
    layout); "frozen": that half less a frozen quarter, the SH gradients
    sliced out of one (rows, 48) matrix (the train step's); "prefix": every
    tensor the first `rows` rows of buffers twice as long (the row-budget
    view); "unaligned": every leaf starting one row into its buffer."""
    from hidegs_tpu_torch.model import adam
    from hidegs_tpu_torch.model.gaussians import GaussianParams

    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = dict(xyz=(3,), sh_dc=(3,), sh_rest=(15, 3), scaling=(3,), rotation=(4,), opacity=())
    lead = {"prefix": (0, 2 * rows), "unaligned": (1, rows + 1)}.get(case, (0, rows))

    def leaves(positive=False):
        out = []
        for f in GaussianParams._fields:
            x = torch.randn((lead[1], *shapes[f]), generator=gen, device=dev)[lead[0]:lead[0] + rows]
            out.append(x.abs() if positive else x)
        return GaussianParams(*out)

    params = leaves()
    step = torch.randint(0, 1 << 20, (lead[1],), generator=gen, device=dev, dtype=torch.int32)[lead[0]:lead[0] + rows]
    step[:rows // 3] = 0
    step[rows // 3:rows // 2] = 1
    opt = adam.AdamState(m=leaves(), v=leaves(positive=True), step=step)
    grads = leaves()
    if case == "half":
        packed = torch.cat([g.reshape(rows, -1) for g in grads], dim=1)
        widths = [g[0].numel() if g.ndim > 1 else 1 for g in grads]
        grads = GaussianParams(*(p.reshape(g.shape) for p, g in zip(torch.split(packed, widths, dim=1), grads)))
    if case == "frozen":
        sh = torch.cat([grads.sh_dc.reshape(rows, 1, 3), grads.sh_rest], dim=1)
        grads = grads._replace(sh_dc=sh[:, 0], sh_rest=sh[:, 1:])
    u = torch.rand((lead[1],), generator=gen, device=dev)[lead[0]:lead[0] + rows]
    visible = {"all": u >= 0, "none": u < 0}.get(case, u < 0.5)
    if case == "frozen":
        visible = visible & ~(torch.rand((rows,), generator=gen, device=dev) < 0.25)
    scalar = lambda x: torch.tensor(x, device=dev) if lr_kind == "tensor" else x  # noqa: E731
    lr = GaussianParams(xyz=scalar(1.6e-4 * 3.7), sh_dc=2.5e-3, sh_rest=scalar(2.5e-3 / 20), scaling=5e-3,
                        rotation=1e-3, opacity=scalar(5e-2))
    return params, grads, opt, lr, visible


def _adam_tensors(params, opt):
    return [*params, *opt.m, *opt.v, opt.step]


@pytest.mark.cuda
@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
@pytest.mark.parametrize("case", ADAM_CASES)
@pytest.mark.parametrize("size", sorted(ADAM_ROWS))
def test_masked_adam_kernel_is_bitwise_the_plain_update(cuda, size, case, lr_kind):
    """One kernel launch is bitwise masked_adam_plain on the card, over
    every leaf, moment and step, out of place (inputs untouched) and in
    place on clones (the donated form); rows outside the mask keep their
    bits either way."""
    from hidegs_tpu_torch.model import adam

    params, grads, opt, lr, visible = _adam_problem(cuda, ADAM_ROWS[size], case, lr_kind)
    assert case not in ("half", "frozen") or not grads.sh_rest.is_contiguous()
    before = [x.clone() for x in _adam_tensors(params, opt)]
    want = _adam_tensors(*adam.masked_adam_plain(params, grads, opt, lr, visible))
    launches = adam.LAUNCHES
    got = _adam_tensors(*adam.masked_adam_update(params, grads, opt, lr, visible))
    assert adam.LAUNCHES == launches + 1
    for n, (a, b) in enumerate(zip(got, want, strict=True)):
        assert torch.equal(a, b), f"{case}: tensor {n}"
    assert all(torch.equal(a, b) for a, b in zip(_adam_tensors(params, opt), before)), "the inputs changed"
    donated_p = type(params)(*(x.clone() for x in params))
    donated_opt = type(opt)(*(type(params)(*(x.clone() for x in leaves)) for leaves in opt[:2]), opt.step.clone())
    mine = [x.data_ptr() for x in _adam_tensors(donated_p, donated_opt)]
    in_place = _adam_tensors(*adam.masked_adam_update(donated_p, grads, donated_opt, lr, visible, in_place=True))
    assert [x.data_ptr() for x in in_place] == mine
    for n, (a, b) in enumerate(zip(in_place, want, strict=True)):
        assert torch.equal(a, b), f"{case} in place: tensor {n}"
    off = ~visible
    for new, old in zip(in_place, before):
        assert torch.equal(new[off], old[off]), f"{case}: a row outside the mask changed"


@pytest.mark.cuda
def test_masked_adam_kernel_captures_without_a_host_sync(cuda):
    """The update with a 0-d device learning rate runs eagerly under
    set_sync_debug_mode("error") and captures as a CUDA graph, in place on
    static buffers: each replay, the learning rate moved between them, is
    bitwise the plain update of the state before it; one launch recorded,
    none made by a replay."""
    from hidegs_tpu_torch.model import adam
    from hidegs_tpu_torch.utils import graphs

    params, grads, opt, lr, visible = _adam_problem(cuda, ADAM_ROWS["small"], "half", "tensor")
    state = [x.clone() for x in _adam_tensors(params, opt)]
    static_p = type(params)(*state[:6])
    static_opt = type(opt)(type(params)(*state[6:12]), type(params)(*state[12:18]), state[18])
    gs = graphs.GraphSet("masked adam")

    def body():
        adam.masked_adam_update(static_p, grads, static_opt, lr, visible, in_place=True)

    def scratch():
        warm = [x.clone() for x in state]
        adam.masked_adam_update(type(params)(*warm[:6]), grads, type(opt)(
            type(params)(*warm[6:12]), type(params)(*warm[12:18]), warm[18]), lr, visible, in_place=True)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scratch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g = gs.capture(cuda, scratch, body, {})
    assert g.launches == dict(dict.fromkeys(graphs.KERNELS, 0), masked_adam=1)
    for k in range(3):
        old = [x.clone() for x in state]
        want = _adam_tensors(*adam.masked_adam_plain(type(params)(*old[:6]), grads, type(opt)(
            type(params)(*old[6:12]), type(params)(*old[12:18]), old[18]), lr, visible))
        launches, replays = adam.LAUNCHES, graphs.REPLAY_LAUNCHES["masked_adam"]
        gs.replay(g)
        torch.cuda.synchronize()
        assert adam.LAUNCHES == launches and graphs.REPLAY_LAUNCHES["masked_adam"] == replays + 1
        for n, (a, b) in enumerate(zip(state, want, strict=True)):
            assert torch.equal(a, b), f"replay {k}: tensor {n}"
        lr.xyz.mul_(0.5)
