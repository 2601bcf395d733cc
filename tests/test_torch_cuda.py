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
and makes no host synchronisation with the chunk box set. The post-opt
step of the hierarchy (train/hier_trainer.py) holds the same way, and
the pipeline runs on the card end to end.
"""
import pathlib

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
                         "hidegs_fold_rows_scalar", 2, 1, 2)
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


@pytest.mark.cuda
def test_lod_frame_kernel_holds_against_plain(cuda):
    """One AdaptiveHierRenderer frame of a built hierarchy on the card: one
    forward launch, and its tile planes against the plain blend on the
    frame's own rows and binning; the same frame again bitwise equal."""
    from hidegs_tpu_torch.hier.build import build_hierarchy
    from hidegs_tpu_torch.hier.interp import AdaptiveHierRenderer

    scene = make_toy_gaussians(2000, seed=5, device="cpu")
    h = build_hierarchy(*(x.numpy() for x in (scene.means3d, scene.quats, scene.scales, scene.opacities,
                                                scene.shs)), use_native=True)

    r = AdaptiveHierRenderer.from_hierarchy(h, cuda)
    cam = ring_camera(0, height=96, width=128, device=cuda)
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


@pytest.mark.cuda
def test_post_opt_step_kernels_hold_against_plain(cuda):
    """One post-opt step (exposure on): one launch of each kernel; the
    blend node's forward planes against the plain blend and its backward +
    fold against the plain backward, on the node's own rows, binning and
    cotangents; the whole step against the "plain" backend: loss at rtol
    1e-3, Adam's first moments normalised at 1e-3."""
    import dataclasses

    from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
    from hidegs_tpu_torch.train import hier_trainer as ht

    ts, cams, gts, rcfg, target, budget = _post_opt_problem(cuda)
    cut = ht.select_cut(ts, cams[0], target, budget)
    assert bool(((cut.ts > 0) & (cut.ts < 1) & cut.valid).any())
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
def test_post_opt_step_is_bitwise_deterministic(cuda):
    """Two post-opt steps from one state: params, moments, per-row step
    counts and exposure bitwise equal (the parents' gradients are summed by
    the sorted index_put_ of the interpolation's gathers)."""
    from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
    from hidegs_tpu_torch.train import hier_trainer as ht

    ts, cams, gts, rcfg, target, budget = _post_opt_problem(cuda)
    cut = ht.select_cut(ts, cams[1], target, budget)
    lrs = lr_tree(ts.step, LRConfig(), 1.0)
    kw = dict(image_idx=1, use_exposure=True, optimize_exposure=True)
    a, ma = ht.hier_train_step(ts, cut, cams[1], gts[1], lrs, rcfg, **kw)
    b, mb = ht.hier_train_step(ts, cut, cams[1], gts[1], lrs, rcfg, **kw)
    for x, y in zip(list(a.params) + list(a.opt.m) + list(a.opt.v) + [a.opt.step, a.exposure, a.exposure_m],
                    list(b.params) + list(b.opt.m) + list(b.opt.v) + [b.opt.step, b.exposure, b.exposure_m]):
        assert torch.equal(x, y)
    assert torch.equal(ma["loss"], mb["loss"]) and float(ma["loss"]) > 0


@pytest.mark.cuda
def test_post_opt_step_makes_no_host_sync(cuda):
    """select_cut, the learning rates and a post-opt step with exposure and
    frozen anchors under torch.cuda.set_sync_debug_mode("error")."""
    from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
    from hidegs_tpu_torch.train import hier_trainer as ht

    ts, cams, gts, rcfg, target, budget = _post_opt_problem(cuda)
    frozen = torch.zeros(ts.params.xyz.shape[0], dtype=torch.bool, device=cuda)
    frozen[::7] = True
    kw = dict(frozen=frozen, image_idx=2, use_exposure=True, optimize_exposure=True)

    def step(state):
        cut = ht.select_cut(state, cams[2], target, budget)
        return ht.hier_train_step(state, cut, cams[2], gts[2], lr_tree(state.step, LRConfig(), 1.0), rcfg, **kw)

    ts, _ = step(ts)  # builds the kernels and the loss constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, m = step(ts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(new.step) == 2 and bool(torch.isfinite(m["loss"]))
    assert torch.equal(new.params.xyz[frozen], ts.params.xyz[frozen])


@pytest.mark.cuda
def test_pipeline_runs_on_the_card(cuda, tmp_path):
    """run_pipeline on the two-cluster scene on the card (3 chunk and 3
    post-opt iterations, eval at tau 0 and 3): two chunks, finite merged
    and post-optimized hierarchies; one backward and fold per train and
    post-opt step, and one forward more per (tau, view) of the eval."""
    import json
    import os

    import numpy as np

    from hidegs_tpu_torch import pipeline
    from hidegs_tpu_torch.hier import io as hio
    from torch_scenes import write_two_cluster_scene

    src = write_two_cluster_scene(tmp_path / "scene")
    out = str(tmp_path / "out")
    before = _counts()
    pipeline.run_pipeline(src, out, chunk_size=14.0, min_n_cams=3, iterations=3, post_opt_iterations=3,
                          capacity=256, max_instances=1 << 12, add_far_cams=False, log_every=1000,
                          eval_taus=(0.0, 3.0), device="cuda")
    torch.cuda.synchronize()
    fwd, bwd, fold = (x - y for x, y in zip(_counts(), before))
    meta = json.load(open(os.path.join(out, "pipeline.json")))
    assert len(meta["chunks"]) == 2 and len(meta["lod_eval"]) == 2
    n_eval = 2 * 8  # two taus, eight of the ten views
    assert bwd == fold == 3 * 2 + 3 and fwd == bwd + n_eval, (fwd, bwd, fold)
    for name in ("merged.hier", "merged_opt.hier"):
        h = hio.read_hier(os.path.join(out, name))
        assert all(np.isfinite(getattr(h, f)).all() for f in ("pos", "rot", "scale", "alpha", "shs"))
    assert all(np.isfinite(r["psnr"]) and r["mean_cut"] > 0 for r in meta["lod_eval"])


# ---------------------------------------------------------------------------
# the view-parallel step (parallel/sharded.py) on the card


def _dp_problem(dev, n=2000, hw=128, views=4):
    from hidegs_tpu_torch.model.gaussians import init_from_points
    from hidegs_tpu_torch.train import loop as tl

    scene = make_toy_gaussians(n, seed=0, device=dev)
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


def _two_gloo_ranks(dev, runs, tmp_path):
    from hidegs_tpu_torch.parallel import dryrun

    ts0, views, cfg = _dp_problem(dev)
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
