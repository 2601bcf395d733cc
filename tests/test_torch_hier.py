"""Port parity: the LOD hierarchy (hier/io, build, lod, interp) of
hidegs_tpu_torch against hidegs_tpu, on the CPU.

Inputs are numpy-seeded toy leaves (48-400 gaussians) and 64x64 views.
Tolerances, and why:
  * `.hier` files, the native builder's output, every integer field of a
    cut (padding slots included) and expand_to_target: exactly equal (the
    same bytes, the same C++ source and flags, the same integer
    arithmetic);
  * the NumPy fallback builder: 1e-5 (the float32 covariance and quaternion
    of each package's transforms);
  * `ts` and interpolate_cut's values and gradients: 1e-6;
  * frames: the blend tolerance, atol 3e-4 / rtol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidegs_tpu.data import synthetic as jsyn
from hidegs_tpu.hier import build as jbuild
from hidegs_tpu.hier import interp as jinterp
from hidegs_tpu.hier import io as jio
from hidegs_tpu.hier import lod as jlod
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.hier import build as tbuild
from hidegs_tpu_torch.hier import interp as tinterp
from hidegs_tpu_torch.hier import io as tio
from hidegs_tpu_torch.hier import lod as tlod
from hidegs_tpu_torch.raster.api import RasterConfig

torch.set_num_threads(1)

BLEND_TOL = dict(atol=3e-4, rtol=1e-3)
FIELDS = ("render_indices", "parent_indices", "node_of", "kids", "valid")


def toy_leaves(n, seed=0, extent=2.0):
    """(pos, rot, scale, alpha, shs) numpy leaves: a cube of half-width
    `extent`, log-uniform scales, DC-only colour."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    scale = np.exp(rng.uniform(np.log(0.02), np.log(0.12), (n, 3))).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    alpha = rng.uniform(0.3, 0.95, n).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = (rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32) - 0.5) / 0.28209479177387814
    return pos, rot, scale, alpha, shs


def tcam_of(cam):
    leaves = [np.asarray(x) for x in (cam.R, cam.t, cam.fx, cam.fy, cam.cx, cam.cy)]
    return convert.camera_from_jax(*leaves, cam.height, cam.width, device="cpu")


def t(x):
    return torch.as_tensor(np.array(x))


def hier_arrays(h):
    """(nodes, boxes, pos, scales, rot, alpha, shs) of a hierarchy, as torch
    tensors and as jnp arrays."""
    host = (h.nodes, h.boxes, h.pos, np.exp(h.scale), h.rot, h.alpha, h.shs)
    return [torch.as_tensor(x) for x in host], [jnp.asarray(x) for x in host]


def assert_hier_equal(a, b):
    for name in tio.Hierarchy._fields:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.fixture(scope="module")
def hier96():
    return jbuild._build_hierarchy_py(*toy_leaves(96, seed=9))


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hier_files_read_equal_in_both_packages(tmp_path, compressed, writer):
    h = jbuild._build_hierarchy_py(*toy_leaves(48, seed=2))
    path = str(tmp_path / "h.hier")
    (jio if writer == "jax" else tio).write_hier(path, h, compressed=compressed)
    assert_hier_equal(tio.read_hier(path), jio.read_hier(path))
    if not compressed:
        assert_hier_equal(tio.read_hier(path), h)
    anchors = np.array([3, 1, 4, 1, 5], np.int32)
    (jio if writer == "jax" else tio).write_anchors(str(tmp_path / "a.bin"), anchors)
    np.testing.assert_array_equal(tio.read_anchors(str(tmp_path / "a.bin")), jio.read_anchors(str(tmp_path / "a.bin")))


def test_native_builder_output_equals_jax_bitwise():
    if jbuild._load_native() is None:
        pytest.skip("no C++ toolchain")
    leaves = toy_leaves(200, seed=1)
    assert_hier_equal(tbuild.build_hierarchy(*leaves, use_native=True),
                      jbuild.build_hierarchy(*leaves, use_native=True))


def test_python_builder_matches_jax():
    leaves = toy_leaves(48, seed=3)
    got = tbuild.build_hierarchy(*leaves, use_native=False)
    want = jbuild._build_hierarchy_py(*leaves)
    np.testing.assert_array_equal(got.nodes, want.nodes)
    for name in ("pos", "rot", "scale", "alpha", "shs", "boxes"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=1e-5, rtol=1e-5, err_msg=name)


def test_native_builder_matches_python_fallback():
    """As tests/test_hier.py::test_native_builder_matches_python."""
    leaves = toy_leaves(48, seed=1)
    hc = tbuild.build_hierarchy(*leaves, use_native=True)
    hp = tbuild.build_hierarchy_py(*leaves)
    assert hc.num_points == hp.num_points and hc.num_nodes == hp.num_nodes
    np.testing.assert_array_equal(hc.nodes, hp.nodes)
    np.testing.assert_allclose(hc.pos, hp.pos, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(hc.alpha, hp.alpha, rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(np.sort(hc.scale, axis=1), np.sort(hp.scale, axis=1), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("case", ["tau0", "tau2", "tau8", "over_budget"])
def test_cut_matches_jax_on_every_slot(hier96, case):
    h = hier96
    cam = jsyn.ring_camera(0, n_cams=4, height=64, width=64)
    vp = np.asarray(cam.camera_center, np.float32)
    tau = {"tau0": 0.0, "tau2": 2.0, "tau8": 8.0, "over_budget": 0.0}[case]
    target = 0.0 if tau == 0 else jlod.tau_to_target_size(tau, float(cam.fx))
    assert target == tlod.tau_to_target_size(tau, float(cam.fx)) or tau == 0
    budget = 40 if case == "over_budget" else 256
    (tn, tb, *_), (jn, jb, *_) = hier_arrays(h)
    want = jlod.expand_to_size(jn, jb, jnp.float32(target), jnp.asarray(vp), budget=budget,
                               num_points=h.num_points)
    got = tlod.expand_to_size(tn, tb, target, torch.as_tensor(vp), budget=budget, num_points=h.num_points)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.ts.numpy(), np.asarray(want.ts), atol=1e-6, rtol=0)
    n = int(got.num_selected)
    assert n == int(want.num_selected)
    assert n == int(tlod.cut_size(tn, tb, target, torch.as_tensor(vp)))
    if case == "over_budget":
        assert n > budget and bool(got.valid.all())
    else:
        assert n == int(got.valid.sum())
    # the packed select gives the same cut, and no num_points picks the sentinel P
    packed = tlod.pack_hierarchy(tn, tb)
    again = tlod.expand_packed(packed, target, torch.as_tensor(vp), budget=budget)
    jagain = jlod.expand_packed(jlod.pack_hierarchy(jn, jb), jnp.float32(target), jnp.asarray(vp), budget=budget)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(again, name).numpy(), np.asarray(getattr(jagain, name)), err_msg=name)


def test_node_size_matches_jax(hier96):
    rng = np.random.default_rng(4)
    for vp in rng.normal(size=(4, 3)).astype(np.float32) * 3.0:
        np.testing.assert_allclose(tlod.node_size(t(hier96.boxes), t(vp)).numpy(),
                                   np.asarray(jlod.node_size(jnp.asarray(hier96.boxes), jnp.asarray(vp))),
                                   rtol=1e-6)


@pytest.mark.parametrize("target", [-1, 0, 2, 4])
def test_expand_to_target_is_jax(hier96, target):
    np.testing.assert_array_equal(tlod.expand_to_target(hier96.nodes, target),
                                  jlod.expand_to_target(hier96.nodes, target))


def test_opacity_correction_values_and_gradients_match_jax():
    rng = np.random.default_rng(7)
    n = 64
    alpha = rng.uniform(0, 1, n).astype(np.float32)
    alpha[:3] = [1.0, 0.0, 0.999999]  # 1-α below the 1e-8 clamp, at 0, near it
    ts = rng.uniform(0, 1, n).astype(np.float32)
    ts[3:5] = [0.0, 1.0]
    kids = rng.integers(0, 4, n).astype(np.int32)
    ct = rng.normal(size=n).astype(np.float32)
    want, vjp = jax.vjp(lambda a, s: jlod.hierarchy_opacity_correction(a, s, jnp.asarray(kids)),
                        jnp.asarray(alpha), jnp.asarray(ts))
    ga_want, gt_want = vjp(jnp.asarray(ct))
    a, s = t(alpha).requires_grad_(True), t(ts).requires_grad_(True)
    got = tlod.hierarchy_opacity_correction(a, s, t(kids))
    got.backward(t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga_want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gt_want), atol=1e-6, rtol=1e-6)


def jax_cut_spread(cut, num_points):
    """`cut` as a JAX HierCut whose padding slots point at row (slot mod P),
    the rows the port's interpolate_cut gathers for them (the JAX package
    clamps them to row P - 1)."""
    valid = cut.valid.numpy()
    spread = np.arange(valid.shape[0], dtype=np.int32) % num_points
    fields = cut._replace(render_indices=np.where(valid, cut.render_indices.numpy(), spread),
                          parent_indices=np.where(valid, cut.parent_indices.numpy(), spread))
    return jlod.HierCut(*[jnp.asarray(np.asarray(x)) for x in fields])


def test_interpolate_cut_values_and_gradients_match_jax(hier96):
    h = hier96
    cam = jsyn.ring_camera(1, n_cams=4, height=64, width=64)
    vp = np.asarray(cam.camera_center, np.float32)
    (tn, tb, *tarr), (jn, jb, *_) = hier_arrays(h)
    # the finest target whose cut interpolates a slot with its parent
    # (0 < t < 1); that slot gets a rotation pair with a dot product of 0
    for target in (0.05, 0.1, 0.15, 0.2, 0.3, 0.5):
        cut = tlod.expand_to_size(tn, tb, target, t(vp), budget=160, num_points=h.num_points)
        ts = cut.ts.numpy()
        if ((ts > 0) & (ts < 1)).any():
            break
    k = int(np.argmax((ts > 0) & (ts < 1) & cut.valid.numpy()))
    assert 0 < ts[k] < 1
    rot = h.rot.copy()
    rot[int(cut.render_indices[k])] = [1.0, 0.0, 0.0, 0.0]
    rot[int(cut.parent_indices[k])] = [0.0, 0.0, 1.0, 0.0]
    skybox = 5
    host = [h.pos, np.exp(h.scale), rot, h.alpha, h.shs]
    # JAX's function on the cut with the port's padding rows: every slot held
    assert not bool(cut.valid.all())
    jcut = jax_cut_spread(cut, h.num_points)
    want, vjp = jax.vjp(lambda *a: tuple(jinterp.interpolate_cut(jcut, *a, skybox_count=skybox)),
                        *[jnp.asarray(x) for x in host])
    leaves = [t(x).requires_grad_(True) for x in host]
    got = tinterp.interpolate_cut(cut, *leaves, skybox_count=skybox)
    rng = np.random.default_rng(8)
    cts = [rng.normal(size=np.shape(w)).astype(np.float32) for w in want]
    torch.autograd.backward(list(got), [t(c) for c in cts])
    grads_want = vjp(tuple(jnp.asarray(c) for c in cts))
    for name, g, w in zip(tinterp.InterpolatedGaussians._fields, got, want):
        assert g.shape[0] == 160 + skybox
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-6, rtol=1e-6, err_msg=name)
    assert not got.opacities[:160][~cut.valid].any()
    for name, leaf, w in zip(["means", "scales", "quats", "opacities", "shs"], leaves, grads_want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6, err_msg=name)
    # the packed attribute matrix passed in gives the same arrays
    again = tinterp.interpolate_cut(cut, *[x.detach() for x in leaves], skybox_count=skybox,
                                    attrs=tinterp.pack_attributes(*[x.detach() for x in leaves]))
    for g, a in zip(got, again):
        assert torch.equal(g.detach(), a)


@pytest.fixture(scope="module")
def scene48():
    leaves = toy_leaves(48, seed=4)
    h = jbuild._build_hierarchy_py(*leaves)
    cam = jsyn.ring_camera(0, height=64, width=64)
    return h, cam, tcam_of(cam)


def _assert_frames_close(got, want, keys=("render", "alpha", "invdepth", "T_final")):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **BLEND_TOL)


def test_render_hierarchy_and_fused_frame_match_jax(scene48):
    h, jcam, tcam = scene48
    (tn, tb, *tarr), (jn, jb, *jarr) = hier_arrays(h)
    vp = np.asarray(jcam.camera_center, np.float32)
    jcfg, tcfg = JConfig(backend="jnp", max_instances=1 << 13), RasterConfig(max_instances=1 << 13)
    for target in (1e-9, 0.02):
        jcut = jlod.expand_to_size(jn, jb, target, jnp.asarray(vp), budget=128, num_points=h.num_points)
        tcut = tlod.expand_to_size(tn, tb, target, t(vp), budget=128, num_points=h.num_points)
        want = jinterp.render_hierarchy(jcut, *jarr, jcam, config=jcfg)
        got = tinterp.render_hierarchy(tcut, *tarr, tcam, config=tcfg)
        _assert_frames_close(got, want)
        np.testing.assert_array_equal(got["out_observe"].numpy(), np.asarray(want["out_observe"]))
    target = 0.02
    jfused = jinterp.fused_lod_frame(jlod.pack_hierarchy(jn, jb), jnp.float32(target), jcam, *jarr, budget=256,
                                     num_points=h.num_points, config=jcfg)
    tfused = tinterp.fused_lod_frame(tlod.pack_hierarchy(tn, tb), target, tcam, *tarr, budget=256,
                                     num_points=h.num_points, config=tcfg)
    _assert_frames_close(tfused, jfused)
    assert int(tfused["num_selected"]) == int(jfused["num_selected"])


def test_render_coarse_matches_jax(scene48):
    h, jcam, tcam = scene48
    (tn, tb, *tarr), (jn, jb, *jarr) = hier_arrays(h)
    want = jinterp.render_coarse(jn, jb, *jarr, jcam, coarse_target_size=0.05, budget=128,
                                 config=JConfig(backend="jnp", max_instances=1 << 13))
    got = tinterp.render_coarse(tn, tb, *tarr, tcam, coarse_target_size=0.05, budget=128,
                                config=RasterConfig(max_instances=1 << 13))
    _assert_frames_close(got, want)


def test_leaf_cut_renders_the_leaves(scene48):
    """At the finest cut the hierarchy render is the leaf render (the bar of
    tests/test_hier.py::test_hierarchy_render_matches_leaf_render)."""
    from hidegs_tpu_torch.raster.api import render
    from hidegs_tpu_torch.train.losses import psnr

    h, _, tcam = scene48
    (tn, tb, *tarr), _ = hier_arrays(h)
    pos, rot, scale, alpha, shs = toy_leaves(48, seed=4)
    cfg = RasterConfig(max_instances=1 << 13)
    cut = tlod.expand_to_size(tn, tb, 0.0, tcam.camera_center, budget=128, num_points=h.num_points)
    assert int(cut.num_selected) == 48
    out_h = tinterp.render_hierarchy(cut, *tarr, tcam, config=cfg)
    out_l = render(t(pos), t(scale), t(rot), t(alpha), t(shs), tcam, config=cfg)
    assert float(psnr(out_h["render"], out_l["render"])) > 40


def _renderers(h, n_jax_backend="jnp"):
    (tn, tb, *tarr), (jn, jb, *jarr) = hier_arrays(h)
    jr = jinterp.AdaptiveHierRenderer(jn, jb, *jarr, num_points=h.num_points, backend=n_jax_backend)
    tr = tinterp.AdaptiveHierRenderer(tn, tb, *tarr, num_points=h.num_points)
    return jr, tr


def test_adaptive_renderer_budgets_and_frames_match_jax():
    """tests/test_hier.py::test_cut_size_matches_expand_and_adaptive_renderer
    on the port, and each frame against the JAX renderer's."""
    h = jbuild.build_hierarchy(*toy_leaves(400, seed=5))
    jcam = jsyn.ring_camera(0, n_cams=4, height=64, width=64)
    tcam = tcam_of(jcam)
    jr, tr = _renderers(h)
    sizes = []
    for tau in (0.0, 2.0, 8.0):
        target = tr.target_size(tcam, tau)
        n = int(tlod.cut_size(tr.nodes, tr.boxes, target, tcam.camera_center))
        cut = tlod.expand_to_size(tr.nodes, tr.boxes, target, tcam.camera_center, budget=2048,
                                  num_points=h.num_points)
        assert n == int(cut.num_selected) == int(cut.valid.sum())
        sizes.append(n)
    assert sizes[0] >= sizes[1] >= sizes[2] and sizes[0] == 400
    frames = []
    for tau in (0.0, 8.0):
        got, want = tr.render(tcam, tau), jr.render(jcam, tau)
        assert tr._budget == jr._budget and tr._max_inst == jr._max_inst
        assert tr._count_cache["n_cut"] == jr._count_cache["n_cut"]
        _assert_frames_close(got, want)
        assert int(got["num_selected"]) == int(want["num_selected"])
        frames.append((got, tr._budget))
    (out_fine, b_fine), (out_coarse, b_coarse) = frames
    assert b_coarse <= b_fine and b_fine >= sizes[0] and b_coarse >= sizes[2]
    m_f, m_c = float(out_fine["render"].mean()), float(out_coarse["render"].mean())
    assert abs(m_f - m_c) <= 0.25 * max(m_f, 1e-6)
    # the adaptive frame equals a fixed-budget render of the same cut
    cut = tlod.expand_to_size(tr.nodes, tr.boxes, 0.0, tcam.camera_center, budget=2048, num_points=h.num_points)
    fixed = tinterp.render_hierarchy(cut, *tr.arrays, tcam, config=RasterConfig(max_instances=1 << 15))
    np.testing.assert_allclose(out_fine["render"].numpy(), fixed["render"].numpy(), rtol=1e-4, atol=1e-5)


def test_adaptive_renderer_count_cache_behaves_as_jax():
    """tests/test_hier.py::test_adaptive_renderer_count_cache on the port."""
    h = jbuild.build_hierarchy(*toy_leaves(3000, seed=7))
    jr, r = _renderers(h)
    cam0 = tcam_of(jsyn.ring_camera(0, n_cams=4, height=48, width=48))
    out0 = r.render(cam0, 2.0)
    assert r._count_cache is not None and r._count_cache["frames"] == 0
    n0 = r._count_cache["n_cut"]
    out1 = r.render(cam0, 2.0)  # same frame → cache hit
    assert r._count_cache["frames"] == 1 and r._count_cache["n_cut"] == n0
    assert torch.equal(out1["render"], out0["render"])
    r.render(cam0, 8.0)  # tau change → recount
    assert r._count_cache["tau"] == 8.0 and r._count_cache["frames"] == 0
    r.render(tcam_of(jsyn.ring_camera(2, n_cams=4, height=48, width=48)), 8.0)  # big move → recount
    assert r._count_cache["frames"] == 0
    # a stale cache is healed: poison the cached count far below the cut
    r._count_cache = {"tau": 0.0, "vp": cam0.camera_center.numpy().astype(np.float64), "frames": 0, "n_cut": 8}
    r._budget = 0
    out = r.render(cam0, 0.0)
    assert int(out["overflow"]) == 0
    assert r._count_cache["n_cut"] >= 3000 and r._budget >= 3000
    img = out["render"].numpy()
    assert np.isfinite(img).all() and img.max() > 0


def test_adaptive_renderer_skips_the_count_pass_on_a_cache_hit(monkeypatch):
    """A cached count spares the count pass and its host read: the pass
    runs on a miss (first frame, τ change) and not on a hit."""
    h = jbuild.build_hierarchy(*toy_leaves(300, seed=8))
    _, r = _renderers(h)
    cam = tcam_of(jsyn.ring_camera(1, n_cams=4, height=48, width=48))
    passes = []
    real = tinterp.cut_size_packed

    def counted(*args, **kwargs):
        passes.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tinterp, "cut_size_packed", counted)
    a = r.render(cam, 2.0)
    b = r.render(cam, 2.0)
    assert len(passes) == 1 and r._count_cache["frames"] == 1
    assert torch.equal(a["render"], b["render"])
    r.render(cam, 4.0)
    assert len(passes) == 2 and r._count_cache["frames"] == 0


def test_builder_library_lives_under_build_and_rebuilds_atomically(tmp_path, monkeypatch):
    lib = tbuild.lib_path()
    assert lib.parent == tbuild.BUILD_DIR and tbuild.BUILD_DIR.parts[-2:] == ("build", "hier")
    assert tbuild.SRC.parents[2].name == "hidegs_tpu_torch"
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "b")
    built = tbuild.compile_native()
    assert built.parent == tmp_path / "b" and built.exists()
    assert [p.name for p in (tmp_path / "b").iterdir()] == [built.name]  # no temporary left behind


def test_render_cli_hierarchy_pngs_match_jax(tmp_path):
    """`render_cli --hierarchy <file> --tau 4` of both packages on one small
    COLMAP scene (the JAX writer) and one `.hier` file: the PNGs agree
    within one level of 255."""
    from hidegs_tpu import render_cli as jrender_cli
    from hidegs_tpu.data.synthetic import ToyScene
    from hidegs_tpu.data.synthetic import write_synthetic_colmap_scene as jwrite_scene
    from hidegs_tpu_torch import render_cli as trender_cli
    from hidegs_tpu_torch.utils import png

    pos, rot, scale, alpha, shs = toy_leaves(160, seed=6)
    cams = [jsyn.ring_camera(i, n_cams=3, height=64, width=64) for i in range(3)]
    src = str(tmp_path / "scene")
    jwrite_scene(src, ToyScene(*[jnp.asarray(x) for x in (pos, scale, rot, alpha, shs)]), cams,
                 render_config=JConfig(backend="jnp", max_instances=1 << 13))
    hier = str(tmp_path / "h.hier")
    tio.write_hier(hier, tbuild.build_hierarchy(pos, rot, scale, alpha, shs, use_native=True))
    args = ["--source_path", src, "--hierarchy", hier, "--tau", "4", "--resolution", "1"]
    jrender_cli.main(args + ["--output_path", str(tmp_path / "jax")])
    trender_cli.main(args + ["--output_path", str(tmp_path / "port"), "--device", "cpu"])
    for i in range(len(cams)):
        got = png.read_png(str(tmp_path / "port" / f"{i:05d}.png")).astype(np.int32)
        want = png.read_png(str(tmp_path / "jax" / f"{i:05d}.png")).astype(np.int32)
        assert got.shape == want.shape == (64, 64, 3)
        assert np.abs(got - want).max() <= 1
        assert want.std() > 0  # the view shows the scene
