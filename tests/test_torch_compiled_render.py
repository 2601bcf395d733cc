"""The compiled serving render (raster/compiled.py:CompiledRender) on the
CPU: the body its CUDA graphs capture against the eager `render` and the
JAX package's `render`; the key; the copy-in of the camera and the
background and the arrays held by reference, on a stand-in for the
capture (tests/torch_graph_standin.py); the refusals; the bound on keys;
`serving_render` and the entry points that call it; and the KNN scale
init against the JAX package's. The card tests in tests/test_torch_cuda.py
capture and replay.

Tolerances: against the eager render bitwise (the same operations on the
same inputs); against JAX's render the JAX suite's blend tolerance, atol
3e-4 / rtol 1e-3 on the planes, `out_observe`, radii, visibility and the
counters equal; the KNN init rtol 1e-6 (tests/test_torch_model.py's: the
same float32 arithmetic).
"""
import dataclasses
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_graph_standin

from hidegs_tpu.data import synthetic as jsyn
from hidegs_tpu.model import knn as jknn
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu.raster.api import render as jrender
from hidegs_tpu_torch import config as tconfig
from hidegs_tpu_torch import convert, evaluate, render_cli
from hidegs_tpu_torch.data import synthetic as tsyn
from hidegs_tpu_torch.model import knn as tknn
from hidegs_tpu_torch.raster import compiled
from hidegs_tpu_torch.raster.api import RasterConfig, render
from hidegs_tpu_torch.utils import graphs, png
from hidegs_tpu_torch.utils.ply import gaussian_properties, write_ply
from hidegs_tpu_torch.viewer import __main__ as viewer_main

torch.set_num_threads(1)

BLEND_TOL = dict(atol=3e-4, rtol=1e-3)
IMAGE_KEYS = ["render", "invdepth", "alpha", "T_final", "rendered_normal", "rendered_distance", "depth_normal"]
COUNTERS = ["overflow", "block_overflow", "num_instances", "num_visible", "visible_overflow"]
H, W = 56, 72
# the serve configuration (evaluate and render_cli: tile 16, no block cap,
# the exact two-key sort) and the render cell's (tile 32, a block cap, one
# sort key)
CONFIGS = {16: RasterConfig(tile=16, max_instances=1 << 12),
           32: RasterConfig(tile=32, max_instances=1 << 12, max_blocks=48, depth_sort_bits=-1)}


def _numpy_scene(seed=5, n=220):
    """A seeded scene of n gaussians as numpy arrays, SH degree 3."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-2.0, 2.0, (n, 3))
    scales = np.exp(rng.uniform(np.log(0.03), np.log(0.15), (n, 3)))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacities = rng.uniform(0.3, 0.95, (n,))
    shs = np.concatenate([rng.uniform(-1.0, 1.5, (n, 1, 3)), rng.normal(0, 0.15, (n, 15, 3))], axis=1)
    return tuple(a.astype(np.float32) for a in (means, scales, quats, opacities, shs))


def _jcam(idx=3, h=H, w=W):
    return jsyn.ring_camera(idx, height=h, width=w)


def _tcam(jc):
    leaves = [np.asarray(x) for x in (jc.R, jc.t, jc.fx, jc.fy, jc.cx, jc.cy)]
    return convert.camera_from_jax(*leaves, jc.height, jc.width, jc.full_height, jc.full_width, device="cpu")


@pytest.fixture(scope="module")
def scene():
    return tuple(torch.from_numpy(a) for a in _numpy_scene())


def _eager(arrays, cam, **kw):
    with torch.no_grad():
        return render(*arrays, cam, **kw)


def _assert_same(got, want, what=""):
    assert set(got) == set(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), (what, k)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("render_geo", [False, True])
def test_capture_body_is_the_eager_render(scene, tile, render_geo):
    """`CompiledRender.body` (what a graph captures) is `render` under
    no_grad, bitwise, with a background and without; nothing it returns
    requires grad."""
    cam = _tcam(_jcam())
    bg = torch.tensor([0.2, 0.1, 0.3])
    for background in (None, bg):
        kw = dict(background=background, render_geo=render_geo, config=CONFIGS[tile])
        got = compiled.CompiledRender.body(*scene, cam, **kw)
        _assert_same(got, _eager(scene, cam, **kw), (tile, render_geo, background is None))
        assert not any(v.requires_grad for v in got.values())


@pytest.mark.parametrize("tile", [16, 32])
def test_compiled_call_path_matches_jax_render(scene, monkeypatch, tile):
    """The port's compiled render (its call path on the stand-in capture)
    against the JAX package's render on the same numpy scene and camera,
    with render_geo and a background, at the blend tolerance."""
    arrays = _numpy_scene()
    jc = _jcam()
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    jo = jrender(*(jnp.asarray(a) for a in arrays), jc, background=jnp.asarray(bg), render_geo=True,
                 config=JConfig(backend="jnp", tile=tile, max_instances=1 << 12,
                                depth_sort_bits=CONFIGS[tile].depth_sort_bits))
    torch_graph_standin.install(monkeypatch, compiled)
    comp = compiled.CompiledRender()
    to = comp(*scene, _tcam(jc), background=torch.from_numpy(bg), render_geo=True,
              config=dataclasses.replace(CONFIGS[tile], max_blocks=0))
    for k in IMAGE_KEYS:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), err_msg=k, **BLEND_TOL)
    for k in ("out_observe", "radii", "visibility"):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]), err_msg=k)
    for k in COUNTERS:
        assert int(to[k]) == int(jo[k]), k
    assert float(to["alpha"].mean()) > 0.05 and len(comp.captures) == 1 and comp.replays == 1


def test_key_changes_with_what_jax_retraces_on(scene):
    """The config, active_sh_degree, render_geo, the arrays' and
    colors_precomp's specs, the image size, the frustum extent and a given
    background change the key; the camera's pose and intrinsics and the
    background's value do not."""
    cam = _tcam(_jcam())
    base = dict(cam=cam, background=None, active_sh_degree=3, render_geo=False, colors_precomp=None,
                config=CONFIGS[16])
    key = compiled.render_key(*scene, **base)
    n = scene[0].shape[0]
    changed = {
        "config": dict(config=CONFIGS[32]),
        "budget": dict(config=dataclasses.replace(CONFIGS[16], max_instances=1 << 13)),
        "active_sh_degree": dict(active_sh_degree=1),
        "render_geo": dict(render_geo=True),
        "colors_precomp": dict(colors_precomp=torch.zeros((n, 3))),
        "image size": dict(cam=dataclasses.replace(cam, height=H + 8)),
        "frustum extent": dict(cam=dataclasses.replace(cam, full_width=2 * W)),
        "background": dict(background=torch.zeros(3)),
    }
    keys = {what: compiled.render_key(*scene, **{**base, **kw}) for what, kw in changed.items()}
    for what, other in keys.items():
        assert other != key, what
    assert len(set(keys.values())) == len(keys)
    assert compiled.render_key(*(a[:-1] for a in scene), **base) != key  # another model size
    moved = dataclasses.replace(cam, t=cam.t + 0.5, fx=cam.fx * 1.1, cy=cam.cy - 2.0)
    assert compiled.render_key(*scene, **{**base, "cam": moved}) == key
    bg = dict(background=torch.ones(3))
    assert compiled.render_key(*scene, **{**base, **bg}) == keys["background"]
    hash(key)


def test_camera_and_background_are_copied_in(scene, monkeypatch):
    """One key, four cameras and two backgrounds: each call equals the
    eager render of its own camera and background, one capture, the
    outputs are the same static tensors every call, the graph's static
    camera holds the last camera's values (a copy, not the caller's
    tensors)."""
    torch_graph_standin.install(monkeypatch, compiled)
    comp = compiled.CompiledRender()
    outs = []
    for i in range(4):
        cam = _tcam(_jcam(i))
        bg = torch.tensor([0.1 * i, 0.2, 0.05 * i])
        got = comp(*scene, cam, background=bg, config=CONFIGS[16])
        _assert_same(got, _eager(scene, cam, background=bg, config=CONFIGS[16]), i)
        outs.append(got)
    assert len(comp.captures) == 1 and comp.replays == 4
    assert all(o["render"] is outs[0]["render"] for o in outs)
    (g,) = comp._graphs.values()
    static_cam, static_bg = g.inputs
    assert torch.equal(static_cam.R, cam.R) and static_cam.R is not cam.R
    assert torch.equal(static_bg, bg) and static_bg is not bg


def test_model_arrays_are_held_by_reference(scene, monkeypatch):
    """The graphs read the first call's arrays: an in-place change to them
    shows in the next replay (the eager render of the changed arrays,
    bitwise); clones of them, or other colors_precomp, raise, on the
    captured key and on a new one."""
    torch_graph_standin.install(monkeypatch, compiled)
    arrays = tuple(a.clone() for a in scene)
    comp = compiled.CompiledRender()
    cam = _tcam(_jcam())
    first = {k: v.clone() for k, v in comp(*arrays, cam, config=CONFIGS[16]).items()}
    arrays[3].mul_(0.5)  # the opacities, in place
    got = comp(*arrays, cam, config=CONFIGS[16])
    _assert_same(got, _eager(arrays, cam, config=CONFIGS[16]))
    assert not torch.equal(got["alpha"], first["alpha"])
    with pytest.raises(ValueError, match="by reference"):
        comp(*(a.clone() for a in arrays), cam, config=CONFIGS[16])
    with pytest.raises(ValueError, match="by reference"):
        comp(*arrays, cam, colors_precomp=torch.zeros((arrays[0].shape[0], 3)), config=CONFIGS[16])
    with pytest.raises(ValueError, match="by reference"):  # a new key: nothing is captured
        comp(*(a.clone() for a in arrays), cam, config=CONFIGS[32])
    assert len(comp.captures) == 1 and comp.replays == 2


def test_refusals(scene, monkeypatch):
    """No fallback: CPU arrays raise, naming `render`; so do the "plain"
    and "oracle" backends where graphs run, a camera on another device
    than the arrays, and a capture that fails (its RuntimeError goes to
    the caller, with no eager render)."""
    cam = _tcam(_jcam())
    with pytest.raises(ValueError, match="render"):
        compiled.CompiledRender()(*scene, cam, config=CONFIGS[16])
    torch_graph_standin.install(monkeypatch, compiled)
    for backend in ("plain", "oracle"):
        with pytest.raises(ValueError, match=backend):
            compiled.CompiledRender()(*scene, cam, config=dataclasses.replace(CONFIGS[16], backend=backend))
    with pytest.raises(ValueError, match="device"):
        compiled.CompiledRender()(*scene, dataclasses.replace(cam, R=cam.R.to("meta")), config=CONFIGS[16])

    def failed(self, dev, warmup, body, info, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"  # a viewer captures in a handler thread
        raise RuntimeError("capturing the render as a CUDA graph failed: stand-in")

    monkeypatch.setattr(graphs.GraphSet, "capture", failed)
    comp = compiled.CompiledRender()
    with pytest.raises(RuntimeError, match="capturing the render"):
        comp(*scene, cam, config=CONFIGS[16])
    assert not comp._graphs and comp.replays == 0
    # a failed capture pins nothing: a reloaded model captures and replays
    torch_graph_standin.install(monkeypatch, compiled)
    reloaded = tuple(x.clone() for x in scene)
    _assert_same(comp(*reloaded, cam, config=CONFIGS[16]), _eager(scene, cam, config=CONFIGS[16]), "reloaded")
    assert len(comp.captures) == 1 and comp.replays == 1


def test_least_recently_used_key_is_evicted(scene, monkeypatch):
    """With a bound of two keys: sizes A, B, A, C evict B (A was used
    last), recorded in `evictions`; B again captures anew and evicts A;
    every frame equals the eager render."""
    torch_graph_standin.install(monkeypatch, compiled)
    assert compiled.MAX_KEYS == 4
    monkeypatch.setattr(compiled, "MAX_KEYS", 2)
    comp = compiled.CompiledRender()
    sizes = {"A": (48, 64), "B": (40, 40), "C": (32, 48)}
    for name in "ABACB":
        h, w = sizes[name]
        cam = _tcam(_jcam(1, h, w))
        _assert_same(comp(*scene, cam, config=CONFIGS[16]), _eager(scene, cam, config=CONFIGS[16]), name)
    assert [c["image"] for c in comp.captures] == [sizes[k] for k in "ABCB"]
    assert [e["image"] for e in comp.evictions] == [sizes["B"], sizes["A"]]
    assert [e["replays_at_eviction"] for e in comp.evictions] == [3, 4]
    assert len(comp._graphs) == 2 and comp.replays == 5


def test_serving_render_is_eager_off_the_card(scene, monkeypatch):
    """`serving_render` and the viewers' render function: the eager render
    on the CPU; a CompiledRender where graphs run, whose frames equal the
    eager ones, for the "blend" backend, and the eager render there for
    the backends a user may pick that a graph does not run."""
    assert compiled.serving_render("cpu", CONFIGS[16]) is render
    fn = viewer_main.make_render_fn(scene, CONFIGS[16])
    assert fn.compiled is None
    cam = _tcam(_jcam())
    want = torch.clamp(_eager(scene, cam, config=CONFIGS[16])["render"], 0, 1)
    assert torch.equal(fn(cam), want)
    torch_graph_standin.install(monkeypatch, compiled)
    assert isinstance(compiled.serving_render("cpu", CONFIGS[16]), compiled.CompiledRender)
    fn = viewer_main.make_render_fn(scene, CONFIGS[16])
    assert isinstance(fn.compiled, compiled.CompiledRender)
    assert torch.equal(fn(cam), want) and fn.compiled.replays == 1
    for backend in ("plain", "oracle"):
        cfg = dataclasses.replace(CONFIGS[16], backend=backend)
        assert compiled.serving_render("cpu", cfg) is render, backend
        fn = viewer_main.make_render_fn(scene, cfg)
        assert fn.compiled is None, backend
        assert torch.equal(fn(cam), torch.clamp(_eager(scene, cam, config=cfg)["render"], 0, 1)), backend


def test_viewer_frames_from_threads_are_serialised(scene, monkeypatch):
    """Four threads call the viewers' render function at once, each with
    its own camera, twice: every frame is the eager image of its own
    camera (the clip copies each replay's image out before the next
    replay); one capture, eight replays."""
    torch_graph_standin.install(monkeypatch, compiled)
    fn = viewer_main.make_render_fn(scene, CONFIGS[16])
    cams = [_tcam(_jcam(i)) for i in range(4)]
    want = [torch.clamp(_eager(scene, c, config=CONFIGS[16])["render"], 0, 1) for c in cams]
    got, errors = {}, []

    def client(i):
        try:
            got[i] = [fn(cams[i]) for _ in range(2)]
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    for i in range(4):
        assert all(torch.equal(f, want[i]) for f in got[i]), i
    assert len(fn.compiled.captures) == 1 and fn.compiled.replays == 8


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A COLMAP scene of three 48x64 views of a toy model and the model's
    directory (PLY, cfg_args.json at tile 16), written by the port."""
    root = tmp_path_factory.mktemp("served")
    s = tsyn.make_toy_gaussians(160, seed=2, device="cpu")
    cams = [tsyn.ring_camera(i, n_cams=6, height=48, width=64, device="cpu") for i in range(3)]
    cfg = RasterConfig(max_instances=1 << 12)
    tsyn.write_synthetic_colmap_scene(str(root / "scene"), s, cams, render_config=cfg)
    ckpt = root / "model" / "point_cloud" / "iteration_7"
    ckpt.mkdir(parents=True)
    op = s.opacities.double()
    write_ply(str(ckpt / "point_cloud.ply"), gaussian_properties(
        s.means3d.numpy(), s.shs[:, 0].numpy(), s.shs[:, 1:].numpy(),
        torch.log(op / (1.0 - op)).float().numpy(), torch.log(s.scales).numpy(), s.quats.numpy()))
    tconfig.save_cfg_args(str(root / "model"), tconfig.ModelConfig(source_path=str(root / "scene"), eval=True),
                          tconfig.PipelineConfig(raster_backend="jnp", tile=16, max_instances=1 << 12),
                          tconfig.OptimizationConfig())
    return root


def _recording(monkeypatch, module, made):
    original = module.serving_render

    def make(device, config):
        fn = original(device, config)
        made.append(fn)
        return fn

    monkeypatch.setattr(module, "serving_render", make)


def test_entry_points_render_through_replays(model_dir, monkeypatch, tmp_path):
    """`evaluate.main` and `render_cli.main` where graphs run (the
    stand-in, on the CPU): each renders through one CompiledRender, one
    replay per view and one capture (evaluate's train and test views share
    it); results.json and every PNG equal those of the eager run."""
    def run(out, made):
        _recording(monkeypatch, evaluate, made)
        _recording(monkeypatch, render_cli, made)
        eval_args = ["--model_path", str(out), "--source_path", str(model_dir / "scene"), "--eval",
                     "--resolution", "1", "--device", "cpu"]
        report = evaluate.main(eval_args)
        render_cli.main(["--model_path", str(out), "--source_path", str(model_dir / "scene"), "--resolution",
                         "1", "--max_instances", str(1 << 12), "--output_path", str(out / "cli"),
                         "--device", "cpu"])
        return report

    import shutil

    runs = {}
    for mode in ("eager", "compiled"):
        out = tmp_path / mode
        shutil.copytree(model_dir / "model", out)
        made = []
        if mode == "compiled":
            torch_graph_standin.install(monkeypatch, compiled)
        runs[mode] = (run(out, made), out)
        kinds = {type(fn).__name__ for fn in made}
        if mode == "eager":
            assert made == [render, render]
        else:
            assert kinds == {"CompiledRender"} and len(made) == 2
            ev, cli = made
            assert (len(ev.captures), ev.replays) == (1, 3) and (len(cli.captures), cli.replays) == (1, 3)
    (rep_e, out_e), (rep_c, out_c) = runs["eager"], runs["compiled"]
    assert json.dumps(rep_e, sort_keys=True) == json.dumps(rep_c, sort_keys=True)
    pngs = sorted(p.relative_to(out_e) for p in out_e.rglob("*.png"))
    assert len(pngs) == 3 * 2 + 3  # evaluate's renders and ground truths, render_cli's views
    for rel in pngs:
        assert np.array_equal(png.read_image(str(out_e / rel)), png.read_image(str(out_c / rel))), rel


def test_oracle_entry_points_render_eagerly(model_dir, monkeypatch, tmp_path):
    """`evaluate.main` of a model whose cfg_args asks for the "oracle" and
    `render_cli.main --backend oracle`, where graphs run (the stand-in):
    both keep the backend the user picked and render it eagerly, no
    capture; their PNGs equal those of the same runs off the card."""
    import shutil

    outs = {}
    for mode in ("off_card", "graphs_run"):
        out = tmp_path / mode
        shutil.copytree(model_dir / "model", out)
        tconfig.save_cfg_args(str(out), tconfig.ModelConfig(source_path=str(model_dir / "scene"), eval=True),
                              tconfig.PipelineConfig(raster_backend="oracle", tile=16, max_instances=1 << 12),
                              tconfig.OptimizationConfig())
        if mode == "graphs_run":
            torch_graph_standin.install(monkeypatch, compiled)
        made = []
        _recording(monkeypatch, evaluate, made)
        _recording(monkeypatch, render_cli, made)
        evaluate.main(["--model_path", str(out), "--source_path", str(model_dir / "scene"), "--eval",
                       "--resolution", "1", "--device", "cpu"])
        render_cli.main(["--model_path", str(out), "--source_path", str(model_dir / "scene"), "--resolution",
                         "1", "--backend", "oracle", "--max_instances", str(1 << 12), "--output_path",
                         str(out / "cli"), "--device", "cpu"])
        assert made == [render, render], mode
        outs[mode] = out
    pngs = sorted(p.relative_to(outs["off_card"]) for p in outs["off_card"].rglob("*.png"))
    assert len(pngs) == 3 * 2 + 3
    for rel in pngs:
        assert np.array_equal(png.read_image(str(outs["off_card"] / rel)),
                              png.read_image(str(outs["graphs_run"] / rel))), rel


def test_knn_init_matches_jax():
    """`mean_knn_sq_dist` (its candidates masked with a fill, no host
    copy) and `initial_scales` against the JAX package's on seeded points
    with duplicates, a tight cluster, fewer points than the window, and
    fewer than k + 1 (candidates past the ends are masked out of the mean)."""
    rng = np.random.default_rng(11)
    pts = np.concatenate([rng.uniform(-3, 3, (400, 3)), rng.normal(0, 0.01, (50, 3))]).astype(np.float32)
    pts[-4:] = pts[-5]
    for p in (pts, pts[:9], pts[:3], pts[:1]):
        got = tknn.mean_knn_sq_dist(torch.from_numpy(p))
        want = np.asarray(jknn.mean_knn_sq_dist(jnp.asarray(p)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        np.testing.assert_allclose(tknn.initial_scales(torch.from_numpy(p)).numpy(),
                                   np.asarray(jknn.initial_scales(jnp.asarray(p))), rtol=1e-6, atol=0)
        assert np.all(np.isfinite(got.numpy()))
