"""Compiled LPIPS (train/lpips.py:CompiledLpips) and the compiled densify
round and scrub (train/compiled.py:CompiledDensify) on the CPU: the
bodies their CUDA graphs capture, called without capture, against the
eager functions and the JAX package's densify round; the keys; the call
paths with a stand-in for the capture (tests/torch_graph_standin.py); the
refusals. The card tests in tests/test_torch_cuda.py capture and replay.

Tolerances: against the eager functions bitwise (the same operations on
the same inputs; the scene extent a 0-d float64 input that rounds to the
eager threshold's float32); against JAX's `densify_and_prune`,
tests/test_torch_train.py::test_densify_round_after_training_matches_jax's:
counts, alive masks and Adam steps equal, parameters rtol 1e-5 / atol
1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_graph_standin
from test_torch_train import FIELDS, TCFG, _state_numpy, k_steps, problem  # noqa: F401  (fixtures)

from hidegs_tpu.model import densify as jdens
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.model import densify as tdens
from hidegs_tpu_torch.train import compiled
from hidegs_tpu_torch.train import loop as tl
from hidegs_tpu_torch.train import lpips
from hidegs_tpu_torch.utils import graphs

torch.set_num_threads(1)

EXTENT = 3.0


def _small_lpips_params():
    """The random VGG16 at its real widths, on the CPU."""
    return lpips.random_lpips_params(0, "cpu")


def _images(seed, h=32, w=40):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((3, h, w), generator=g), torch.rand((3, h, w), generator=g)


def test_compiled_lpips_on_a_stand_in_capture(monkeypatch):
    """CompiledLpips's call path with a stand-in for the capture: bitwise
    the eager distance for two pairs of one shape (one capture, the images
    copied in) and a pair of another shape (a second capture); the output
    is the graph's static tensor; `default_lpips_fn` returns a
    CompiledLpips where graphs run, the eager distance on the CPU."""
    params = _small_lpips_params()
    fn, kind = lpips.default_lpips_fn("", device="cpu")
    assert kind == "random-vgg" and not isinstance(fn, lpips.CompiledLpips)
    torch_graph_standin.install(monkeypatch, lpips)
    comp = lpips.default_lpips_fn("", device="cpu")[0]
    assert isinstance(comp, lpips.CompiledLpips)
    comp = lpips.CompiledLpips(params)
    outs = []
    for seed, shape in ((0, (32, 40)), (1, (32, 40)), (2, (24, 16))):
        a, b = _images(seed, *shape)
        with torch.no_grad():
            want = lpips.lpips_distance(params, a, b)
        got = comp(a, b)
        assert torch.equal(got, want) and got.shape == ()
        outs.append(got)
    assert outs[0] is outs[1], "one key: the same static output"
    assert len(comp.captures) == 2 and comp.replays == 3
    assert [c["image"] for c in comp.captures] == [(3, 32, 40), (3, 24, 16)]


def test_compiled_lpips_refuses_other_parameters_and_cpu_images():
    """The parameters are held by reference: another dict, or another
    tensor under one of its keys, raises before anything runs; images off
    the card raise, naming the eager `lpips_distance`."""
    params = _small_lpips_params()
    a, b = _images(0)
    comp = lpips.CompiledLpips(params)
    with pytest.raises(ValueError, match="lpips_distance"):
        comp(a, b)
    comp.params = dict(params)  # another dict of the same tensors: held alike
    with pytest.raises(ValueError, match="lpips_distance"):
        comp(a, b)
    for other in (_small_lpips_params(), {**params, "lin0_w": params["lin0_w"].clone()},
                  {k: v for k, v in params.items() if k != "lin4_w"}):
        comp.params = other
        with pytest.raises(ValueError, match="by reference"):
            comp(a, b)
    params["conv0_b"] = params["conv0_b"] + 0  # the dict it was given, changed in place
    comp.params = params
    with pytest.raises(ValueError, match="by reference"):
        comp(a, b)


def test_lpips_key_is_the_images_spec():
    """One graph per shape and dtype of the two images, whatever their
    values."""
    a, b = _images(0)
    c, d = _images(1)
    assert graphs._spec((a, b)) == graphs._spec((c, d))
    assert graphs._spec((a, b)) != graphs._spec((a[:, :16], b[:, :16]))
    assert graphs._spec((a, b)) != graphs._spec((a.double(), b.double()))


@pytest.fixture(scope="module")
def densify_problem(k_steps):  # noqa: F811
    """tests/test_torch_train.py's state after K training steps, converted
    from JAX's, with test_densify_round_after_training_matches_jax's
    thresholds and split draws (the JAX key's)."""
    jts = k_steps[-1][0]
    opt = jts.opt
    tts = convert.train_state_from_jax(
        gaussians=_state_numpy(jts.gaussians), m={f: getattr(opt.m, f) for f in FIELDS},
        v={f: getattr(opt.v, f) for f in FIELDS}, opt_step=opt.step, exposure=jts.exposure,
        exposure_m=jts.exposure_m, exposure_v=jts.exposure_v, step=jts.step, device="cpu")
    g = jts.gaussians
    alive = np.asarray(g.alive)
    opac = 1.0 / (1.0 + np.exp(-np.asarray(g.params.opacity)))
    score = np.asarray(g.grad_max) * np.asarray(g.max_radii2d) * np.maximum(opac, 1e-8) ** 0.2
    max_scale = np.exp(np.asarray(g.params.scaling)).max(-1)
    jcfg = jdens.DensifyConfig(grad_threshold=float(np.quantile(score[alive], 0.8)), clone_min_opacity=0.0,
                               percent_dense=float(np.median(max_scale[alive])) / EXTENT)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    C = alive.shape[0]
    draws = (torch.tensor(np.asarray(jax.random.normal(k1, (C, 3)))),
             torch.tensor(np.asarray(jax.random.normal(k2, (C, 3)))))
    jn, jo, jinfo = jdens.densify_and_prune(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, opt),
                                            EXTENT, jcfg, key)
    cfg = dataclasses.replace(TCFG, densify=tdens.DensifyConfig(*jcfg))
    return dict(ts=tts, cfg=cfg, draws=draws, jax=(jn, jo, jinfo))


def _same_bits(a, b) -> bool:
    """Bitwise equality (NaNs included, which `torch.equal` calls unequal)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _extent():
    return torch.full((), EXTENT, dtype=torch.float64)


def test_densify_body_is_bitwise_eager_and_matches_jax(densify_problem, monkeypatch):
    """The captured round on static CPU buffers with the injected draws:
    every tensor of the state and every info value bitwise the eager
    `densify_step`'s (fed the same draws); the buffers written in place;
    the counts, alive mask, Adam steps and children as JAX's."""
    p = densify_problem
    monkeypatch.setattr(tdens, "split_draws", lambda gen, cap, dev: p["draws"])
    eager, einfo = tl.densify_step(p["ts"], EXTENT, p["cfg"])
    state = graphs._map(torch.clone, p["ts"])
    ptrs = [x.data_ptr() for x in graphs._tensors(state)]
    info = compiled.densify_in_place(state, _extent(), p["cfg"], p["draws"])
    for n, (a, b) in enumerate(zip(graphs._tensors(state), graphs._tensors(eager), strict=True)):
        assert _same_bits(a, b), f"tensor {n} of the state"
    assert info.keys() == einfo.keys()
    for k in info:
        assert _same_bits(info[k], einfo[k]), k
    assert [x.data_ptr() for x in graphs._tensors(state)] == ptrs
    jn, jo, jinfo = p["jax"]
    assert int(jinfo["n_clone"]) > 0 and int(jinfo["n_split"]) > 0
    for k in ("n_clone", "n_split", "n_pruned", "n_alive", "n_dropped"):
        assert int(info[k]) == int(jinfo[k]), k
    np.testing.assert_array_equal(state.gaussians.alive.numpy(), np.asarray(jn.alive))
    np.testing.assert_array_equal(state.opt.step.numpy(), np.asarray(jo.step))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(state.gaussians.params, f).numpy(), np.asarray(getattr(jn.params, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def _with_nonfinite(ts):
    """The state with three alive rows gone non-finite."""
    g = ts.gaussians
    alive = torch.nonzero(g.alive).flatten()[:3]
    xyz, opacity = g.params.xyz.clone(), g.params.opacity.clone()
    xyz[alive[0], 1] = float("nan")
    xyz[alive[1], 0] = float("inf")
    opacity[alive[2]] = float("-inf")
    return ts._replace(gaussians=g._replace(params=g.params._replace(xyz=xyz, opacity=opacity)))


def test_scrub_body_is_bitwise_eager(densify_problem):
    """The captured scrub on static CPU buffers: the alive mask and the
    count bitwise the eager `scrub_step`'s, written in place."""
    ts = _with_nonfinite(densify_problem["ts"])
    eager, n = tl.scrub_step(ts)
    state = graphs._map(torch.clone, ts)
    alive = state.gaussians.alive
    got = compiled.scrub_in_place(state)
    assert int(n) == 3 and torch.equal(got, n)
    assert state.gaussians.alive is alive
    for a, b in zip(graphs._tensors(state), graphs._tensors(eager), strict=True):
        assert _same_bits(a, b)


def test_scene_extent_as_a_float64_input_keeps_the_eager_threshold(densify_problem):
    """The threshold `percent_dense · extent` from a Python float and from
    a 0-d float64 tensor splits the rows alike even where the float32
    product would round otherwise: the masks are bitwise equal for
    extents around every alive row's max scale."""
    p = densify_problem
    g = p["ts"].gaussians
    cfg = p["cfg"].densify
    max_scale = torch.amax(torch.exp(g.params.scaling), dim=-1)
    for s in max_scale[g.alive][:16].tolist():
        for extent in (s / cfg.percent_dense, np.nextafter(s / cfg.percent_dense, 0.0)):
            want = max_scale <= cfg.percent_dense * float(extent)
            got = max_scale <= cfg.percent_dense * torch.full((), float(extent), dtype=torch.float64)
            assert torch.equal(want, got), extent


def test_compiled_rounds_on_a_stand_in_capture(densify_problem, monkeypatch):
    """CompiledDensify's call path with a stand-in for the capture, on the
    host schedule: two densify rounds and a scrub through
    `maybe_host_side_schedule(compiled=)` are bitwise the eager schedule's
    (the split draws drawn before each replay from `ts.generator`, which
    advances alike); one capture each for the round and the scrub; the
    returned state is the static buffers."""
    p = densify_problem
    torch_graph_standin.install(monkeypatch)
    cfg = dataclasses.replace(p["cfg"], densify_from=1, densify_until=20, densify_interval=10,
                              opacity_reset_interval=1000, sh_increase_interval=1000)
    rounds = compiled.CompiledDensify()
    eager = comp = p["ts"]._replace(generator=torch.Generator().manual_seed(11))
    comp = comp._replace(generator=torch.Generator().manual_seed(11))
    ptrs = None
    for it, what in ((10, "densify"), (20, "densify"), (30, "scrub")):
        if what == "scrub":
            eager, comp = _with_nonfinite(eager), _with_nonfinite(comp)
        eager, einfo = tl.maybe_host_side_schedule(eager, cfg, EXTENT, step=it)
        comp, cinfo = tl.maybe_host_side_schedule(comp, cfg, EXTENT, step=it, compiled=rounds)
        for n, (a, b) in enumerate(zip(graphs._tensors(comp), graphs._tensors(eager), strict=True)):
            assert _same_bits(a, b), f"{what}@{it}: tensor {n}"
        assert torch.equal(comp.generator.get_state(), eager.generator.get_state())
        if what == "densify":
            assert all(_same_bits(cinfo[k], einfo[k]) for k in einfo)
            assert it > 10 or int(cinfo["n_clone"]) + int(cinfo["n_split"]) > 0
        now = [x.data_ptr() for x in graphs._tensors(comp)]
        assert ptrs is None or now == ptrs
        ptrs = now
    assert [c["kind"] for c in rounds.captures] == ["densify", "scrub"] and rounds.replays == 3
    assert int(comp.gaussians.alive.sum()) == int(eager.gaussians.alive.sum())


def test_compiled_rounds_refuse_a_cpu_state(densify_problem):
    """No fallback: CPU tensors raise, naming the eager function, and the
    generator is not advanced."""
    ts = densify_problem["ts"]
    before = ts.generator.get_state()
    rounds = compiled.CompiledDensify()
    with pytest.raises(ValueError, match="densify_step"):
        rounds.densify_step(ts, EXTENT, densify_problem["cfg"])
    with pytest.raises(ValueError, match="scrub_step"):
        rounds.scrub_step(ts)
    assert torch.equal(ts.generator.get_state(), before) and not rounds.captures
