"""Port parity of the model modules: hidegs_tpu_torch.model.{gaussians, adam,
schedules, knn, densify} against hidegs_tpu.model.*, fed the same numpy
inputs.

Tolerances: masks, slot choices, counts, Morton codes and integer state
exactly equal; float results rtol 1e-6 (the same float32 arithmetic, with
transcendentals a few ulp apart between XLA and PyTorch). Densify's split
draws differ between jax.random and torch.Generator, so the test replaces
the port's `split_draws` with the JAX draws of the same key.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidegs_tpu.model import adam as jadam
from hidegs_tpu.model import densify as jdens
from hidegs_tpu.model import gaussians as jg
from hidegs_tpu.model import knn as jknn
from hidegs_tpu.model import schedules as jsched
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.model import adam as tadam
from hidegs_tpu_torch.model import densify as tdens
from hidegs_tpu_torch.model import gaussians as tg
from hidegs_tpu_torch.model import knn as tknn
from hidegs_tpu_torch.model import schedules as tsched

torch.set_num_threads(1)

RTOL = 1e-6
FIELDS = jg.GaussianParams._fields


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what, rtol=RTOL, atol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _tstate(js):
    """The port's GaussianState from a JAX one."""
    return convert.gaussian_state_from_jax(
        {f: np.asarray(getattr(js.params, f)) for f in FIELDS}, np.asarray(js.alive),
        np.asarray(js.grad_max), np.asarray(js.grad_abs_max), np.asarray(js.max_radii2d),
        np.asarray(js.protected), int(js.active_sh_degree), float(js.spatial_lr_scale), device="cpu")


def _state_close(ts, js, what, rtol=RTOL, atol=0.0):
    for f in FIELDS:
        _close(getattr(ts.params, f), getattr(js.params, f), f"{what} {f}", rtol, atol)
    for f in ("alive", "grad_max", "grad_abs_max", "max_radii2d", "protected", "active_sh_degree"):
        _close(getattr(ts, f), getattr(js, f), f"{what} {f}", rtol, atol)


def _points(n=120, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2, 2, (n, 3)).astype(np.float32), rng.uniform(0, 1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("with_knn", [True, False])
def test_init_from_points_and_activations_match_jax(with_knn):
    pts, cols = _points()
    prot = np.zeros(120, bool)
    prot[::9] = True
    knn = np.asarray(jknn.initial_scales(jnp.asarray(pts))) if with_knn else None
    js = jg.init_from_points(jnp.asarray(pts), jnp.asarray(cols), 160, spatial_lr_scale=2.5,
                             knn_scale=None if knn is None else jnp.asarray(knn),
                             protected_mask=jnp.asarray(prot))
    ts = tg.init_from_points(torch.tensor(pts), torch.tensor(cols), 160, spatial_lr_scale=2.5,
                             knn_scale=None if knn is None else torch.tensor(knn),
                             protected_mask=torch.tensor(prot))
    _state_close(ts, js, "init")
    _close(ts.spatial_lr_scale, js.spatial_lr_scale, "spatial_lr_scale")
    for prop in ("scales", "quats", "opacities", "shs", "shs_flat"):
        _close(getattr(ts, prop), getattr(js, prop), prop)
    assert ts.capacity == js.capacity and int(ts.num_alive) == int(js.num_alive)
    with pytest.raises(ValueError, match="capacity"):
        tg.init_from_points(torch.tensor(pts), torch.tensor(cols), 100)


def test_state_from_rows_pads_as_jax_init_does():
    """state_from_rows on the alive rows of a JAX init_from_points state
    gives that state back: dead rows, masks and statistics laid out as the
    JAX package lays them out."""
    pts, cols = _points(seed=2)
    js = jg.init_from_points(jnp.asarray(pts), jnp.asarray(cols), 160, spatial_lr_scale=1.5)
    rows = tg.GaussianParams(*(torch.tensor(np.asarray(getattr(js.params, f))[:120]) for f in FIELDS))
    ts = tg.state_from_rows(rows, 160, spatial_lr_scale=1.5)
    _state_close(ts, js, "state_from_rows", rtol=0.0)
    _close(ts.spatial_lr_scale, js.spatial_lr_scale, "spatial_lr_scale")
    assert int(tg.state_from_rows(rows, 160, active_sh_degree=3).active_sh_degree) == 3
    with pytest.raises(ValueError, match="capacity"):
        tg.state_from_rows(rows, 100)


def test_state_helpers_match_jax():
    pts, cols = _points(seed=1)
    js = jg.init_from_points(jnp.asarray(pts), jnp.asarray(cols), 150)
    ts = _tstate(js)
    sky_pts, sky_cols = jg.make_skybox(20, np.array([0.5, 0.0, 1.0]), 3.0, seed=4)
    t_pts, t_cols = tg.make_skybox(20, np.array([0.5, 0.0, 1.0]), 3.0, seed=4)
    np.testing.assert_array_equal(t_pts, sky_pts)
    np.testing.assert_array_equal(t_cols, sky_cols)
    rng = np.random.default_rng(2)
    raw = {"xyz": sky_pts, "sh_dc": rng.normal(size=(20, 3)).astype(np.float32),
           "sh_rest": rng.normal(size=(20, 15, 3)).astype(np.float32),
           "scaling": rng.normal(size=(20, 3)).astype(np.float32),
           "rotation": rng.normal(size=(20, 4)).astype(np.float32),
           "opacity": rng.normal(size=(20, 1)).astype(np.float32)}
    js = jg.prepend_raw_points(js, raw)
    ts = tg.prepend_raw_points(ts, raw)
    _state_close(ts, js, "prepend")
    empty = {k: v[:0] for k, v in raw.items()}
    assert tg.prepend_raw_points(ts, empty) is ts  # the empty-scaffold guard
    with pytest.raises(ValueError, match="capacity"):
        tg.prepend_raw_points(ts, {k: np.concatenate([v] * 2) for k, v in raw.items()})
    js, ts = jg.oneup_sh_degree(js), tg.oneup_sh_degree(ts)
    for _ in range(4):
        js, ts = jg.oneup_sh_degree(js), tg.oneup_sh_degree(ts)
    assert int(ts.active_sh_degree) == int(js.active_sh_degree) == 3
    js = js._replace(params=js.params._replace(opacity=js.params.opacity + 3.0))
    ts = ts._replace(params=ts.params._replace(opacity=ts.params.opacity + 3.0))
    _state_close(tg.reset_opacity(ts), jg.reset_opacity(js), "reset_opacity")
    # kill some rows, then compact state and moments together
    kill = np.zeros(150, bool)
    kill[[0, 5, 17, 60]] = True
    js = js._replace(alive=js.alive & ~jnp.asarray(kill))
    ts = ts._replace(alive=ts.alive & ~torch.tensor(kill))
    jopt = jadam.init_adam(js.params)
    jopt = jopt._replace(step=jnp.arange(150, dtype=jnp.int32))
    topt = tadam.init_adam(ts.params)._replace(step=torch.arange(150, dtype=torch.int32))
    jc, jo = jg.compact_gaussians(js, jopt)
    tc, to = tg.compact_gaussians(ts, topt)
    _state_close(tc, jc, "compact")
    _close(to.step, jo.step, "compact opt step")


def _rand_params(rng, C):
    return {"xyz": rng.normal(size=(C, 3)), "sh_dc": rng.normal(size=(C, 3)),
            "sh_rest": rng.normal(size=(C, 15, 3)), "scaling": rng.normal(-3, 0.5, (C, 3)),
            "rotation": rng.normal(size=(C, 4)), "opacity": rng.normal(size=(C,))}


def _jparams(d):
    return jg.GaussianParams(*(jnp.asarray(np.asarray(d[f], np.float32)) for f in FIELDS))


def _tparams(d):
    return tg.GaussianParams(*(torch.tensor(np.asarray(d[f], np.float32)) for f in FIELDS))


def test_masked_adam_matches_jax():
    rng = np.random.default_rng(3)
    C = 64
    p = _rand_params(rng, C)
    jp, tp = _jparams(p), _tparams(p)
    jopt, topt = jadam.init_adam(jp), tadam.init_adam(tp)
    for step in range(4):
        g = _rand_params(rng, C)
        vis = rng.uniform(0, 1, C) > 0.4
        jl = jsched.lr_tree(step, jsched.LRConfig(), 3.0)
        tl = tsched.lr_tree(torch.tensor(step, dtype=torch.int32), tsched.LRConfig(), torch.tensor(3.0))
        jp, jopt = jadam.masked_adam_update(jp, _jparams(g), jopt, jl, jnp.asarray(vis))
        tp, topt = tadam.masked_adam_update(tp, _tparams(g), topt, tl, torch.tensor(vis))
    for f in FIELDS:
        _close(getattr(tp, f), getattr(jp, f), f"param {f}")
        _close(getattr(topt.m, f), getattr(jopt.m, f), f"m {f}")
        _close(getattr(topt.v, f), getattr(jopt.v, f), f"v {f}")
    _close(topt.step, jopt.step, "step")
    r = tadam.reset_opacity_moments(topt)
    jr = jadam.reset_opacity_moments(jopt)
    _close(r.m.opacity, jr.m.opacity, "reset opacity m")
    _close(r.v.xyz, jr.v.xyz, "reset leaves the rest")
    mask = rng.uniform(0, 1, C) > 0.5
    r, jr = tadam.reset_moments_at(topt, torch.tensor(mask)), jadam.reset_moments_at(jopt, jnp.asarray(mask))
    for f in FIELDS:
        _close(getattr(r.m, f), getattr(jr.m, f), f"reset_at m {f}")
        _close(getattr(r.v, f), getattr(jr.v, f), f"reset_at v {f}")
    _close(r.step, jr.step, "reset_at step")


def test_schedules_match_jax():
    for step in (0, 1, 250, 7000, 29_999, 30_000, 40_000):
        for delay, mult in ((0, 1.0), (500, 0.01)):
            _close(tsched.expon_lr(torch.tensor(step, dtype=torch.int32), 1.6e-4, 1.6e-6, 30_000, delay, mult),
                   jsched.expon_lr(step, 1.6e-4, 1.6e-6, 30_000, delay, mult), f"expon_lr {step} {delay}")
        _close(tsched.expon_lr(step, 0.0, 1e-3, 100), jsched.expon_lr(step, 0.0, 1e-3, 100), "zero lr")
        tl = tsched.lr_tree(torch.tensor(step), tsched.LRConfig(), torch.tensor(2.0))
        jl = jsched.lr_tree(step, jsched.LRConfig(), 2.0)
        for f in FIELDS:
            _close(torch.as_tensor(getattr(tl, f), dtype=torch.float32), getattr(jl, f), f"lr {f}")


def test_knn_matches_jax():
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.uniform(-3, 3, (300, 3)), rng.normal(0, 0.01, (40, 3))]).astype(np.float32)
    pts[-5:] = pts[-6]  # duplicate points: equal Morton codes
    _close(tknn.morton_codes(torch.tensor(pts)), jknn.morton_codes(jnp.asarray(pts)), "morton")
    for window in (4, 16):
        _close(tknn.mean_knn_sq_dist(torch.tensor(pts), window=window),
               jknn.mean_knn_sq_dist(jnp.asarray(pts), window=window), f"knn {window}", atol=1e-12)
    _close(tknn.initial_scales(torch.tensor(pts)), jknn.initial_scales(jnp.asarray(pts)), "scales")
    # the bit spreading on every 10-bit value, against the JAX uint32 version
    v = np.arange(1024, dtype=np.uint32)
    _close(tknn._expand_bits_10(torch.tensor(v.astype(np.int64))),
           np.asarray(jknn._expand_bits_10(jnp.asarray(v))).astype(np.int64), "expand bits")


def _densify_problem(seed, C=96, n_alive=70):
    rng = np.random.default_rng(seed)
    p = _rand_params(rng, C)
    p["scaling"] = rng.uniform(-7, -2, (C, 3))
    p["opacity"] = rng.uniform(-6, 4, (C,))
    p["xyz"][3, 1] = np.nan  # a non-finite row gets pruned
    alive = np.zeros(C, bool)
    alive[rng.permutation(C)[:n_alive]] = True
    protected = np.zeros(C, bool)
    protected[::11] = True
    stats = dict(grad_max=rng.uniform(0, 0.05, C), grad_abs_max=rng.uniform(0, 0.06, C),
                 max_radii2d=rng.integers(0, 6, C).astype(np.float32))
    js = jg.GaussianState(
        params=_jparams(p), alive=jnp.asarray(alive),
        **{k: jnp.asarray(v, jnp.float32) for k, v in stats.items()},
        protected=jnp.asarray(protected), active_sh_degree=jnp.int32(2), spatial_lr_scale=jnp.float32(1.0))
    jopt = jadam.init_adam(js.params)
    jopt = jadam.AdamState(m=_jparams(_rand_params(rng, C)), v=_jparams(_rand_params(rng, C)),
                           step=jnp.asarray(rng.integers(0, 9, C), jnp.int32))
    topt = tadam.AdamState(m=tg.GaussianParams(*(torch.tensor(np.asarray(x)) for x in jopt.m)),
                           v=tg.GaussianParams(*(torch.tensor(np.asarray(x)) for x in jopt.v)),
                           step=torch.tensor(np.asarray(jopt.step)))
    return js, jopt, _tstate(js), topt


@pytest.mark.parametrize("growth,n_alive", [(0.0, 70), (0.0, 92), (0.05, 70)])
def test_densify_and_prune_matches_jax(monkeypatch, growth, n_alive):
    """n_alive=92 of 96 leaves fewer dead slots than candidates (the highest
    scores win); growth=0.05 caps the round at 5% of the alive count."""
    js, jopt, ts, topt = _densify_problem(6, n_alive=n_alive)
    cfg = jdens.DensifyConfig(grad_threshold=0.02, percent_dense=0.025, max_growth_frac=growth)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    C = js.capacity
    draws = (torch.tensor(np.asarray(jax.random.normal(k1, (C, 3)))),
             torch.tensor(np.asarray(jax.random.normal(k2, (C, 3)))))
    monkeypatch.setattr(tdens, "split_draws", lambda gen, cap, dev: draws)
    jn, jo, jinfo = jdens.densify_and_prune(js, jopt, 2.0, cfg, key)
    tn, to, tinfo = tdens.densify_and_prune(ts, topt, 2.0, tdens.DensifyConfig(*cfg), torch.Generator())
    assert int(jinfo["n_clone"]) > 0 and int(jinfo["n_split"]) > 0 and int(jinfo["n_pruned"]) > 0
    for k in ("n_clone", "n_split", "n_pruned", "n_alive", "n_dropped"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    if n_alive == 92 or growth:
        assert int(jinfo["n_dropped"]) > 0
    for k in ("score_p50", "score_p90", "score_p99", "grad_p50", "grad_p99", "radii_p50", "radii_p99"):
        _close(tinfo[k], jinfo[k], k, rtol=1e-5)
    # rows that took a new slot or were split hold rotated draws: a few ulp
    _state_close(tn, jn, "densified", rtol=1e-5, atol=1e-6)
    for f in FIELDS:
        _close(getattr(to.m, f), getattr(jo.m, f), f"m {f}")
        _close(getattr(to.v, f), getattr(jo.v, f), f"v {f}")
    _close(to.step, jo.step, "opt step")


def test_densification_stats_and_scrub_match_jax():
    js, _, ts, _ = _densify_problem(8)
    rng = np.random.default_rng(9)
    C = js.capacity
    g2 = rng.normal(0, 0.05, (C, 2)).astype(np.float32)
    vis = rng.uniform(0, 1, C) > 0.3
    radii = rng.integers(0, 12, C).astype(np.int32)
    jn = jdens.add_densification_stats(js, jnp.asarray(g2), jnp.asarray(vis), jnp.asarray(radii))
    tn = tdens.add_densification_stats(ts, torch.tensor(g2), torch.tensor(vis), torch.tensor(radii))
    _state_close(tn, jn, "stats")
    (js2, jk), (ts2, tk) = jdens.scrub_nonfinite(jn), tdens.scrub_nonfinite(tn)
    assert int(tk) == int(jk) == 1
    _close(ts2.alive, js2.alive, "scrub")


def test_split_draws_are_seeded():
    a = tdens.split_draws(torch.Generator().manual_seed(3), 10, "cpu")
    b = tdens.split_draws(torch.Generator().manual_seed(3), 10, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (10, 3) and not torch.equal(a[0], a[1])
