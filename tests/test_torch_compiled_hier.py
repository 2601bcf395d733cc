"""The hierarchy's compiled boundaries (train/hier_trainer.py's
CompiledHierTrainStep, hier/interp.py's CompiledLodFrame) on the CPU: the
bodies a CUDA graph captures, called without capture on static CPU
buffers, against the eager functions and the JAX package's jitted ones;
the static keys; the refusal of a CPU state; the arrays the LOD frame and
the cut hold by reference, on the CPU stand-in for a capture
(tests/torch_graph_standin.py). The card tests in
tests/test_torch_cuda.py capture and replay them.

Problems: tests/test_torch_hier_trainer.py's post-opt scene (a 40-leaf
hierarchy, three 48x48 ring views) and tests/test_torch_hier.py's frame
scene (a 48-leaf hierarchy, one 64x64 view). Tolerances:
  * the captured post-opt body against the eager `hier_train_step`:
    bitwise (the same operations on the same inputs, the new state copied
    into the buffers; the exposure row read by a one-element gather of a
    tensor index where the eager step indexes with an int);
  * against JAX's jitted `hier_train_step`, the trainer's
    (tests/test_torch_hier_trainer.py): losses rtol 1e-3, `n_visible`
    equal, the first step's gradients normalised atol 5e-3, the parameters
    within 1e-2·lr where the gradient is signal, frozen rows unchanged;
  * the LOD frame body against JAX's `fused_lod_frame`: the blend
    tolerance, atol 3e-4 / rtol 1e-3, `num_selected` equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_graph_standin
from test_torch_hier import hier_arrays, scene48  # noqa: F401  (scene48: a fixture)
from test_torch_hier_trainer import TCFG, _cut_target, assert_runs_match, host_state, problem  # noqa: F401

from hidegs_tpu.hier import interp as jinterp
from hidegs_tpu.hier import lod as jlod
from hidegs_tpu.model.schedules import LRConfig as JLRConfig
from hidegs_tpu.model.schedules import lr_tree as jlr_tree
from hidegs_tpu.raster.api import RasterConfig as JConfig
from hidegs_tpu.train import hier_trainer as jht
from hidegs_tpu_torch.hier import interp as tinterp
from hidegs_tpu_torch.hier import io as tio
from hidegs_tpu_torch.hier import lod as tlod
from hidegs_tpu_torch.model.schedules import LRConfig, lr_tree
from hidegs_tpu_torch.raster.api import RasterConfig
from hidegs_tpu_torch.train import hier_trainer as tht
from hidegs_tpu_torch.utils import graphs

torch.set_num_threads(1)

JCFG = JConfig(backend="jnp", max_instances=1 << 12)
BUDGET = 128
BLEND_TOL = dict(atol=3e-4, rtol=1e-3)

VARIANTS = {  # tests/test_torch_hier_trainer.py's four
    "plain": dict(),
    "skybox_tail": dict(skybox_count=6),
    "frozen_anchors": dict(frozen=True),
    "exposure": dict(use_exposure=True, optimize_exposure=True),
}


def _frozen(P):
    frozen = np.zeros(P, bool)
    frozen[np.random.default_rng(3).choice(P, P // 4, replace=False)] = True
    return frozen


def _static_state(ts):
    """A state whose written fields are clones: the graph's buffers."""
    return ts._replace(**dict(zip(tht._STEP_FIELDS, graphs._map(torch.clone, tht._written(ts)))))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_captured_post_opt_body_matches_eager_and_jax(problem, variant):  # noqa: F811
    """K = 3 steps (views 0, 1, 2) of `hier_step_in_place` on static CPU
    buffers, the image index a tensor: bitwise 3 eager `hier_train_step`s
    (state and metrics, the buffers written in place), and JAX's jitted
    `hier_train_step` on the same cuts at the trainer's tolerances."""
    h, jcams, tcams, gts = problem
    kw = dict(VARIANTS[variant])
    P = h.num_points
    frozen_np = _frozen(P) if kw.pop("frozen", False) else None
    target = _cut_target(jcams[0])
    jts = jht.state_from_hierarchy(h, num_images=3)
    eager = tht.state_from_hierarchy(tio.Hierarchy(*h), num_images=3, device="cpu")
    static = _static_state(eager)
    params0 = host_state(eager)["params"]
    ptrs = [x.data_ptr() for x in graphs._tensors(tht._written(static))]
    frozen = None if frozen_np is None else torch.as_tensor(frozen_np)
    jruns, truns = [], []
    for k in range(3):
        cut = tht.select_cut(eager, tcams[k], target, BUDGET)
        lrs = lr_tree(eager.step, LRConfig(), 1.0)
        eager, em = tht.hier_train_step(eager, cut, tcams[k], torch.as_tensor(gts[k]), lrs, TCFG, frozen=frozen,
                                        image_idx=k, **kw)
        sm = tht.hier_step_in_place(static, cut, tcams[k], torch.as_tensor(gts[k]), lrs, TCFG, frozen=frozen,
                                    image_idx=torch.tensor(k), **kw)
        for n, (a, b) in enumerate(zip(graphs._tensors(tht._written(static)), graphs._tensors(tht._written(eager)),
                                       strict=True)):
            assert torch.equal(a, b), f"{variant} step {k}: tensor {n} of the state"
        assert em.keys() == sm.keys() and all(torch.equal(em[m], sm[m]) for m in em), variant
        counters = dict(zip(tht.COUNTERS, sm["counters"].tolist()))
        assert all(counters[c] == 0 for c in ("overflow", "block_overflow", "visible_overflow"))
        assert counters["num_instances"] > 0
        jcut = jht.select_cut(jts, jcams[k], target, BUDGET)
        jts, jm = jht.hier_train_step(
            jts, jcut, jcams[k], jnp.asarray(gts[k]), jlr_tree(jts.step, JLRConfig(), jnp.float32(1.0)), JCFG,
            frozen=None if frozen_np is None else jnp.asarray(frozen_np), image_idx=k, **kw)
        jruns.append((host_state(jts), {"loss": float(jm["loss"]), "n_visible": int(jm["n_visible"])}))
        truns.append((host_state(static), {"loss": float(sm["loss"]), "n_visible": int(sm["n_visible"])}))
    assert [x.data_ptr() for x in graphs._tensors(tht._written(static))] == ptrs, "the step wrote outside the buffers"
    truns[0][0]["params0"] = params0
    assert_runs_match(jruns, truns, frozen=frozen_np)
    assert truns[-1][0]["step"] == 3


def test_image_row_reads_a_tensor_index_as_a_gather():
    """`image_row` gives `exposure[i]` for an int and for a 0-d tensor,
    values and gradient bitwise."""
    expo = torch.randn(5, 3, 4, generator=torch.Generator().manual_seed(0))
    w = torch.randn(3, 4, generator=torch.Generator().manual_seed(1))
    grads = []
    for idx in (3, torch.tensor(3), torch.tensor(3, dtype=torch.int32)):
        e = expo.clone().requires_grad_(True)
        row = tht.image_row(e, idx)
        assert torch.equal(row, expo[3])
        grads.append(torch.autograd.grad(torch.sum(row * w), e)[0])
    assert all(torch.equal(g, grads[0]) for g in grads)


@pytest.mark.parametrize("tau", [0.0, 3.0, 6.0])
def test_lod_frame_body_matches_jax(scene48, tau):  # noqa: F811
    """`CompiledLodFrame.body` (what a frame graph captures) with the
    renderer's packed hierarchy and attribute matrix, against JAX's
    `fused_lod_frame` at the same target and budget."""
    h, jcam, tcam = scene48
    (tn, tb, *tarr), (jn, jb, *jarr) = hier_arrays(h)
    target = 0.0 if tau == 0 else jlod.tau_to_target_size(tau, float(jcam.fx))
    jcfg, tcfg = JConfig(backend="jnp", max_instances=1 << 13), RasterConfig(max_instances=1 << 13)
    want = jinterp.fused_lod_frame(jlod.pack_hierarchy(jn, jb), jnp.float32(target), jcam, *jarr, budget=256,
                                   num_points=h.num_points, config=jcfg)
    got = tinterp.CompiledLodFrame.body(tlod.pack_hierarchy(tn, tb), torch.tensor(target, dtype=torch.float32), tcam,
                                        *tarr, budget=256, num_points=h.num_points, config=tcfg,
                                        attrs=tinterp.pack_attributes(*tarr))
    for k in ("render", "alpha", "invdepth", "T_final"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **BLEND_TOL)
    assert int(got["num_selected"]) == int(want["num_selected"]) > 0
    assert not any(v.requires_grad for v in got.values())


def _post_opt_call(problem, k=0, **kw):  # noqa: F811
    """The arguments of a post-opt step on view k of the problem."""
    h, jcams, tcams, gts = problem
    ts = tht.state_from_hierarchy(tio.Hierarchy(*h), num_images=3, device="cpu")
    cut = tht.select_cut(ts, tcams[k], _cut_target(jcams[0]), BUDGET)
    args = dict(ts=ts, cut=cut, cam=tcams[k], gt_image=torch.as_tensor(gts[k]),
                lr_cfg_tree=lr_tree(ts.step, LRConfig(), 1.0), raster_cfg=TCFG)
    args.update(kw)
    return args


def test_post_opt_static_key_changes_with_what_jax_retraces_on(problem):  # noqa: F811
    """The key changes with each static argument, the cut budget, the image
    size, a learning rate's float leaf and whether `frozen` is given, and
    with nothing a step only reads the values of (another view, other
    state values, the image index is not an argument of the key)."""
    base = _post_opt_call(problem)
    key = tht.hier_static_key(**base)
    P = base["ts"].params.xyz.shape[0]
    small_cam = dataclasses.replace(base["cam"], height=40, width=32)
    wide_cut = tht.select_cut(base["ts"], base["cam"], _cut_target(problem[1][0]), 2 * BUDGET)
    changed = {
        "raster_cfg": dict(raster_cfg=dataclasses.replace(TCFG, max_instances=1 << 13)),
        "lambda_dssim": dict(lambda_dssim=0.3),
        "skybox_count": dict(skybox_count=6),
        "use_exposure": dict(use_exposure=True),
        "optimize_exposure": dict(use_exposure=True, optimize_exposure=True),
        "cut budget": dict(cut=wide_cut),
        "image size": dict(cam=small_cam, gt_image=base["gt_image"][:, :40, :32]),
        "a float learning rate": dict(lr_cfg_tree=base["lr_cfg_tree"]._replace(opacity=0.01)),
        "frozen given": dict(frozen=torch.zeros(P, dtype=torch.bool)),
    }
    keys = {what: tht.hier_static_key(**{**base, **kw}) for what, kw in changed.items()}
    for what, other in keys.items():
        assert other != key, what
    assert len(set(keys.values())) == len(keys)
    view2 = _post_opt_call(problem, k=2)
    same = {
        "another view and its cut": view2,
        "other state values": {**base, "ts": base["ts"]._replace(
            params=graphs._map(lambda x: x + 1, base["ts"].params), step=base["ts"].step + 7)},
        "a later step's learning rates": {**base, "lr_cfg_tree": lr_tree(base["ts"].step + 500, LRConfig(), 1.0)},
    }
    for what, args in same.items():
        assert tht.hier_static_key(**args) == key, what
    hash(key)


def test_post_optimize_keeps_one_key_across_its_steps(problem, monkeypatch):  # noqa: F811
    """Every step of post_optimize (5 iterations over three views, exposure
    trained, frozen anchors) has one step key and one cut key: the image
    index and the learning-rate schedule change none of them."""
    h, jcams, tcams, gts = problem
    keys, cut_keys, indices = set(), set(), []
    step, select = tht.hier_train_step, tht.select_cut

    def keyed_step(ts, cut, cam, gt, lrs, rcfg, image_idx=0, **kw):
        keys.add(tht.hier_static_key(ts, cut, cam, gt, lrs, rcfg, **kw))
        indices.append(image_idx)
        return step(ts, cut, cam, gt, lrs, rcfg, image_idx=image_idx, **kw)

    def keyed_select(ts, cam, target, budget):
        cut_keys.add(tht.select_static_key(ts, target, budget))
        return select(ts, cam, target, budget)

    monkeypatch.setattr(tht, "hier_train_step", keyed_step)
    monkeypatch.setattr(tht, "select_cut", keyed_select)
    anchors = np.arange(0, h.num_points, 5, dtype=np.int32)
    tht.post_optimize(tio.Hierarchy(*h), tcams, gts, iterations=5, target_size=_cut_target(jcams[0]), budget=BUDGET,
                      raster_cfg=TCFG, log_every=1000, anchors=anchors, optimize_exposure=True, device="cpu")
    assert len(keys) == 1 and len(cut_keys) == 1, (len(keys), len(cut_keys))
    assert all(isinstance(i, torch.Tensor) and i.shape == () for i in indices)
    assert len({int(i) for i in indices}) > 1


def test_select_static_key(problem):  # noqa: F811
    """The cut's key changes with the budget, the float target and the
    hierarchy's size, not with the state's values or a tensor target's."""
    ts = _post_opt_call(problem)["ts"]
    key = tht.select_static_key(ts, 0.01, BUDGET)
    h = problem[0]
    bigger = tht.state_from_hierarchy(tio.Hierarchy(*h)._replace(
        nodes=np.concatenate([h.nodes, h.nodes[-1:]]), boxes=np.concatenate([h.boxes, h.boxes[-1:]])),
        num_images=3, device="cpu")
    for what, other in {"budget": tht.select_static_key(ts, 0.01, 2 * BUDGET),
                        "float target": tht.select_static_key(ts, 0.02, BUDGET),
                        "hierarchy size": tht.select_static_key(bigger, 0.01, BUDGET)}.items():
        assert other != key, what
    assert tht.select_static_key(ts._replace(params=graphs._map(lambda x: x * 2, ts.params)), 0.01, BUDGET) == key
    assert (tht.select_static_key(ts, torch.tensor(0.01), BUDGET)
            == tht.select_static_key(ts, torch.tensor(0.5), BUDGET))


def test_lod_frame_key_changes_with_what_jax_retraces_on(scene48):  # noqa: F811
    """JAX's static names, the image size and a background change the
    frame's key; the camera pose and a tensor target do not."""
    h, _, tcam = scene48
    (tn, tb, *tarr), _ = hier_arrays(h)
    packed = tlod.pack_hierarchy(tn, tb)
    attrs = tinterp.pack_attributes(*tarr)
    cfg = RasterConfig(max_instances=1 << 13)
    base = dict(packed=packed, target_size=torch.tensor(0.02), cam=tcam, means3d=tarr[0], scales=tarr[1],
                quats=tarr[2], opacities=tarr[3], shs=tarr[4], budget=256, num_points=h.num_points, config=cfg,
                attrs=attrs)
    key = tinterp.lod_frame_key(**base)
    changed = {
        "budget": dict(budget=512),
        "num_points": dict(num_points=h.num_points + 1),
        "skybox_count": dict(skybox_count=4),
        "config": dict(config=dataclasses.replace(cfg, max_instances=1 << 14)),
        "active_sh_degree": dict(active_sh_degree=1),
        "render_geo": dict(render_geo=True),
        "image size": dict(cam=dataclasses.replace(tcam, height=48, width=40)),
        "background": dict(background=torch.zeros(3)),
        "no attrs": dict(attrs=None),
    }
    keys = {what: tinterp.lod_frame_key(**{**base, **kw}) for what, kw in changed.items()}
    for what, other in keys.items():
        assert other != key, what
    assert len(set(keys.values())) == len(keys)
    moved = dataclasses.replace(tcam, t=tcam.t + 0.5, fx=tcam.fx * 1.1)
    assert tinterp.lod_frame_key(**{**base, "cam": moved, "target_size": torch.tensor(0.3)}) == key
    hash(key)


def test_compiled_callables_refuse_a_cpu_state(problem, scene48):  # noqa: F811
    """No fallback: each compiled callable raises on CPU tensors, naming
    the eager function; the renderer renders eagerly off the card."""
    args = _post_opt_call(problem)
    step = tht.CompiledHierTrainStep()
    with pytest.raises(ValueError, match="hier_train_step"):
        step(**args)
    with pytest.raises(ValueError, match="select_cut"):
        step.select(args["ts"], args["cam"], 0.01, BUDGET)
    h, _, tcam = scene48
    (tn, tb, *tarr), _ = hier_arrays(h)
    with pytest.raises(ValueError, match="fused_lod_frame"):
        tinterp.CompiledLodFrame()(tlod.pack_hierarchy(tn, tb), 0.02, tcam, *tarr, budget=256,
                                   num_points=h.num_points)
    r = tinterp.AdaptiveHierRenderer(tn, tb, *tarr, num_points=h.num_points)
    assert r.compiled is None
    with torch.no_grad():
        out = r.render(tcam, 3.0)
    assert int(out["overflow"]) == 0 and int(out["num_selected"]) > 0


@pytest.mark.parametrize("boundary", ["lod frame", "cut"])
def test_held_arrays_are_refused_on_any_key(problem, scene48, monkeypatch, boundary):  # noqa: F811
    """The LOD frame's hierarchy arrays and the cut's packed hierarchy are
    held by reference: replays equal the eager function; other tensors
    for them raise, on the captured key and on a new key, and capture
    nothing; the held tensors then capture the new key."""
    torch_graph_standin.install(monkeypatch, tinterp, tht)
    if boundary == "lod frame":
        h, _, tcam = scene48
        (tn, tb, *tarr), _ = hier_arrays(h)
        packed, attrs = tlod.pack_hierarchy(tn, tb), tinterp.pack_attributes(*tarr)
        comp, budget = tinterp.CompiledLodFrame(), 256
        kw = dict(num_points=h.num_points, config=RasterConfig(max_instances=1 << 13))

        def call(budget, attrs=attrs):
            return comp(packed, torch.tensor(0.02), tcam, *tarr, budget=budget, attrs=attrs, **kw)

        def eager(budget):
            return tinterp.CompiledLodFrame.body(packed, torch.tensor(0.02), tcam, *tarr, budget=budget, attrs=attrs,
                                                 **kw)

        other = dict(attrs=attrs.clone())
    else:
        args = _post_opt_call(problem)
        ts, cam, target = args["ts"], args["cam"], _cut_target(problem[1][0])
        comp, budget = tht.CompiledHierTrainStep(), BUDGET

        def call(budget, ts=ts):
            return comp.select(ts, cam, target, budget)

        def eager(budget):
            return tht.select_cut(ts, cam, target, budget)

        other = dict(ts=ts._replace(packed=graphs._map(torch.clone, ts.packed)))
    for b in (budget, budget, 2 * budget):
        if b == 2 * budget:
            for new_key in (False, True):
                with pytest.raises(ValueError, match="by reference"):
                    call(2 * budget if new_key else budget, **other)
            assert len(comp.captures) == 1 and comp.replays == 2
        got, want = graphs._tensors(call(b)), graphs._tensors(eager(b))
        assert len(got) == len(want) and all(torch.equal(x, y) for x, y in zip(got, want)), (boundary, b)
    assert [c["budget"] for c in comp.captures] == [budget, 2 * budget] and comp.replays == 3


def test_same_tensors_is_memory_identity():
    """The by-reference check of the compiled callables: the same tensors
    pass, clones and views of other shapes do not."""
    a = (torch.zeros(4), [torch.ones(2, 3)], None)
    assert graphs.same_tensors(a, a)
    assert graphs.same_tensors(a, (a[0], [a[1][0]], 1.0))
    assert not graphs.same_tensors(a, graphs._map(torch.clone, a))
    assert not graphs.same_tensors(a, (a[0][:2], a[1], None))
    assert not graphs.same_tensors(a, (a[0],))
