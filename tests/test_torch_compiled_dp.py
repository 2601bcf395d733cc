"""The compiled view-parallel step (parallel/compiled.py) on the CPU: the
body a CUDA graph captures (`sharded.dp_step_in_place`, the step written
into the state's own buffers), called without capture on CPU buffers,
against the eager step and the JAX package's DP step; the same under
spawned gloo ranks; the static key and its cross-rank digest; the call
path with a stand-in for the capture (tests/torch_graph_standin.py); the
refusals. The card tests in tests/test_torch_cuda.py capture and replay.

Problem and tolerances: tests/torch_dp_problem.py's (tests/test_parallel.py's
60-gaussian problem at 32x32, V = 4, K = 3 steps; tests/test_torch_train.py's
tolerances against JAX). Against the eager step: bitwise (the same
operations on the same inputs, then a copy into the buffers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_graph_standin

from hidegs_tpu.parallel.mesh import make_mesh as jmake_mesh
from hidegs_tpu.parallel.sharded import make_dp_train_step as jmake_dp
from hidegs_tpu.train import geometric as jgeo
from hidegs_tpu.train import loop as jl
from hidegs_tpu_torch import convert
from hidegs_tpu_torch.parallel import compiled as pc
from hidegs_tpu_torch.parallel import distributed as pdist
from hidegs_tpu_torch.parallel import dryrun, sharded
from hidegs_tpu_torch.parallel import mesh as pmesh
from hidegs_tpu_torch.train.geometric import MultiViewBatch
from hidegs_tpu_torch.utils import graphs
from torch_dp_problem import JCFG, K, TCFG, V, W, H, check_against_jax, jax_dp_runs, make_problem, normalised_close
from torch_dp_problem import tstate

torch.set_num_threads(1)

MV_VIEWS, MV_SAMPLES = 2, 256
LAUNCH_TIMEOUT = 300.0


@pytest.fixture(scope="module")
def problem():
    return make_problem()


def _mv_problem(problem):
    """Two views, each the other's multi-view source, on JAX's (2, 1) mesh
    with its draws: (JAX's K steps, the port's batch, config and the draws
    as `uv`, C26)."""
    jb = problem["jbatch"]
    jsrc = jax.tree.map(lambda x: x[jnp.array([1, 0])], jb)
    jmv = jgeo.MultiViewBatch(src_image_gray=jnp.mean(jsrc.image, axis=1), src_cam=jsrc.cam)
    jbatch = jax.tree.map(lambda x: x[:MV_VIEWS], jb._replace(multi_view=jmv))
    jcfg = dataclasses.replace(JCFG, multi_view_from=0, multi_view_sample_num=MV_SAMPLES)
    step, place = jmake_dp(jcfg, jmake_mesh(MV_VIEWS, data=MV_VIEWS, model=1))
    jts, jbatch = place(jl.init_train_state(jax.tree.map(jnp.copy, problem["jstate"]), num_images=V), jbatch)
    jsteps, uvs = [], []
    for _ in range(K):
        _, sub = jax.random.split(jts.rng)
        draws = []
        for key in jax.random.split(sub, MV_VIEWS):  # multi_view_losses' draw: k1 of split(key)
            k1, _ = jax.random.split(key)
            draws.append(np.asarray(jax.random.uniform(k1, (MV_SAMPLES, 2), minval=jnp.array([2.0, 2.0]),
                                                       maxval=jnp.array([W - 2.0, H - 2.0]))))
        uvs.append(convert.pixel_samples_from_jax(draws, device="cpu"))
        jts, m = step(jts, jbatch)
        jsteps.append((jax.tree.map(np.asarray, jts), {k: float(v) for k, v in m.items()}))
    views = sharded.unstack_view_batch(problem["tbatch"])
    tbatch = sharded.stack_view_batches(
        [views[i]._replace(multi_view=MultiViewBatch(src_image_gray=views[1 - i].image.mean(0),
                                                     src_cam=views[1 - i].cam)) for i in range(MV_VIEWS)])
    tcfg = dataclasses.replace(TCFG, multi_view_from=0, multi_view_sample_num=MV_SAMPLES)
    return jsteps, tbatch, tcfg, uvs


def _variant(problem, name):
    """(JAX's K steps, the batch, the config, the step's keyword arguments,
    the K injected samples or Nones)."""
    if name == "multi-view":
        jsteps, tbatch, tcfg, uvs = _mv_problem(problem)
        return jsteps, tbatch, tcfg, {}, uvs
    wire = torch.bfloat16 if name == "bf16" else None
    jsteps = jax_dp_runs(problem, 1 if wire else V, 1, jnp.bfloat16 if wire else None,
                         use_exposure=name == "exposure")
    return jsteps, problem["tbatch"], TCFG, dict(grad_reduce_dtype=wire, use_exposure=name == "exposure"), [None] * K


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("name", ["f32", "bf16", "exposure", "multi-view"])
def test_dp_body_is_bitwise_eager_and_matches_jax(problem, name):
    """K steps of the captured body on static CPU buffers: after every step
    each tensor of the state and each metric bitwise the eager step's (fed
    the same samples); the buffers are written in place; the K steps within
    tests/test_torch_parallel.py's tolerances of JAX's DP step (the
    exposure too, normalised atol 1e-2)."""
    jsteps, batch, cfg, kwargs, uvs = _variant(problem, name)
    step, _ = sharded.make_dp_train_step(cfg, None, **kwargs)
    plan = sharded.dp_plan(cfg, None, **kwargs)
    eager = tstate(problem)
    state = graphs._map(torch.clone, eager)
    ptrs = [x.data_ptr() for x in graphs._tensors(state)]
    firsts, metrics = None, []
    for k, uv in enumerate(uvs):
        eager, em = step(eager, batch, uv=uv)
        cm = sharded.dp_step_in_place(plan, state, batch, uv)
        for n, (a, b) in enumerate(zip(graphs._tensors(state), graphs._tensors(eager), strict=True)):
            assert torch.equal(a, b), f"{name} step {k}: tensor {n} of the state"
        assert em.keys() == cm.keys() and all(torch.equal(em[m], cm[m]) for m in em), f"{name} step {k}"
        metrics.append(_metrics(cm))
        if k == 0:
            firsts = graphs._map(torch.clone, state)
    assert [x.data_ptr() for x in graphs._tensors(state)] == ptrs
    assert int(state.step) == K
    check_against_jax(problem["state"], jsteps, firsts, state, metrics)
    if name == "exposure":
        normalised_close(state.exposure.numpy() - np.eye(3, 4), jsteps[-1][0].exposure - np.eye(3, 4), 1e-2,
                         "exposure")
        assert not torch.equal(state.exposure, tstate(problem).exposure)
    if name == "multi-view":
        assert all(js[1]["mv_geo"] > 0 for js in jsteps), "no valid multi-view sample: the check would be vacuous"
        for (_, jm), tm in zip(jsteps, metrics):
            for key in ("mv_ncc", "mv_geo"):
                np.testing.assert_allclose(tm[key], jm[key], rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("ranks,runs", [
    (2, [dict(name="dp", data=2, model=1, steps=K), dict(name="dp_bf16", data=2, model=1, wire="bf16", steps=K)]),
    (4, [dict(name="shard", data=2, model=2, shard=True, steps=K),
         dict(name="shard_pre", data=2, model=2, shard=True, replicate_preprocessed=True, steps=K)]),
], ids=["two_ranks", "mesh_2x2_rows_split"])
def test_dp_body_under_gloo_ranks_is_bitwise_eager(problem, tmp_path, ranks, runs):
    """The body under spawned gloo ranks (tests/test_torch_distributed.py's
    launch): two ranks on the data dimension, and a 2x2 mesh with the rows
    split over "model" (gathered before the render, and inside it); on
    every rank each step's state and metrics bitwise the eager step's, and
    the final states bitwise equal on the ranks that hold the same rows."""
    from torch_dp_ranks import body_worker

    job = tmp_path / "job.pt"
    dryrun.save_dp_job(str(job), tstate(problem), sharded.unstack_view_batch(problem["tbatch"]), TCFG, runs)
    try:
        dryrun.launch(body_worker, ranks, (dryrun.file_init_method(str(tmp_path)), str(job), str(tmp_path)),
                      LAUNCH_TIMEOUT, str(tmp_path / "logs"), threads=1)
    except TimeoutError as e:
        pytest.fail(f"{ranks} ranks: {e}", pytrace=False)
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(ranks)]
    for run in runs:
        n = run["name"]
        for r in range(ranks):
            assert res[r][n]["equal"] == [True] * K, (n, r, res[r][n]["equal"])
            same_rows = r % run["model"]  # rank r sits at (r // model, r % model)
            assert np.array_equal(res[r][n]["digest"], res[same_rows][n]["digest"]), (n, r)
            assert res[r][n]["losses"] == res[0][n]["losses"], (n, r)
        assert np.isfinite(res[0][n]["losses"]).all()


def test_static_key_changes_with_what_jax_retraces_on(problem):
    """The key changes with the config, the wire, the exposure switch, the
    placement flags, the view count, the image size and the multi-view
    part; not with the values of the state, the batch or the samples."""
    ts, batch = tstate(problem), problem["tbatch"]
    key = pc.dp_static_key(ts, batch, TCFG)
    two = sharded.select_views(batch, 0, 2)
    small = dataclasses.replace(batch.cam, height=16, width=16)
    mv = batch._replace(multi_view=MultiViewBatch(src_image_gray=batch.image.mean(1), src_cam=batch.cam))
    changed = {
        "cfg": pc.dp_static_key(ts, batch, dataclasses.replace(TCFG, raster=dataclasses.replace(
            TCFG.raster, max_instances=1 << 13))),
        "wire": pc.dp_static_key(ts, batch, TCFG, grad_reduce_dtype=torch.bfloat16),
        "exposure": pc.dp_static_key(ts, batch, TCFG, use_exposure=True),
        "replicate_preprocessed": pc.dp_static_key(ts, batch, TCFG, replicate_preprocessed=True),
        "shard_gaussians": pc.dp_static_key(ts, batch, TCFG, shard_gaussians=True),
        "views": pc.dp_static_key(ts, two, TCFG),
        "image size": pc.dp_static_key(ts, batch._replace(cam=small, image=batch.image[..., :16, :16]), TCFG),
        "multi-view": pc.dp_static_key(ts, mv, TCFG, uv=torch.zeros((V, 64, 2))),
        "capacity": pc.dp_static_key(graphs._map(lambda x: torch.cat([x, x]) if x.ndim and x.shape[0] == 64
                                                 else x, ts), batch, TCFG),
    }
    for what, other in changed.items():
        assert other != key, what
        assert not np.array_equal(pc.key_digest(other), pc.key_digest(key)), what
    assert len(set(changed.values())) == len(changed)
    same = {
        "state values": pc.dp_static_key(graphs._map(lambda x: x + 1 if x.is_floating_point() else x, ts),
                                         batch, TCFG),
        "batch values": pc.dp_static_key(ts, graphs._map(lambda x: x * 2 if x.is_floating_point() else x, batch),
                                         TCFG),
        "generator state": pc.dp_static_key(ts._replace(mv_generator=torch.Generator().manual_seed(9)), batch, TCFG),
        "samples without a multi-view part": pc.dp_static_key(ts, batch, TCFG, uv=torch.zeros((V, 64, 2))),
    }
    for what, other in same.items():
        assert other == key, what
    hash(key)


def test_key_digest_is_the_same_on_every_card():
    """The cross-rank check compares digests: a key whose tensors lie on
    another card of the same kind has the same digest, one of another
    shape does not."""
    a = ((4, 3), torch.float32, torch.device("cuda", 0))
    b = ((4, 3), torch.float32, torch.device("cuda", 3))
    c = ((4, 2), torch.float32, torch.device("cuda", 0))
    assert np.array_equal(pc.key_digest(("k", (a,))), pc.key_digest(("k", (b,))))
    assert not np.array_equal(pc.key_digest(("k", (a,))), pc.key_digest(("k", (c,))))
    assert pc.key_digest(("k", (a,))).shape == (16,)


def test_compiled_call_path_on_a_stand_in_capture(problem, monkeypatch):
    """CompiledDPStep's own call path, with a stand-in for the capture: K
    multi-view steps that draw their samples before each replay from a copy
    of `mv_generator` are bitwise the eager step's (the generator advanced
    alike), then a fresh state is copied in and a bf16 step of another
    CompiledDPStep replays too; one capture per key; the returned state is
    the static buffers, and passing them back copies none of them."""
    torch_graph_standin.install(monkeypatch)
    _, batch, cfg, _ = _mv_problem(problem)
    step, place = pc.compile_dp_train_step(cfg)
    eager_step, _ = sharded.make_dp_train_step(cfg)
    ts, _ = place(tstate(problem), batch)
    eager = comp = ts
    ptrs = None
    for k in range(K):
        eager, em = eager_step(eager, batch)
        if ptrs is not None:
            state = next(iter(step._states.values()))
            assert graphs.copy_into(state, comp) == 0, "the returned buffers were copied in"
        comp, cm = step(comp, batch)
        for n, (a, b) in enumerate(zip(graphs._tensors(comp), graphs._tensors(eager), strict=True)):
            assert torch.equal(a, b), f"step {k}: tensor {n}"
        assert all(torch.equal(em[m], cm[m]) for m in em)
        assert torch.equal(comp.mv_generator.get_state(), eager.mv_generator.get_state())
        now = [x.data_ptr() for x in graphs._tensors(comp)]
        assert ptrs is None or now == ptrs
        ptrs = now
    assert len(step.captures) == 1 and step.replays == K
    assert step.captures[0]["views"] == MV_VIEWS and step.captures[0]["multi_view"]
    b16, _ = pc.compile_dp_train_step(TCFG, grad_reduce_dtype=torch.bfloat16)
    e16, _ = sharded.make_dp_train_step(TCFG, grad_reduce_dtype=torch.bfloat16)
    a, am = b16(tstate(problem), problem["tbatch"])
    b, bm = e16(tstate(problem), problem["tbatch"])
    assert all(torch.equal(x, y) for x, y in zip(graphs._tensors(a), graphs._tensors(b), strict=True))
    assert _metrics(am) == _metrics(bm)


def test_compiled_step_refuses_a_cpu_state_and_a_gloo_mesh(problem, tmp_path):
    """No fallback: a CPU state raises ValueError naming the eager
    `make_dp_train_step`; so does a gloo mesh, whose collectives cannot be
    captured, when the step is made; a state split otherwise raises before
    anything is copied."""
    ts, batch = tstate(problem), problem["tbatch"]
    step, _ = pc.compile_dp_train_step(TCFG)
    with pytest.raises(ValueError, match="make_dp_train_step"):
        step(ts, batch)
    with pytest.raises(ValueError, match="split over 2 model ranks"):
        step(ts._replace(rows_split=2), batch)
    assert not step._states and not step.captures
    pdist.initialize_distributed(backend="gloo", device="cpu", init_method=dryrun.file_init_method(tmp_path),
                                 world_size=1, rank=0)
    try:
        mesh = pmesh.make_mesh(1, device_type="cpu")
        assert pc.mesh_backend(mesh) == "gloo"
        with pytest.raises(ValueError, match="gloo.*make_dp_train_step"):
            pc.CompiledDPStep(TCFG, mesh)
        with pytest.raises(ValueError, match="make_dp_train_step"):
            pc.compile_dp_train_step(TCFG, mesh, grad_reduce_dtype=torch.bfloat16)
        step, _ = dryrun.dp_step(torch.device("cpu"), TCFG, mesh)  # the dry run's choice: eager here
        assert not isinstance(step, pc.CompiledDPStep)
    finally:
        pdist.shutdown_distributed()
    assert pc.mesh_backend(None) is None
