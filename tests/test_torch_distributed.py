"""The view-parallel step across processes: 2 ranks and a 2x2 mesh over
gloo on the CPU, held against the JAX package's DP step on 2- and 4-device
meshes of the suite's virtual CPU devices, and against the port's own run
in one process; the ranks bitwise equal; the gaussian-sharded gradient not
scaled by the model size; the collectives of the sharded step with
`replicate_preprocessed`; the schedule leg of the dry run at 2 ranks.

The ranks are spawned processes (hidegs_tpu_torch.parallel.dryrun.launch:
torch.multiprocessing, one torch thread each) that meet at a file://
rendezvous under tmp_path, so no port can collide between test workers;
they run dryrun.dp_worker (or dryrun_worker), which import neither this
module nor jax. Each launch has its own timeout and fails with the ranks'
output when it runs out. The problem and the tolerances are
tests/torch_dp_problem.py's; the JAX steps run once per module.
"""
import numpy as np
import pytest
import torch

from hidegs_tpu.parallel import distributed as jdist
from hidegs_tpu_torch.parallel import dryrun, sharded
from torch_dp_problem import K, TCFG, V, check_against_jax, jax_dp_runs, make_problem, normalised_close, tstate

torch.set_num_threads(1)

LAUNCH_TIMEOUT = 300.0
TWO_RANK_RUNS = [
    dict(name="f32", data=2, model=1, steps=K, save_steps=[1, K]),
    dict(name="bf16", data=2, model=1, wire="bf16", steps=K, save_steps=[1, K]),
]
MESH_RUNS = [
    dict(name="repl", data=2, model=2, steps=K, save_steps=[1, K]),
    dict(name="shard", data=2, model=2, shard=True, steps=K, save_steps=[1, K]),
    dict(name="shard_bf16", data=2, model=2, shard=True, wire="bf16", steps=K, save_steps=[1, K]),
    dict(name="shard_pre", data=2, model=2, shard=True, replicate_preprocessed=True, steps=5, save_steps=[1, 5],
         record=True),
]


def _launch(fn, nproc, args, tmp, what):
    try:
        return dryrun.launch(fn, nproc, args, LAUNCH_TIMEOUT, str(tmp / "logs"), threads=1)
    except TimeoutError as e:
        pytest.fail(f"{what}: {e}", pytrace=False)


def _run_ranks(problem, runs, nproc, tmp):
    job = tmp / "job.pt"
    dryrun.save_dp_job(str(job), tstate(problem), sharded.unstack_view_batch(problem["tbatch"]), TCFG, runs)
    _launch(dryrun.dp_worker, nproc,
            (dryrun.file_init_method(str(tmp)), "gloo", "cpu", str(job), str(tmp)), tmp, f"{nproc} ranks")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(nproc)]


@pytest.fixture(scope="module")
def problem():
    return make_problem()


@pytest.fixture(scope="module")
def two_ranks(problem, tmp_path_factory):
    return _run_ranks(problem, TWO_RANK_RUNS, 2, tmp_path_factory.mktemp("two_ranks"))


@pytest.fixture(scope="module")
def mesh_ranks(problem, tmp_path_factory):
    return _run_ranks(problem, MESH_RUNS, 4, tmp_path_factory.mktemp("mesh_2x2"))


@pytest.fixture(scope="module")
def jax_runs(problem):
    """JAX's DP step on a (2, 1) mesh and, rows split over "model", on a
    (2, 2) mesh; float32 and the bf16 wire."""
    import jax.numpy as jnp

    return {(2, 1, None): jax_dp_runs(problem, 2, 1, None),
            (2, 1, "bf16"): jax_dp_runs(problem, 2, 1, jnp.bfloat16),
            (2, 2, None): jax_dp_runs(problem, 2, 2, None, shard_gaussians=True),
            (2, 2, "bf16"): jax_dp_runs(problem, 2, 2, jnp.bfloat16, shard_gaussians=True)}


def _check(problem, jsteps, run):
    check_against_jax(problem["state"], jsteps, run["states"][1], run["states"][len(jsteps)], run["metrics"])


@pytest.mark.parametrize("name,wire", [("f32", None), ("bf16", "bf16")])
def test_two_ranks_match_jax_on_two_devices(problem, jax_runs, two_ranks, name, wire):
    """Two views per rank; JAX on a 2-device mesh (two views per device:
    the same rounding points on the bf16 wire)."""
    _check(problem, jax_runs[(2, 1, wire)], two_ranks[0][name])


@pytest.mark.parametrize("name,wire", [("shard", None), ("shard_bf16", "bf16")])
def test_sharded_2x2_mesh_matches_jax_on_four_devices(problem, jax_runs, mesh_ranks, name, wire):
    """A 2x2 mesh, rows split over "model": JAX on a (2, 2) device mesh with
    `shard_gaussians`."""
    _check(problem, jax_runs[(2, 2, wire)], mesh_ranks[0][name])


def test_ranks_are_bitwise_equal(two_ranks, mesh_ranks):
    for ranks, runs in ((two_ranks, TWO_RANK_RUNS), (mesh_ranks, MESH_RUNS)):
        for run in runs:
            digests = [r[run["name"]]["digest"] for r in ranks]
            assert all(np.array_equal(d, digests[0]) for d in digests), run["name"]
            assert all(r[run["name"]]["losses"] == ranks[0][run["name"]]["losses"] for r in ranks), run["name"]


def test_two_ranks_match_the_one_process_run(problem, two_ranks):
    """The same step in one process (four local views, no collective): only
    the order of the gradient sum differs, so the losses agree to rtol
    1e-6 and the first step's gradients to 1e-6 of each leaf's largest."""
    step, _ = sharded.make_dp_train_step(TCFG, None)
    ts, losses = tstate(problem), []
    for k in range(K):
        ts, m = step(ts, problem["tbatch"])
        losses.append(float(m["loss"]))
        if k == 0:
            first = ts
    run = two_ranks[0]["f32"]
    np.testing.assert_allclose(run["losses"], losses, rtol=1e-6)
    for f in ("xyz", "sh_dc", "sh_rest", "scaling", "rotation", "opacity"):
        normalised_close(run["states"][1]["m"][f], getattr(first.opt.m, f).numpy(), 1e-6, f"m {f}")


def test_sharded_gradient_is_not_scaled_by_the_model_size(mesh_ranks):
    """Rows split over a model group of 2 give the replicated run's
    gradients (Adam's m after one step = 0.1·g): the gathered rows' slice,
    not a sum over the group (which would double them). With the
    preprocessed rows gathered inside the render the gradients take
    another path through autograd: equal within 1e-6 of each leaf's max."""
    repl, shard, pre = (mesh_ranks[0][n]["states"][1] for n in ("repl", "shard", "shard_pre"))
    for f in ("xyz", "sh_dc", "sh_rest", "scaling", "rotation", "opacity"):
        want = repl["m"][f]
        assert np.abs(want).max() > 0 or f == "sh_rest", f  # SH degree 0: no gradient there
        np.testing.assert_array_equal(shard["m"][f], want, err_msg=f)
        normalised_close(pre["m"][f], want, 1e-6, f"replicate_preprocessed m {f}")
    np.testing.assert_allclose(mesh_ranks[0]["shard"]["losses"], mesh_ranks[0]["repl"]["losses"], rtol=1e-6)


def test_a_split_state_refuses_a_whole_row_step(mesh_ranks):
    """A state placed with its rows split over "model" raises ValueError
    in a step that keeps the rows whole, on every rank, instead of
    training each rank's block as if it were the scene."""
    for res in mesh_ranks:
        for run in MESH_RUNS:
            if run.get("shard"):
                assert res[run["name"]]["mismatch_raises"] is True, run["name"]


def test_replicate_preprocessed_collectives(mesh_ranks):
    """tests/test_parallel.py:test_replicate_preprocessed_collective_pattern
    on the port (docs/SHARDING.md): on a 2x2 mesh with the rows split and
    `replicate_preprocessed`, a step's collectives are one all-gather of
    the preprocessed rows (C, 17) per local view and one of the scales
    (C, 3) per step, then the one flat gradient SUM and the (C/2, 4) MAX of
    the statistics; nothing is sized by the instance budget. The step
    trains."""
    run = mesh_ranks[0]["shard_pre"]
    C, rows = 64, 32
    n_scalars = len(run["metrics"][0])  # the loss and the metric means
    per_step = ([("all_gather_into_tensor", (C, 17), "torch.float32", 2, "")] * (V // 2)
                + [("all_gather_into_tensor", (C, 3), "torch.float32", 2, ""),
                   ("all_reduce", (rows * 59 + n_scalars,), "torch.float32", 2, "SUM"),
                   ("all_reduce", (rows, 4), "torch.float32", 2, "MAX")])
    got = run["collectives"]
    assert sorted(got) == sorted(per_step * len(run["metrics"])), got[:8]
    budget = TCFG.raster.max_instances
    assert all(budget not in shape and 2 * budget not in shape for _, shape, *_ in got)
    assert np.isfinite(run["losses"]).all() and run["losses"][-1] < run["losses"][0]


def test_camera_partition_and_the_cross_rank_check(two_ranks, mesh_ranks):
    """`local_camera_indices` is the JAX package's partition of the
    cameras (its order from one process, dealt rank by rank);
    `assert_same_across_hosts` raises on a value that differs by rank."""
    order = jdist.local_camera_indices(10, seed=0)  # one JAX process: the whole order
    for ranks in (two_ranks, mesh_ranks):
        n = len(ranks)
        for r, res in enumerate(ranks):
            assert res["camera_indices"] == order[r::n]
            assert res["differing_ranks_raise"] is True


def test_schedule_leg_on_two_ranks(tmp_path):
    """`__graft_entry__.py:dryrun_schedule_leg` on two gloo ranks: 50 steps
    with densify at 10 and 30, an opacity reset at 25 and a budget regrow
    at 12, the placements against one process at the JAX tolerances, the
    alive masks bitwise equal after every event (its asserts run in the
    ranks)."""
    logs = _launch(dryrun.dryrun_worker, 2, (dryrun.file_init_method(str(tmp_path)), "gloo", "cpu", ("schedule",)),
                   tmp_path, "schedule leg")
    assert "dryrun_schedule_leg(2): 50 steps" in logs and "ok" in logs, logs
