"""A rank of tests/test_torch_compiled_dp.py's spawned gloo runs: the body
the compiled view-parallel step captures (`sharded.dp_step_in_place`, on
the state's own buffers) against the eager step, on the CPU. It imports
neither jax nor the JAX package (the ranks are spawned processes)."""
import os

import torch

from hidegs_tpu_torch.parallel import distributed as pdist
from hidegs_tpu_torch.parallel import dryrun, sharded
from hidegs_tpu_torch.parallel.mesh import make_mesh
from hidegs_tpu_torch.utils import graphs


def body_worker(rank: int, world: int, init_method: str, job_path: str, out_dir: str):
    """For each run of the job (`dryrun.save_dp_job`): `steps` eager steps
    and `steps` in-place bodies from the placed state; writes, per run,
    whether every tensor of the state and every metric were bitwise equal
    after each step, the losses, and a digest of the body's final state."""
    pdist.initialize_distributed(backend="gloo", device="cpu", init_method=init_method, world_size=world, rank=rank)
    results = {}
    try:
        ts0, views, job = dryrun.load_dp_job(job_path, "cpu")
        batch = sharded.stack_view_batches(views)
        for run in job["runs"]:
            mesh = make_mesh(world, data=run["data"], model=run["model"], device_type="cpu")
            kwargs = dict(mesh=mesh, use_exposure=job["use_exposure"],
                          grad_reduce_dtype=torch.bfloat16 if run.get("wire") == "bf16" else None,
                          replicate_preprocessed=run.get("replicate_preprocessed", False),
                          shard_gaussians=run.get("shard", False))
            step, place = sharded.make_dp_train_step(job["cfg"], **kwargs)
            plan = sharded.dp_plan(job["cfg"], **kwargs)
            eager, b = place(ts0, batch)
            state = graphs._map(torch.clone, eager)
            equal, losses = [], []
            for _ in range(run["steps"]):
                eager, em = step(eager, b)
                cm = sharded.dp_step_in_place(plan, state, b, None)
                same_state = all(torch.equal(x, y) for x, y in
                                 zip(graphs._tensors(state), graphs._tensors(eager), strict=True))
                equal.append(same_state and em.keys() == cm.keys() and all(torch.equal(em[k], cm[k]) for k in em))
                losses.append(float(cm["loss"]))
            results[run["name"]] = dict(equal=equal, losses=losses,
                                        digest=pdist.state_digest(graphs._tensors(state)))
    finally:
        pdist.shutdown_distributed()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
