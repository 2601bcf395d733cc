"""postopt.iter_host_ms: the post-optimizer's own host ms in the median
iteration: each `postopt.iteration` span's duration
(train/hier_trainer.py:post_optimize) less its waits (the budget
counters' read every 8 iterations, the log's read) and less its graph
launches (`graph.replay`, utils/graphs.py), over the iterations that the
profiled part of the window holds whole. The median, as
train.iter_host_ms takes it: one profiled iteration, drawn from the seed,
also holds the benchmark's own copy of the step's parameters for its
yardstick. None where the program keeps no such spans."""
import statistics


def per_root(name, left_out):
    """(duration ns, ns in its outermost descendant spans that `left_out`
    holds for, how many of those) of each span `name` the program's tracer
    kept (hidegs_tpu_torch/utils/profiling.py); none where the program has
    no tracer."""
    from hidegs_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    recs = records() if records is not None else []
    by_id = {r.id: r for r in recs}
    roots = {r.id: [r.end_ns - r.start_ns, 0, 0] for r in recs if r.name == name}
    for r in recs:
        if not left_out(r):
            continue
        p = r.parent
        while p is not None and p not in roots and p in by_id and not left_out(by_id[p]):
            p = by_id[p].parent
        if p in roots:
            roots[p][1] += r.end_ns - r.start_ns
            roots[p][2] += 1
    return list(roots.values())


def left_out(r):
    return r.wait or r.name == "graph.replay"


def read(ctx):
    its = per_root("postopt.iteration", left_out)
    return statistics.median(d - w for d, w, _ in its) / 1e6 if its else None
