"""train.iter_host_ms: the trainer's own host ms in the median iteration:
each `train.iteration` span's duration (train/trainer.py:train) less its
waits (the budget counters' read every 8 iterations, the densify round's
and the log's reads) and less its graph launches (`graph.replay`,
utils/graphs.py), over the iterations that the profiled part of the
window holds whole. A launch blocks while the device's queue is full, so
the host, a step ahead, spends most of an iteration inside it; that time
follows the device and is left out with the waits. The median, not the
mean: one profiled iteration, drawn from the seed, also holds the
benchmark's own copy of the step's rows for its yardstick, which waits
for the device inside the step's span."""
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
    its = per_root("train.iteration", left_out)
    return statistics.median(d - w for d, w, _ in its) / 1e6 if its else None
