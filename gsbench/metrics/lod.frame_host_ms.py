"""lod.frame_host_ms: the LOD renderer's own host ms per frame: each
`lod.frame` span's duration (`AdaptiveHierRenderer.render`,
hier/interp.py) less its waits (the viewpoint's read, the count pass's
read, the counters' read of each attempt) and less the frame graph's
launch (`graph.replay`, utils/graphs.py, which the profiler inflates
several times over and its own range shows), averaged over the frames of
the profiled part of the window: the target, key, copy-in and counters'
stack, host work that the frame's device work waits for."""


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
    frames = per_root("lod.frame", left_out)
    return sum(d - w for d, w, _ in frames) / len(frames) / 1e6 if frames else None
