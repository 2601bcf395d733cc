"""lod.waits_per_frame: the renderer's waits on the device per LOD frame,
counted as the outermost wait spans inside each `lod.frame` span
(`AdaptiveHierRenderer.render`, hier/interp.py): 2 a frame (the viewpoint
and the counters), 1 more for a count pass and 1 more for each retry;
averaged over the frames of the profiled part of the window."""


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
    return r.wait


def read(ctx):
    frames = per_root("lod.frame", left_out)
    return sum(n for _, _, n in frames) / len(frames) if frames else None
