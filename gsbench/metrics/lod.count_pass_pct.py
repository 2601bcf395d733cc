"""lod.count_pass_pct: the share of the window's frames that ran the cut's
count pass (`hier/lod.py:cut_size_packed`, counted by a wrapper around the
renderer's call); the rest reused the frame-coherent count."""


def read(ctx):
    v = ctx.counters.get("count_pass_pct")
    return None if v is None else float(v)
