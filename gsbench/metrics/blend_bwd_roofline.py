"""blend_bwd_roofline: the backward blend kernel (raster/csrc/blend_bwd.cu)
at one profiled step: the bound of the work its inputs need (the
reference's pair counts and binning, gsbench/yardstick.py:blend_bound)
over the kernel's time, from the trace when the profiler saw every launch
the program counted, else timed alone on the step's inputs."""


def read(ctx):
    bound, ms = ctx.yardstick.get("blend_bwd_bound_ms"), ctx.yardstick.get("blend_bwd_ms")
    if not bound or not ms:
        return None
    return 100.0 * bound / ms
