"""interp_bwd_roofline.postopt: the backward of the interpolation's two
gathers (hier/interp.py:interpolate_cut, `attrs[ri]` and `attrs[pi]`:
PyTorch's sorted accumulation, its `indexing_backward_kernel`) at one
profiled post-opt step: the least bytes the two accumulations must move
(the gradient row, sorted index and position of each slot the preprocess
keeps, and of each kept slot that interpolates for the parents; each row
they index written once; padding and culled slots carry no gradient;
gsbench/yardstick_postopt.py:backward) over 3.35 TB/s, over the kernels'
traced time in that step."""


def read(ctx):
    bound, ms = ctx.yardstick.get("interp_bwd_bound_ms"), ctx.yardstick.get("interp_bwd_ms")
    if not bound or not ms:
        return None
    return 100.0 * bound / ms
