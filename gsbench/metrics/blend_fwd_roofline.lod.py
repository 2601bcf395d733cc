"""blend_fwd_roofline.lod: the forward blend kernel (raster/csrc/blend_fwd.cu)
on one profiled LOD frame, the render of the interpolated cut: the bound of
the work its inputs need over the kernel's time, as blend_bwd_roofline."""


def read(ctx):
    bound, ms = ctx.yardstick.get("blend_fwd_bound_ms"), ctx.yardstick.get("blend_fwd_ms")
    if not bound or not ms:
        return None
    return 100.0 * bound / ms
