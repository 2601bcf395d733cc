"""lod.frame_mfu_pct: one profiled LOD frame's share of the H100's peak: its
counted work (the preprocess rows of the cut and the forward blend's open
pairs, box tests and bytes from the reference's binning of the
interpolated cut) at the peak rates, over the frame's device span. The
cut select's and interpolation's work is not counted."""


def read(ctx):
    bound, ms = ctx.yardstick.get("frame_bound_ms"), ctx.yardstick.get("frame_device_ms")
    if not bound or not ms:
        return None
    return 100.0 * bound / ms
