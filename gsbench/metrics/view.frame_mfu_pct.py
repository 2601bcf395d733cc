"""view.frame_mfu_pct: one profiled viewer frame's share of the H100's peak: its
counted work (the preprocess rows and the forward blend's open pairs, box
tests and bytes from the reference's binning) at the peak rates, over the
frame's device span."""


def read(ctx):
    bound, ms = ctx.yardstick.get("frame_bound_ms"), ctx.yardstick.get("frame_device_ms")
    if not bound or not ms:
        return None
    return 100.0 * bound / ms
