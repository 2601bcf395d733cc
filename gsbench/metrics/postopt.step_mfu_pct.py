"""postopt.step_mfu_pct: one profiled post-opt step's share of the H100's
peak: the larger of its counted operations over 67 TFLOP/s (FP32; the port
keeps TF32 off) and its counted bytes over 3.35 TB/s, over that step's
device span. The counts (gsbench/yardstick_postopt.py) are the least the
step's inputs need: the packed attribute matrix, the interpolation's
gathers over the cut's valid slots (parents only where they interpolate)
and their backward over the slots the preprocess keeps, the preprocess of
the valid slots forward and of the kept ones backward, the blends' open
pairs and box tests from the reference's binning of the interpolated cut,
the loss and Adam over the hierarchy's rows."""


def read(ctx):
    bound, ms = ctx.yardstick.get("step_bound_ms"), ctx.yardstick.get("step_device_ms")
    if not bound or not ms:
        return None
    return 100.0 * bound / ms
