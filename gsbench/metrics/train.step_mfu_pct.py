"""train.step_mfu_pct: one profiled step's share of the H100's peak: the
larger of its counted operations over 67 TFLOP/s (FP32; the port keeps
TF32 off) and its counted bytes over 3.35 TB/s, over that step's device
span. The counts (gsbench/yardstick.py) are what the step's inputs need:
the preprocess rows forward and backward, the blends' open pairs and box
tests from the reference's binning, the loss stack's convolutions, the
multi-view patches and Adam over the row budget."""


def read(ctx):
    bound, ms = ctx.yardstick.get("step_bound_ms"), ctx.yardstick.get("step_device_ms")
    if not bound or not ms:
        return None
    return 100.0 * bound / ms
