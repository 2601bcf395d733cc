"""train.device_idle_pct: the share of the window in which no call into the
train step (`CompiledTrainStep`) or the densify round (`CompiledDensify`)
had work on the device: 100 x (1 - their CUDA-event spans' sum / the
window). The calls run one after another on one stream, so the spans do
not overlap."""


def read(ctx):
    spans = ctx.spans.get("train.step", []) + ctx.spans.get("densify.round", [])
    if not spans or not ctx.window_s > 0:
        return None
    return 100.0 * (1.0 - sum(spans) / (ctx.window_s * 1e3))
