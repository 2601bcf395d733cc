"""train.step_device_ms: device ms per call into the train step over the
window's steps (CUDA events around each call)."""


def read(ctx):
    spans = ctx.spans.get("train.step")
    return sum(spans) / len(spans) if spans else None
