"""postopt.step_device_ms: device ms per call into the post-opt step over
the window's steps (CUDA events around each call of the step that
`post_optimize` makes: the replayed `CompiledHierTrainStep`, inside the
program's `postopt.step` span)."""


def read(ctx):
    spans = ctx.spans.get("step")
    return sum(spans) / len(spans) if spans else None
