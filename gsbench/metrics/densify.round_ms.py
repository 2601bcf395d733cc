"""densify.round_ms: device ms per densify round in the window (CUDA
events around the schedule call that runs the round)."""


def read(ctx):
    spans = ctx.spans.get("densify.round")
    return sum(spans) / len(spans) if spans else None
