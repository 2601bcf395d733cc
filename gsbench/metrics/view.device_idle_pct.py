"""view.device_idle_pct: the viewer cell's 100 x (1 - the frames' device
spans' sum / the window), a span being the CUDA events around the frame's
render call."""


def read(ctx):
    spans = ctx.spans.get("frame")
    if not spans or not ctx.window_s > 0:
        return None
    return 100.0 * (1.0 - sum(spans) / (ctx.window_s * 1e3))
