"""view.frame_device_ms: device ms per frame of the serving render
(raster/compiled.py through viewer/__main__.py:make_render_fn)."""


def read(ctx):
    spans = ctx.spans.get("frame")
    return sum(spans) / len(spans) if spans else None
