"""lod.frame_device_ms: device ms per LOD frame (CUDA events around
`AdaptiveHierRenderer.render`: the count pass when it runs, and the
replayed `CompiledLodFrame`: cut select, interpolation, render)."""


def read(ctx):
    spans = ctx.spans.get("frame")
    return sum(spans) / len(spans) if spans else None
