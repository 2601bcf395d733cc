"""postopt.select_device_ms: device ms per call into the post-opt cut
select over the window's steps (CUDA events around each call of
`CompiledHierTrainStep.select`, the replayed `expand_packed` of
hier/lod.py over the whole hierarchy, inside the program's
`postopt.select` span)."""


def read(ctx):
    spans = ctx.spans.get("select")
    return sum(spans) / len(spans) if spans else None
