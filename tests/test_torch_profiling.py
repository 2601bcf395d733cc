"""The port's tracer (utils/profiling.py): spans recorded only while a
profiler runs or after `enable()`, with their parents, requests, waits and
attributes, in a bounded deque and as ranges of the profiler's trace; and
the spans the trainer and the LOD renderer place at their layer
boundaries, on toy problems on the CPU."""
import json
import threading

import pytest
import torch

from hidegs_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh():
    prof.disable()
    prof.clear()
    yield
    prof.disable()
    prof.clear()


def _ranges(monkeypatch):
    """Count the record_function ranges a span enters."""
    entered = []
    real = torch.profiler.record_function

    def counted(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return entered


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    entered = _ranges(monkeypatch)
    with prof.span("a", wait=True, n=1) as s:
        s.set(n=2)
        with prof.span("b"):
            pass
    assert prof.records() == [] and entered == []
    assert prof.span("c") is prof.span("d")  # one shared no-op context


def test_enable_records_until_disable(monkeypatch):
    entered = _ranges(monkeypatch)
    prof.enable()
    with prof.span("a"):
        pass
    prof.disable()
    with prof.span("b"):
        pass
    assert [r.name for r in prof.records()] == ["a"] and entered == []  # no profiler: no range
    r = prof.records()[0]
    assert 0 < r.start_ns <= r.end_ns and r.parent is None and r.request is None and not r.wait


@pytest.mark.parametrize("enabled", [False, True])
def test_a_span_enters_a_range_only_under_a_profiler(monkeypatch, enabled):
    entered = _ranges(monkeypatch)
    if enabled:
        prof.enable()
    with prof.span("before"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with prof.span("inside"):
                pass
    with prof.span("after"):
        pass
    assert entered == ["inside"]
    assert [r.name for r in prof.records()] == (["inside", "before", "after"] if enabled else ["inside"])


def test_an_active_profiler_records():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with prof.span("inside"):
            pass
    with prof.span("after"):
        pass
    assert [r.name for r in prof.records()] == ["inside"]


@pytest.mark.parametrize("edge", ["start", "stop"])
def test_a_span_that_straddles_the_profiler_is_dropped(edge):
    p = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    if edge == "start":
        with prof.span("straddles"):
            p.__enter__()
            with prof.span("inside"):
                pass
        p.__exit__(None, None, None)
    else:
        p.__enter__()
        with prof.span("straddles"):
            with prof.span("inside"):
                pass
            p.__exit__(None, None, None)
    assert [r.name for r in prof.records()] == ["inside"]


def test_parents_requests_waits_and_attributes():
    prof.enable()
    with prof.span("frame", request=7, count_pass=0) as frame:
        with prof.span("read", wait=True):
            pass
        with prof.span("replay", what="the LOD frame"):
            with prof.span("inner", request=9):
                pass
        frame.set(count_pass=1)
    with prof.span("later"):
        pass
    frame.set(attempts=2)  # a count known after the block ended
    by = {r.name: r for r in prof.records()}
    assert [r.name for r in prof.records()] == ["read", "inner", "replay", "frame", "later"]
    assert by["read"].parent == by["replay"].parent == by["frame"].id
    assert by["inner"].parent == by["replay"].id and by["later"].parent is None
    assert (by["read"].request, by["replay"].request, by["inner"].request) == (7, 7, 9)
    assert by["later"].request is None
    assert by["read"].wait and not by["frame"].wait
    assert by["frame"].attrs == {"count_pass": 1, "attempts": 2}
    assert by["replay"].attrs == {"what": "the LOD frame"}
    assert by["frame"].start_ns <= by["read"].start_ns <= by["read"].end_ns <= by["replay"].start_ns
    assert by["replay"].end_ns <= by["frame"].end_ns <= by["later"].start_ns


def test_threads_keep_their_own_parents():
    prof.enable()
    seen = {}

    def worker():
        with prof.span("thread.root", request=2):
            pass
        seen["done"] = True

    with prof.span("main.root", request=1):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen["done"]
    by = {r.name: r for r in prof.records()}
    assert by["thread.root"].parent is None and by["thread.root"].request == 2


def test_records_stay_bounded():
    tracer = prof.Tracer(max_records=5)
    tracer.enabled = True
    for i in range(12):
        with tracer.span("s", request=i):
            pass
    kept = tracer.records()
    assert [r.request for r in kept] == list(range(7, 12))
    tracer.clear()
    assert tracer.records() == [] and prof.MAX_RECORDS == 1_000_000


def test_trace_records_an_annotated_range(tmp_path):
    """The spans (the annotated ranges) are ranges of `trace`'s file."""
    with prof.trace(str(tmp_path / "tr"), device="cpu") as p:
        with prof.span("hidegs_test_range", request=3):
            with prof.span("hidegs_test_wait", wait=True):
                x = torch.randn(64, 64)
                (x @ x).sum()
    events = json.loads((tmp_path / "tr" / prof.TRACE_FILE).read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("hidegs_test")}
    assert set(spans) == {"hidegs_test_range", "hidegs_test_wait"}
    outer, inner = spans["hidegs_test_range"], spans["hidegs_test_wait"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert any("mm" in (e.get("name") or "") for e in events)
    assert any(e.key == "hidegs_test_range" for e in p.key_averages())
    assert [r.name for r in prof.records()] == ["hidegs_test_wait", "hidegs_test_range"]


def test_profiling_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with prof.trace(str(tmp_path)):
            pass


def test_graph_replays_are_spans():
    import types

    from hidegs_tpu_torch.utils import graphs

    gs = graphs.GraphSet("a test graph")
    ran = []
    g = graphs.Graph(graph=types.SimpleNamespace(replay=lambda: ran.append(1)), outputs=None, launches={})
    gs.replay(g)
    prof.enable()
    with prof.span("caller", request=4):
        gs.replay(g)
    assert ran == [1, 1] and gs.replays == 2
    replay, caller = prof.records()
    assert (replay.name, replay.attrs, replay.parent, replay.request) == ("graph.replay", {"what": "a test graph"},
                                                                          caller.id, 4)


# -- the trainer's spans ------------------------------------------------------------------------------------


def _children(recs, parent):
    return [r.name for r in recs if r.parent == parent.id]


@pytest.fixture(scope="module")
def trained_spans(tmp_path_factory):
    """The spans of 17 eager iterations of the trainer on a toy COLMAP
    scene: densify rounds at 6 and 12, a log read at 10, the budget counters
    read at the start of 9 and 17."""
    from hidegs_tpu_torch import config as tconfig
    from hidegs_tpu_torch.data import synthetic as tsyn
    from hidegs_tpu_torch.raster.api import RasterConfig
    from hidegs_tpu_torch.train import trainer

    root = tmp_path_factory.mktemp("scene")
    scene = tsyn.make_toy_gaussians(120, seed=11, device="cpu")
    cams = [tsyn.ring_camera(i, n_cams=16, height=32, width=32, device="cpu") for i in range(4)]
    tsyn.write_synthetic_colmap_scene(str(root), scene, cams, RasterConfig(max_instances=1 << 13), point_stride=2)
    opt = tconfig.OptimizationConfig(iterations=17, densify_from_iter=6, densify_until_iter=12,
                                     densification_interval=6, freq_warmup_iterations=0,
                                     single_view_weight_from_iter=0, multi_view_weight_from_iter=1000,
                                     depth_from_iter=10_000)
    pipe = tconfig.PipelineConfig(raster_backend="jnp", max_instances=1 << 13, capacity=512)
    prof.clear()
    prof.enable()
    try:
        trainer.train(tconfig.ModelConfig(source_path=str(root)), pipe, opt, save_iterations=(), log_every=10,
                      device="cpu")
    finally:
        prof.disable()
    recs = prof.records()
    prof.clear()
    return recs


def test_the_trainer_records_each_iteration(trained_spans):
    recs = trained_spans
    iters = [r for r in recs if r.name == "train.iteration"]
    assert [r.request for r in iters] == list(range(1, 18))
    assert all(r.parent is None for r in iters)
    for r in iters:
        kids = _children(recs, r)
        want = ["train.batch", "train.step", "train.schedule"]
        if r.request in (9, 17):
            want = ["train.read_budgets"] + want
        if r.request in (6, 12):
            want = want + ["train.read_densify"]
        if r.request == 10:
            want = want + ["train.read_log"]
        assert kids == want, (r.request, kids)
        assert all(k.request == r.request for k in recs if k.parent == r.id)


def test_the_trainer_marks_its_waits_and_counts(trained_spans):
    recs = trained_spans
    by_id = {r.id: r for r in recs}
    waits = {r.name for r in recs if r.wait}
    assert waits == {"train.read_budgets", "train.read_densify", "train.read_log"}
    reads = [r for r in recs if r.name == "train.read_budgets"]
    assert [by_id[r.parent].request for r in reads] == [9, 17]
    assert all(r.attrs["refit"] in (0, 1) for r in reads)
    batches = [r for r in recs if r.name == "train.batch"]
    # four views: each copied to the device the first time it is picked
    assert sum(r.attrs["cache_miss"] for r in batches) == 4
    assert [r.attrs["cache_miss"] for r in batches[4:]] == [0] * 13
    rounds = [r for r in recs if r.name == "densify.round"]
    assert [by_id[by_id[r.parent].parent].request for r in rounds] == [6, 12]
    assert all(by_id[r.parent].name == "train.schedule" for r in rounds)


# -- the LOD renderer's spans -------------------------------------------------------------------------------


def test_the_lod_renderer_records_each_frame():
    from hidegs_tpu_torch.data.synthetic import make_toy_gaussians, ring_camera
    from hidegs_tpu_torch.hier.build import build_hierarchy
    from hidegs_tpu_torch.hier.interp import AdaptiveHierRenderer

    scene = make_toy_gaussians(60, seed=5, device="cpu")
    h = build_hierarchy(*(x.numpy() for x in (scene.means3d, scene.quats, scene.scales, scene.opacities,
                                                scene.shs)), use_native=False)
    r = AdaptiveHierRenderer.from_hierarchy(h, "cpu")
    assert r.compiled is None
    cams = [ring_camera(0, height=32, width=48, device="cpu"), ring_camera(3, height=32, width=48, device="cpu")]
    with torch.no_grad():
        r.render(cams[0], 2.0)  # not recorded
        prof.enable()
        for cam in (cams[0], cams[0], cams[1]):  # a count-cache hit, then a miss
            r.render(cam, 2.0)
        prof.disable()
    recs = prof.records()
    frames = [f for f in recs if f.name == "lod.frame"]
    assert [f.request for f in frames] == [1, 2, 3] and r.frames == 4
    assert [f.attrs["count_pass"] for f in frames] == [0, 0, 1]
    for f in frames:
        kids = _children(recs, f)
        want = ["lod.read_viewpoint"] + ["lod.count"] * f.attrs["count_pass"] \
            + ["lod.read_counters"] * f.attrs["attempts"]
        assert kids == want, (f.request, kids)
        assert all(k.wait and k.request == f.request for k in recs if k.parent == f.id)
    assert all(f.attrs["attempts"] >= 1 for f in frames)
