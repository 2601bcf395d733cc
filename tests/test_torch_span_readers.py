"""The benchmark's readers of the program's spans (gsbench/metrics/
train.iter_host_ms.py, postopt.iter_host_ms.py, lod.frame_host_ms.py,
lod.frame_wait_ms.py, lod.waits_per_frame.py) on hand-made records of utils/profiling.py: a
root span's own host time is its duration less its outermost wait spans
and graph launches (`graph.replay`); its wait time and count are its
outermost wait spans; a program without the tracer, or a run that kept no
root span, leaves the metric out."""
import types

import pytest

from gsbench import harness
from hidegs_tpu_torch.utils import profiling as prof

MS = 1_000_000


def _span(name, id, parent, start_ms, end_ms, wait=False, request=None):
    return prof.Span(name, id, parent, request, int(start_ms * MS), int(end_ms * MS), wait, {})


def _records(root):
    """Two roots `root`: the first 10 ms with a 2 ms wait, a 1 ms launch
    and a 3 ms wait inside another span that holds a wait of its own
    (counted once); the second 6 ms with a 1 ms wait and a 1.5 ms launch;
    and spans outside any root."""
    return [
        _span("stray.wait", 1, None, 0, 1, wait=True),
        _span("read", 3, 2, 10, 12, wait=True),
        _span("graph.replay", 4, 2, 12, 13),
        _span("select", 11, 2, 13, 17.5),
        _span("count", 5, 11, 14, 17, wait=True),
        _span("inner", 6, 5, 15, 16, wait=True),
        _span(root, 2, None, 10, 20, request=1),
        _span("read", 8, 7, 21, 22, wait=True),
        _span("graph.replay", 9, 7, 23, 24.5),
        _span(root, 7, None, 20, 26, request=2),
        _span("graph.replay", 12, None, 27, 29),  # outside any root
        _span("orphan.wait", 10, 13, 30, 31, wait=True),  # its root straddled the profiler: not kept
    ]


CASES = [
    ("train.iter_host_ms", "train.iteration", ((10 - 2 - 1 - 3) + (6 - 1 - 1.5)) / 2),
    ("postopt.iter_host_ms", "postopt.iteration", ((10 - 2 - 1 - 3) + (6 - 1 - 1.5)) / 2),
    ("lod.frame_host_ms", "lod.frame", ((10 - 2 - 1 - 3) + (6 - 1 - 1.5)) / 2),
    ("lod.frame_wait_ms", "lod.frame", ((2 + 3) + 1) / 2),
    ("lod.waits_per_frame", "lod.frame", (2 + 1) / 2),
]


@pytest.mark.parametrize("metric,root,want", CASES)
def test_readers_on_hand_made_spans(monkeypatch, metric, root, want):
    monkeypatch.setattr(prof, "records", lambda: _records(root))
    assert harness.load_reader(metric)(None) == pytest.approx(want)


@pytest.mark.parametrize("metric,root,want", CASES)
def test_readers_leave_the_metric_out_without_spans(monkeypatch, metric, root, want):
    other = "lod.frame" if root == "train.iteration" else "train.iteration"
    monkeypatch.setattr(prof, "records", lambda: _records(other))
    assert harness.load_reader(metric)(None) is None
    monkeypatch.delattr(prof, "records")  # a program without the tracer
    assert harness.load_reader(metric)(types.SimpleNamespace()) is None


def test_the_trainer_reads_its_median_iteration(monkeypatch):
    """One iteration whose step span holds 50 ms of other work (the
    benchmark's yardstick copy, waiting for the device) does not move the
    trainer's reading; the mean would read 19.5 ms."""
    recs = _records("train.iteration") + [
        _span("train.step", 21, 20, 40, 91),
        _span("graph.replay", 22, 21, 90, 91),
        _span("train.iteration", 20, None, 40, 92, request=3),
    ]
    monkeypatch.setattr(prof, "records", lambda: recs)
    assert harness.load_reader("train.iter_host_ms")(None) == pytest.approx(4.0)


def test_the_post_optimizer_reads_its_median_iteration(monkeypatch):
    """As the trainer's: the iteration that holds the yardstick's copy in
    its step span does not move the reading."""
    recs = _records("postopt.iteration") + [
        _span("postopt.step", 21, 20, 40, 91),
        _span("graph.replay", 22, 21, 90, 91),
        _span("postopt.iteration", 20, None, 40, 92, request=3),
    ]
    monkeypatch.setattr(prof, "records", lambda: recs)
    assert harness.load_reader("postopt.iter_host_ms")(None) == pytest.approx(4.0)
