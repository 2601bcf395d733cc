"""The port's tracer: spans at the layer boundaries of the trainer, the LOD
frame loop and the compiled replays, on the profiler's clock; and `trace`,
a torch.profiler session written as a Chrome trace.

Port of hidegs_tpu/utils/profiling.py, whose NVTX ranges name the host's
work for an outside profiler (SURVEY §5.1). Here:

  * `span(name, wait=False, request=None, **attrs)` names a stretch of the
    host's work, or with `wait=True` a stretch in which the host blocks on
    the device (a `.cpu()`, `.tolist()`, `int()` or `.item()` of a device
    tensor). While recording, it keeps a `Span` record (its id, the id of
    the enclosing span, the request it serves, host start and end from
    `time.perf_counter_ns()`, and a few attributes: the counts made at that
    boundary). While a profiler is active at its entry it also enters
    `torch.profiler.record_function(name)`, so that the span is a range of
    the profiler's trace on the kernels' timeline (and, under torch's
    `emit_nvtx`, an NVTX range); after `enable()` alone it keeps the record
    for the cost of two clock reads.
  * Recording is on while a torch.profiler session is active, or between
    `enable()` and `disable()`. A span is kept only if recording was on at
    its entry and at its exit: one that straddles the profiler's start or
    stop is dropped.
  * Off, `span` costs one check and returns a shared no-op context: no
    record, no range.
  * `records()` and `clear()` read and reset the kept spans, a bounded
    deque in memory. The profiler's trace (`trace`, or any torch.profiler
    session) is the export.

A span records no CUDA event and makes no host sync in either state: the
device's time comes from the profiler's trace, through the ranges. Spans
sit only at host-level boundaries, never inside a body captured as a CUDA
graph (which runs at its warm-up and capture only).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from hidegs_tpu_torch.device import DeviceLike, resolve_device

TRACE_FILE = "trace.json"
# the most spans kept; the oldest go first
MAX_RECORDS = 1_000_000

_profiler_enabled = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """One kept span."""

    name: str
    id: int
    parent: Optional[int]  # the enclosing span's id; None at a root
    request: Optional[int]  # the trainer's iteration, the LOD renderer's frame number
    start_ns: int  # time.perf_counter_ns() at entry
    end_ns: int  # and at exit
    wait: bool  # the host blocked on the device
    attrs: Dict[str, Any]  # the counts made at this boundary


class _Off:
    """The shared context of a span while recording is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Open:
    """A span while recording: pushed on its thread's stack at entry, kept
    at exit if recording is still on."""

    __slots__ = ("_tracer", "name", "wait", "request", "attrs", "id", "parent", "_start", "_range")

    def __init__(self, tracer: "Tracer", name: str, wait: bool, request: Optional[int], attrs: Dict[str, Any]):
        self._tracer, self.name, self.wait, self.request, self.attrs = tracer, name, wait, request, attrs

    def set(self, **attrs):
        """Add counts to the span's attributes; also after the block has
        ended, for a count known only later (the record holds this dict)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = self._tracer._stack()
        top = stack[-1] if stack else None
        self.id = next(self._tracer._ids)
        self.parent = None if top is None else top.id
        if self.request is None and top is not None:
            self.request = top.request
        stack.append(self)
        self._start = time.perf_counter_ns()
        self._range = torch.profiler.record_function(self.name) if _profiler_enabled() else None
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        end = time.perf_counter_ns()
        tracer = self._tracer
        tracer._stack().pop()
        if tracer.recording():
            tracer._records.append(Span(self.name, self.id, self.parent, self.request, self._start, end, self.wait,
                                        self.attrs))
        return False


class Tracer:
    """Spans kept in memory while recording; `span` is the module's entry
    point to the default one."""

    def __init__(self, max_records: int = MAX_RECORDS):
        self.enabled = False
        self._records: "collections.deque[Span]" = collections.deque(maxlen=max_records)
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[_Open]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def recording(self) -> bool:
        return self.enabled or _profiler_enabled()

    def span(self, name: str, wait: bool = False, request: Optional[int] = None, **attrs):
        """A context that records the enclosed block as a span `name` while
        recording; its `set(**attrs)` adds counts. `request` defaults to the
        enclosing span's."""
        if not (self.enabled or _profiler_enabled()):
            return _OFF
        return _Open(self, name, wait, request, attrs)

    def records(self) -> List[Span]:
        return list(self._records)

    def clear(self) -> None:
        self._records.clear()


TRACER = Tracer()
span = TRACER.span
records = TRACER.records
clear = TRACER.clear


def enable() -> None:
    """Record spans with no profiler active, until `disable()`."""
    TRACER.enabled = True


def disable() -> None:
    TRACER.enabled = False


@contextlib.contextmanager
def trace(dir_path: str, device: DeviceLike = "cuda"):
    """Record a torch.profiler trace of the enclosed block into
    `dir_path/trace.json`. On a CUDA device the trace holds the device's
    kernels beside the host's operators and the spans' ranges; on the CPU
    the host's alone. The profiler is yielded, for `key_averages()` and the
    like."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dir_path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(dir_path, TRACE_FILE))
