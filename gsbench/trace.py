"""Spans and the device trace of a traced run, from the benchmark's own
files: CUDA events around the calls into a layer, `record_function`
ranges naming what the host does, and torch.profiler over a part of the
window.

From the profiler's trace: `busy_s`, the union of the device operations'
intervals; `window_s`, the profiled part's wall time; the ten device
operations that took most time; the ten longest idle gaps of the device,
each named by the host range it fell in; and each kernel's launches in
order, with their durations."""
from __future__ import annotations

import contextlib
import gzip
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_PREFIX = "gsbench."


def short_name(name: str, width: int = 96) -> str:
    """A device op's name without its argument list, at most `width`
    characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].strip()[:width] or name[:width]


class EventSpans:
    """CUDA event pairs around calls; read once the window has closed."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._open: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        with torch.profiler.record_function(HOST_PREFIX + name):
            yield
        b.record()
        self._open[name].append((a, b))

    def read(self) -> Dict[str, List[float]]:
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self._open.items()}


def host_range(name: str):
    """A named host range in the profiler's trace (no device work)."""
    return torch.profiler.record_function(HOST_PREFIX + name)


def program_launches() -> Dict[str, int]:
    """The program's own count of each kernel's launches: its launchers'
    counters plus what graph replays launched (utils/graphs.py)."""
    from hidegs_tpu_torch.raster import cuda_blend, preprocess_autograd
    from hidegs_tpu_torch.utils import graphs

    direct = dict(zip(graphs.KERNELS, (cuda_blend.LAUNCHES, cuda_blend.BWD_LAUNCHES, cuda_blend.FOLD_LAUNCHES,
                                       preprocess_autograd.FWD_LAUNCHES, preprocess_autograd.BWD_LAUNCHES)))
    return {k: direct[k] + graphs.REPLAY_LAUNCHES[k] for k in graphs.KERNELS}


class Profile:
    """torch.profiler over a part of the window: start() and stop() from
    the driver, then `summary()`."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.events = None
        self.launched: Dict[str, int] = {}  # the program's own launch counts over the profiled part

    def start(self):
        self._counts0 = program_launches()
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        counts = program_launches()
        self.launched = {k: counts[k] - self._counts0[k] for k in counts}
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                self.events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def device_ops(self) -> List[dict]:
        return sorted((e for e in self.events or () if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                      key=lambda e: e["ts"])

    def launches(self, substring: str) -> List[float]:
        """Durations (ms) of the device kernels whose name holds
        `substring`, in launch order."""
        return [e["dur"] / 1e3 for e in self.device_ops() if e.get("cat") == "kernel" and substring in e["name"]]

    def summary(self) -> Optional[dict]:
        ops = self.device_ops()
        if not ops:
            return None
        # union of the device intervals, and the gaps between them
        spans = []
        for e in ops:
            a, b = e["ts"], e["ts"] + e["dur"]
            if spans and a <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], b)
            else:
                spans.append([a, b])
        busy_us = sum(b - a for a, b in spans)
        by_name = defaultdict(float)
        for e in ops:
            by_name[short_name(e["name"])] += e["dur"] / 1e6
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len(HOST_PREFIX):]) for e in self.events
                       if e.get("ph") == "X" and str(e.get("name", "")).startswith(HOST_PREFIX)),
                      key=lambda h: h[0])
        gaps = []
        for (a0, a1), (b0, _) in zip(spans, spans[1:]):
            mid = 0.5 * (a1 + b0)
            inside = [h for h in host if h[0] <= mid <= h[1]]
            # the innermost host range covering the gap names it
            label = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "host outside the harness's ranges"
            gaps.append((label, (b0 - a1) / 1e6))
        gaps.sort(key=lambda g: -g[1])
        return {"busy_s": busy_us / 1e6, "window_s": self.t1 - self.t0,
                "breakdown": {"device_ops": [[n, s] for n, s in top_ops],
                              "idle_gaps": [[n, s] for n, s in gaps[:10]]}}
