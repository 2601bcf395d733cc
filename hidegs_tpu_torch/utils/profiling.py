"""Tracing and profiling utilities.

Port of hidegs_tpu/utils/profiling.py. The reference has NVTX ranges and
timestamped prints (SURVEY §5.1); here `trace` records a torch.profiler
trace (Chrome trace format, viewable in Perfetto or chrome://tracing),
`annotate` names a range in it (and, on a CUDA device, an NVTX range for
external tools), and `ThroughputMeter` counts steps and pixels per second
(Mpix/s, the BASELINE north-star metric).
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict

import torch

from hidegs_tpu_torch.device import DeviceLike, resolve_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(dir_path: str, device: DeviceLike = "cuda"):
    """Record a torch.profiler trace of the enclosed block into
    `dir_path/trace.json`. On a CUDA device the trace holds the device's
    kernels beside the host's operators; on the CPU the host's alone. The
    profiler is yielded, for `key_averages()` and the like."""
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


@contextlib.contextmanager
def annotate(name: str, device: DeviceLike = "cuda"):
    """A named range in the profiler's timeline (the NVTX-range
    counterpart); on a CUDA device also an NVTX range."""
    dev = resolve_device(device)
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if dev.type == "cuda":
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@dataclass
class ThroughputMeter:
    """Running pixels/s + steps/s counter for training/rendering loops."""

    pixels_per_step: int
    _t0: float = field(default_factory=time.perf_counter)
    _steps: int = 0

    def step(self, n: int = 1):
        self._steps += n

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_s(self) -> float:
        return self._steps / max(self.seconds, 1e-9)

    @property
    def mpix_per_s(self) -> float:
        return self._steps * self.pixels_per_step / max(self.seconds, 1e-9) / 1e6

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def summary(self) -> Dict[str, float]:
        return {
            "steps_per_s": self.steps_per_s,
            "mpix_per_s": self.mpix_per_s,
            "seconds": self.seconds,
            "steps": float(self._steps),
        }


def timestamped_print(*args, **kwargs):
    """safe_state-style timestamped stdout (utils/general_utils.py:116-132)."""
    print(f"[{time.strftime('%d/%m %H:%M:%S')}]", *args, **kwargs)
