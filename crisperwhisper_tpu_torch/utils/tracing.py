"""Tracing, profiling and serving metrics.

Port of crisperwhisper_tpu/utils/tracing.py on PyTorch's profiler:
``trace_span`` names a host span in the ``torch.profiler`` timeline
(``record_function``) and, in a process with a CUDA card, an NVTX range
on the card's timeline too; ``start_profiler`` / ``stop_profiler`` run one
``torch.profiler.profile`` over the CPU and CUDA activities and write its
Chrome trace. ``StageStats``, ``RTFMeter`` and ``GLOBAL_METER`` are copies
of the originals, statement for statement (tests/test_torch_pipeline.py
pins them): per-call real-time-factor statistics for serving dashboards.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """Host-side span that lands in the torch profiler's timeline, and in
    an NVTX range where the process has a CUDA card."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


# the running profiler of start_profiler and its trace directory
_SESSION: dict = {}


def start_profiler(logdir: str) -> None:
    """Start profiling the CPU and, where there is a card, CUDA activities
    of the process; ``stop_profiler`` writes the trace into ``logdir``."""
    if _SESSION:
        raise RuntimeError("a profiler is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _SESSION.update(prof=prof, logdir=logdir)


def stop_profiler() -> None:
    """Stop the profiler of ``start_profiler`` and write its Chrome trace
    (``trace_<pid>_<ns>.json``, for chrome://tracing or Perfetto) into its
    ``logdir``."""
    prof, logdir = _SESSION.pop("prof"), _SESSION.pop("logdir")
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.calls += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.calls if self.calls else 0.0


@dataclass
class RTFMeter:
    """Aggregates realtime-factor metrics across pipeline calls.

    RTFx = audio seconds processed / wall seconds spent; >1 is faster
    than realtime. Each stage also keeps its calls, mean and max."""

    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    stages: dict[str, StageStats] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    @contextlib.contextmanager
    def measure(self, audio_seconds: float,
                stage: str = "pipeline") -> Iterator[None]:
        t0 = time.perf_counter()
        with trace_span(stage):
            yield
        dt = time.perf_counter() - t0
        with self._lock:
            self.audio_seconds += audio_seconds
            self.wall_seconds += dt
            self.stages.setdefault(stage, StageStats()).add(dt)

    @property
    def rtfx(self) -> float:
        return (self.audio_seconds / self.wall_seconds
                if self.wall_seconds else 0.0)

    def summary(self) -> dict:
        return {
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 3),
            "rtfx": round(self.rtfx, 2),
            "stages": {k: {"calls": v.calls,
                           "mean_ms": round(v.mean_s * 1000, 2),
                           "max_ms": round(v.max_s * 1000, 2)}
                       for k, v in self.stages.items()},
        }


GLOBAL_METER = RTFMeter()
