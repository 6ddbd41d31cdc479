"""Tracing, profiling and serving metrics.

``trace_span(name, **counts)`` is the port's one span API. The program
opens ``cw.*`` spans at its layer boundaries (``pipeline/asr.py``:
``cw.call``, ``cw.mel``, ``cw.generate``, ``cw.stitch``;
``decoding/longform.py``: ``cw.seek``, ``cw.encode``, ``cw.decode``,
``cw.align_tail``, ``cw.readback``, ``cw.segments``;
``decoding/greedy.py``: ``cw.decode.cache``, ``cw.decode.prefill``, in
each loop iteration ``cw.decode.step`` (``graph``: 1 where the step was
a replay of the decode's CUDA graph, 0 where it ran eagerly),
``cw.decode.select``, ``cw.decode.sync``, and once a graphed decode
``cw.decode.capture`` (the graph's capture and instantiation, between
the first two steps); ``models/speech_moe.py``: ``cw.encode.adapter``),
each with the counts of its boundary (rows, steps, recordings). A speech
LM's decode records its routing on the device while spans record
(``active()``, decided once a decode; no launch of its own in a step),
counts it once a decode and attaches the counts, read back with the
window batch's one copy, to its ``cw.decode`` record as
``routing_prefill`` and ``routing_steps`` (``models/speech_moe
.RoutingRecord.counts``).

A span is off unless a ``torch.profiler`` runs or a ``recording()``
scope is open. Off, it checks that and returns a shared no-op: no
``record_function``, no NVTX range, no record. On, it opens
``record_function(name)`` and, where the process has a CUDA card, an
NVTX range, and inside them stamps ``time.time_ns()`` at its start and
end. Kineto's events are on the same clock (the Unix epoch in ns), so a
record lies within its profiler range and can be matched against the
device trace's kernels and host launches. Each record holds the name,
the two stamps, the index of the enclosing span's record (a per-thread
stack), the call id (one per outermost span on a thread, so every span
of one pipeline call shares the id of its ``cw.call``) and the counts.
Records go to one bounded in-memory buffer: ``records()`` returns it,
``recording()`` clears it, turns recording on and yields it, and once
``CAPACITY`` records are held further ones are dropped and counted
(``dropped()``). The benchmark's readers of the launches inside
``cw.decode.step`` and ``cw.decode.select`` read the buffer after its
profiled window.

Not yet read by the benchmark: the records' host times (its first, host
clock window runs no profiler and opens no ``recording()``), the naming
of idle device gaps by the innermost ``cw.*`` span, and a queue-wait span
in ``serving/``'s batcher, which waits for a cell that runs it.

``start_profiler`` / ``stop_profiler`` run one ``torch.profiler.profile``
over the CPU and CUDA activities and write its Chrome trace.
``StageStats`` and ``RTFMeter`` are copies of the reference's classes,
statement for statement (tests/test_torch_pipeline.py pins them):
per-call real-time-factor statistics behind ``ASRPipeline.meter``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch

CAPACITY = 1 << 18          # records held before further ones are dropped

_profiler_enabled = torch.autograd._profiler_enabled
_recording = False          # a recording() scope is open
_records: list = []
_dropped = 0
_lock = threading.Lock()
_local = threading.local()  # .stack: [(record index or None, call id)]
_calls = itertools.count()


@functools.cache
def _nvtx() -> bool:
    """Whether the process has a CUDA card, for the NVTX ranges."""
    return torch.cuda.is_available()


class Record:
    """One span: ``parent`` is the index of the enclosing span's record
    in the buffer (None at a thread's outermost span, or where it was
    dropped); ``start_ns`` / ``end_ns`` are ``time.time_ns()``."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "counts")

    def __init__(self, name: str, start_ns: int, end_ns: int,
                 parent: int | None, call: int, counts: dict):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.parent = parent
        self.call = call
        self.counts = counts

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"parent={self.parent}, call={self.call}, {self.counts})")


class _Off:
    """The span of a process that is not tracing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def count(self, **counts) -> None:
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "_rf", "_record")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts

    def count(self, **counts) -> None:
        """Add counts known only inside the span (or after it)."""
        self.counts.update(counts)

    def __enter__(self) -> "_Span":
        global _dropped
        nvtx = _nvtx()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent, call = stack[-1] if stack else (None, next(_calls))
        with _lock:
            if len(_records) < CAPACITY:
                index = len(_records)
                self._record = Record(self.name, 0, 0, parent, call,
                                      self.counts)
                _records.append(self._record)
            else:
                index, self._record = None, None
                _dropped += 1
        stack.append((index, call))
        # the stamps lie inside the profiler and NVTX ranges
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if nvtx:
            torch.cuda.nvtx.range_push(self.name)
        if self._record is not None:
            self._record.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._record is not None:
            self._record.end_ns = time.time_ns()
        if _nvtx():
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        _local.stack.pop()
        return None


def active() -> bool:
    """Whether spans record now (a profiler runs or a ``recording()``
    scope is open)."""
    return _recording or _profiler_enabled()


def trace_span(name: str, **counts):
    """A span named ``name`` with ``counts`` (``with trace_span(...) as
    s``; ``s.count(steps=n)`` adds counts later). Off, a shared no-op."""
    if not active():
        return _OFF
    return _Span(name, counts)


def records() -> list:
    """The buffer of ``Record`` objects, in order of their spans' starts."""
    return _records


def dropped() -> int:
    """Records dropped since the buffer was last cleared, it being full."""
    return _dropped


@contextlib.contextmanager
def recording() -> Iterator[list]:
    """Clear the buffer and record every span inside the scope, profiler
    or not; yields the buffer."""
    global _recording, _dropped
    with _lock:
        _records.clear()
        _dropped = 0
    before, _recording = _recording, True
    try:
        yield _records
    finally:
        _recording = before


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
