"""The device trace of a traced run, reduced to what the readers need.

``torch.profiler`` records the CPU and CUDA activities over the measured
window. Its raw kineto events are read once (no per-event Python objects
of the profiler's own) into: device time by kernel name, the union of
device busy intervals, the host's ``pb.*`` span ranges, the kernel
launches the host issued, and the idle gaps between device work, each
named by the innermost benchmark span open on the host when it began.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch

LAUNCH_WORDS = ("LaunchKernel", "LaunchCooperativeKernel", "GraphLaunch")


@dataclass
class Summary:
    kernels: dict = field(default_factory=dict)     # name -> [count, s]
    busy_s: float = 0.0
    spans: list = field(default_factory=list)       # (name, start, end) ns
    launches: list = field(default_factory=list)    # host ns, sorted
    idle_by_span: dict = field(default_factory=dict)

    def kernel(self, *words: str) -> tuple[int, float]:
        """(launches, device seconds) of kernels whose name holds any of
        ``words``."""
        n, s = 0, 0.0
        for name, (c, sec) in self.kernels.items():
            if any(w in name for w in words):
                n, s = n + c, s + sec
        return n, s

    def launches_in(self, span: str) -> int:
        """Host kernel launches inside the ranges of the ``pb.<span>``
        spans."""
        total = 0
        for name, a, b in self.spans:
            if name == "pb." + span:
                total += (bisect.bisect_right(self.launches, b)
                          - bisect.bisect_left(self.launches, a))
        return total

    def top_ops(self, k: int = 10) -> list:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name[:160], sec] for name, (_, sec) in rows]

    def top_gaps(self, k: int = 10) -> list:
        rows = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:k]
        return [[name, sec] for name, sec in rows]


class Profile:
    """Start before the window, stop after its final sync."""

    def __init__(self, device: str):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> Summary:
        self.prof.stop()
        return summarize(self.prof.profiler.kineto_results.events())


def _is_device(ev) -> bool:
    return ev.device_type() != torch.autograd.DeviceType.CPU


def summarize(events) -> Summary:
    out = Summary()
    kernels: dict = defaultdict(lambda: [0, 0.0])
    device: list = []
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if _is_device(ev):
            if name.startswith("pb.") or ev.is_user_annotation():
                continue                     # the spans' device mirrors
            k = kernels[name]
            k[0] += 1
            k[1] += (end - start) / 1e9
            device.append((start, end))
        elif name.startswith("pb."):
            out.spans.append((name, start, end))
        elif any(w in name for w in LAUNCH_WORDS):
            out.launches.append(start)
    out.kernels = dict(kernels)
    out.launches.sort()
    device.sort()
    merged: list = []
    for a, b in device:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    out.busy_s = sum(b - a for a, b in merged) / 1e9
    out.idle_by_span = _idle_by_span(merged, out.spans)
    return out


def _idle_by_span(merged: list, spans: list) -> dict:
    """Idle seconds between consecutive busy intervals, summed by the
    innermost ``pb.*`` span open on the host where each gap begins (the
    spans come from one thread, so they nest): one sweep over both."""
    marks = sorted([(a, 1, name) for name, a, _ in spans]
                   + [(b, 0, name) for name, _, b in spans])
    idle: dict = defaultdict(float)
    stack: list = []
    i = 0
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        while i < len(marks) and marks[i][0] <= end:
            _, opening, name = marks[i]
            if opening:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            i += 1
        idle[stack[-1] if stack else "outside spans"] += (nxt - end) / 1e9
    return dict(idle)
