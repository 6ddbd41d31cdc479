"""Kernel launches inside the program's own spans.

The port records its ``cw.*`` spans (``crisperwhisper_tpu_torch.utils
.tracing``) while a profiler runs, stamped with ``time.time_ns()``, the
clock of the profiler's events. After the profiled window the readers
count the host launch times of the trace (``trace.Summary.launches``,
sorted) that fall inside each record of one name. Records outside the
window's ``pb.*`` spans (an earlier profiler in the same process) are
left out. A program without such records, or a trace without launches,
gives nothing to read.
"""

from __future__ import annotations

import bisect


def _records(name: str, spans: list) -> list:
    try:
        from crisperwhisper_tpu_torch.utils import tracing
    except ImportError:
        return []
    read = getattr(tracing, "records", None)
    if read is None or not spans:
        return []
    lo = min(a for _, a, _ in spans)
    hi = max(b for _, _, b in spans)
    return [r for r in read() if r.name == name and lo <= r.start_ns
            and r.end_ns <= hi]


def launches_per_span(ctx, name: str) -> float | None:
    """Host kernel launches inside the program's records named ``name``,
    over the number of those records; None without records or launches."""
    if ctx.trace is None or not ctx.trace.launches:
        return None
    recs = _records(name, ctx.trace.spans)
    if not recs:
        return None
    launches = ctx.trace.launches
    n = sum(bisect.bisect_right(launches, r.end_ns)
            - bisect.bisect_left(launches, r.start_ns) for r in recs)
    return n / len(recs)
