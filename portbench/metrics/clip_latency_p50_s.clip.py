"""The median seconds from a clip's call to its result, over the same
clips as clip_latency_p90_s."""

import statistics


def read(ctx):
    return statistics.median(ctx.latencies) if ctx.latencies else None
