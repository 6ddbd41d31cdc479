"""Kernel launches the host issued inside greedy_decode's spans (the
profiler's CUDA runtime launch calls) over the decode steps."""


def read(ctx):
    steps = sum(r.steps for r in ctx.spans.of("decode"))
    if ctx.trace is None or not steps:
        return None
    n = ctx.trace.launches_in("decode")
    return n / steps if n else None
