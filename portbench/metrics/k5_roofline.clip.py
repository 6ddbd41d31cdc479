"""Kernel 5's share of its roofline: the least time its launches need
(work.step_work at each step's live ring, batch 1, int8 weights and
ring, int4 cross cache; bound by the bytes) over its device time in the
trace."""


def read(ctx):
    if ctx.trace is None:
        return None
    n, secs = ctx.trace.kernel("decode_step_kernel")
    p = ctx.prompt_len
    steps = [t for w in ctx.windows for t in range(p - 1, p - 1 + w.max_new)]
    if not n or secs <= 0 or n != len(steps):
        return None
    bound = 0.0
    for t in steps:
        b, ops = ctx.work.step_work(ctx.arch, 1, t + 1, ctx.n_align)
        bound += ctx.work.bound_s(b, ops, "f32")[0]
    return 100.0 * bound / secs
