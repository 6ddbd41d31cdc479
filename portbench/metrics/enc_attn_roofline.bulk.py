"""Kernel 1's share of its roofline: the least time its calls need
(work.encoder_attention_work at each encode call's batch, bound by the
operations at the bf16 peak) over its device time in the trace."""


def read(ctx):
    if ctx.trace is None:
        return None
    n, secs = ctx.trace.kernel("attention_tc_kernel",
                               "encoder_attention_kernel")
    arch = ctx.arch
    calls = [(r.rows, arch.encoder_layers) for r in ctx.spans.of("encode")]
    if not n or secs <= 0 or n != sum(layers for _, layers in calls):
        return None
    bound = 0.0
    for rows, layers in calls:
        b, ops = ctx.work.encoder_attention_work(
            rows, arch.encoder_attention_heads, arch.max_source_positions,
            arch.d_model // arch.encoder_attention_heads)
        bound += layers * ctx.work.bound_s(b, ops, "bf16")[0]
    return 100.0 * bound / secs
