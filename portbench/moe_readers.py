"""Readers of a speech-LM cell's grouped expert kernel (the port's
``csrc/moe.cu``): its device time in the trace, and the least time
its launches need from the routing counts the program attaches to its
``cw.decode`` records (``routing_prefill``, ``routing_steps``; the
architecture's ``work.routing_bound_s``).

Each reader returns None where the run gave it nothing to read: no trace,
no such records (a program that does not count its routing), no such
kernel, or a launch count other than two a layer for the prefill and for
each step of the records read.
"""

from __future__ import annotations

from portbench import program_spans

KERNELS = ("moe_gate_up_kernel", "moe_down_kernel")
# the decode steps' launches: both kernels on their step tiles, whose
# plan the kernel's name carries (the prefill's carry moe_block_plan)
STEP_KERNELS = ("moe_step_plan",)


def decode_records(ctx) -> list:
    """The program's ``cw.decode`` records of the profiled window that
    carry routing counts."""
    if ctx.trace is None:
        return []
    return [r for r in program_spans._records("cw.decode", ctx.trace.spans)
            if "routing_steps" in r.counts]


def expert_roofline(ctx) -> float | None:
    """Percent: the least time of every expert launch over their device
    time."""
    recs = decode_records(ctx)
    if not recs:
        return None
    n, secs = ctx.trace.kernel(*KERNELS)
    layers = ctx.arch.num_hidden_layers
    if secs <= 0 or n != sum(2 * layers * (1 + r.counts["steps"])
                             for r in recs):
        return None
    bound = sum(ctx.work.routing_bound_s(ctx.arch, r.counts[key])
                for r in recs for key in ("routing_prefill", "routing_steps"))
    return 100.0 * bound / secs


def expert_ms_per_step(ctx) -> float | None:
    """Device milliseconds of the one-token steps' expert launches over
    those steps."""
    recs = decode_records(ctx)
    steps = sum(r.counts["steps"] for r in recs)
    if not steps:
        return None
    n, secs = ctx.trace.kernel(*STEP_KERNELS)
    if secs <= 0 or n != 2 * ctx.arch.num_hidden_layers * steps:
        return None
    return 1e3 * secs / steps
