"""The grouped expert kernel's share of its roofline: the least time its
launches need (work_speech_moe.expert_work from the routed rows and the
experts that received rows, per layer of the prefill and of the one-token
steps, bound by the larger of bytes and operations) over its device time
in the trace (both launches of the prefill and of every step)."""

from portbench import moe_readers


def read(ctx):
    return moe_readers.expert_roofline(ctx)
