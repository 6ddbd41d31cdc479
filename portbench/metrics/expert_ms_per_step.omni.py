"""Device milliseconds of the grouped expert kernel a decode step: its
one-token steps' launches (both kernels on their step tiles,
moe_step_plan; two a layer) in the trace over the steps of the
program's cw.decode records."""

from portbench import moe_readers


def read(ctx):
    return moe_readers.expert_ms_per_step(ctx)
