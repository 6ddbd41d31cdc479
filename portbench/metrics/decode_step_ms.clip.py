"""Milliseconds a step of the serving decode loop, whose steps are kernel
5 launches (host clock around greedy_decode after a sync, over its
steps)."""

from portbench import readers


def read(ctx):
    return readers.decode_step_ms(ctx)
