"""Milliseconds a step of the plain decode loop (host clock around
decoding.longform.greedy_decode after a sync, over its steps)."""

from portbench import readers


def read(ctx):
    return readers.decode_step_ms(ctx)
