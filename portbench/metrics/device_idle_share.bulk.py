"""Percent of the traced window in which no operation ran on the card
(the union of the profiler's device intervals)."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
