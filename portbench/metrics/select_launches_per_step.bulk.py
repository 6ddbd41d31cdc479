"""Kernel launches the host issued inside the program's cw.decode.select
spans (token selection: alignment row, no-speech, logits processors,
argmax, log-prob, timestamp state, finished flags, token write), over
those spans: one a decode-loop step, in the profiled window."""

from portbench import program_spans


def read(ctx):
    return program_spans.launches_per_span(ctx, "cw.decode.select")
