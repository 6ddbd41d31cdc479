"""Kernel launches the host issued inside the program's cw.decode.step
spans (the model step: the plain decode_step, or kernel 5 with its
wrapper's copies and the LM head), over those spans: one a decode-loop
step, in the profiled window."""

from portbench import program_spans


def read(ctx):
    return program_spans.launches_per_span(ctx, "cw.decode.step")
