"""Device milliseconds a window of the encoder (CUDA events around
decoding.longform.encode; attention is kernel 1)."""

from portbench import readers


def read(ctx):
    return readers.ms_per_window(ctx, "encode", device=True)
