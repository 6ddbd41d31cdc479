"""Device milliseconds a window of the alignment tail (CUDA events around
decoding.longform.attention_to_jump_times: kernels 2 and 3)."""

from portbench import readers


def read(ctx):
    return readers.ms_per_window(ctx, "align_tail", device=True)
