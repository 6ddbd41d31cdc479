"""Device milliseconds a window of the log-mel frontend (CUDA events
around pipeline.asr.extract_features)."""

from portbench import readers


def read(ctx):
    return readers.ms_per_window(ctx, "mel", device=True)
