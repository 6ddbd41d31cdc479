"""Host milliseconds a window in the stitcher and pause adjustment
(pipeline.asr.decode_asr + adjust_pauses), per window served."""

from portbench import readers


def read(ctx):
    return readers.ms_per_window(ctx, "stitch", device=False)
