"""The whole step's share of the card's bf16 peak (989 TFLOP/s): model
operations of every window served (encoder, cross K/V, decoder positions
and LM head, counted from shapes) over the window's seconds."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx)
