"""Shared arithmetic of the per-layer metrics' readers (metrics/*.py).

Each returns None where the run gave it nothing to read, never 0 for a
share of a roofline or of a peak."""

from __future__ import annotations

import math

from . import work

BF16_PEAK = work.PEAK_FLOPS_PER_S["bf16"]


def ms_per_window(ctx, span: str, device: bool) -> float | None:
    """A span's milliseconds per window served: its device seconds
    (CUDA events) or host seconds, over the rows it served."""
    recs = ctx.spans.of(span)
    rows = sum(r.rows for r in recs)
    if not recs or rows == 0:
        return None
    secs = ctx.spans.device_s(span) if device else \
        sum(r.host_s for r in recs)
    return None if secs is None else 1e3 * secs / rows


def decode_step_ms(ctx) -> float | None:
    """Host milliseconds a decode-loop step: the synced spans around
    greedy_decode over the steps of their loops."""
    recs = ctx.spans.of("decode")
    steps = sum(r.steps for r in recs)
    return 1e3 * sum(r.host_s for r in recs) / steps if steps else None


def idle_share(ctx) -> float | None:
    """Percent of the traced window in which no operation ran on the
    device."""
    if ctx.trace is None or ctx.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window_s)


def mfu(ctx) -> float | None:
    """Percent of the card's bf16 peak: the model operations of every
    window served in the window (the architecture's
    ``work.window_flops``, from shapes) over the window's seconds."""
    if not ctx.windows or ctx.window_s <= 0:
        return None
    flops = math.fsum(ctx.work.window_flops(ctx.arch, ctx.prompt_len,
                                            len(w.tokens))
                      for w in ctx.windows)
    return 100.0 * flops / ctx.window_s / BF16_PEAK
