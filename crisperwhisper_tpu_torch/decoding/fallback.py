# Verbatim copy of crisperwhisper_tpu/decoding/fallback.py: the functions are
# unchanged, only the imports point at the port's own modules. The port
# imports nothing of the JAX package; tests/test_torch_pipeline.py pins
# this copy to the original.
"""Hallucination-mitigation gates for the temperature-fallback ladder.

Semantic ports of hf generation_whisper.py:
  * _retrieve_compression_ratio (:1970-1977) — zlib ratio over
    little-endian packed token bytes (byte width from vocab size).
  * _need_fallback (:1255-1299) — compression-ratio / avg-logprob /
    no-speech gates.

avg-logprob itself is accumulated on device by the decode loop
(sum of chosen-token logprobs over processed unscaled scores, divided by
token count incl. eos — _retrieve_avg_logprobs :1979-1996 semantics).
"""

from __future__ import annotations

import math
import zlib

import numpy as np

from ..config import GenerationOptions


def compression_ratio(tokens: np.ndarray, vocab_size: int) -> float:
    """len(raw token bytes) / len(zlib-compressed token bytes)."""
    length = int(math.log2(vocab_size) / 8) + 1
    token_bytes = b"".join(
        int(t).to_bytes(length, "little") for t in np.asarray(tokens))
    if not token_bytes:
        return 0.0
    return len(token_bytes) / len(zlib.compress(token_bytes))


def need_fallback(seek_sequence: np.ndarray, avg_logprob: float,
                  no_speech_prob: float, vocab_size: int,
                  opts: GenerationOptions) -> tuple[bool, bool]:
    """Returns (needs_fallback, should_skip) for one row.

    seek_sequence includes the trailing eos (kept for the logprob check,
    generate_with_fallback :1080-1085).
    """
    needs_fallback = False
    should_skip = False
    if opts.compression_ratio_threshold is not None:
        if compression_ratio(seek_sequence, vocab_size) \
                > opts.compression_ratio_threshold:
            needs_fallback = True
    if opts.logprob_threshold is not None:
        if avg_logprob < opts.logprob_threshold:
            needs_fallback = True
    if opts.no_speech_threshold is not None:
        if (opts.logprob_threshold is not None
                and avg_logprob < opts.logprob_threshold
                and no_speech_prob > opts.no_speech_threshold):
            needs_fallback = False
            should_skip = True
    return needs_fallback, should_skip
