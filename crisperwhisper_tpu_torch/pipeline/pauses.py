"""Pause-aware word-boundary redistribution.

The one algorithmic contribution hosted in the reference repo itself
(ref:utils.py:1-29): CrisperWhisper's adjusted tokenizer attributes pause
time to standalone space tokens, so raw word intervals hug the speech
tightly and gaps collect between words. This pass gives each word half of
the adjacent gap back — capped at ``split_threshold`` seconds per gap —
which symmetrizes boundary placement and is what the reference's README
recipe applies to every pipeline output (ref:README.md:174).

Bit-exactness contract (tests/test_tokenizer.py): for a gap g > 0 between
word i's end e_i and word i+1's start s_{i+1}:
    d = min(g, split_threshold) / 2
    e_i += d ; s_{i+1} -= d
computed in iteration order, like the reference, so a word adjusted on its
right keeps that adjustment when its left neighbor is processed next.
"""

from __future__ import annotations

from typing import Any


def adjust_pauses(pipeline_output: dict[str, Any],
                  split_threshold: float = 0.12) -> dict[str, Any]:
    """Redistribute inter-word pauses in a ``{"chunks": [...]}`` result.

    Mutates (and returns) ``pipeline_output``, matching the reference's
    in-place contract.
    """
    words = list(pipeline_output["chunks"])
    for i in range(len(words) - 1):
        left_start, left_end = words[i]["timestamp"]
        right_start, right_end = words[i + 1]["timestamp"]
        gap = right_start - left_end
        if gap <= 0:
            continue
        half = (split_threshold if gap > split_threshold else gap) / 2
        words[i]["timestamp"] = (left_start, left_end + half)
        words[i + 1]["timestamp"] = (right_start - half, right_end)
    pipeline_output["chunks"] = words
    return pipeline_output


# reference-compatible alias
adjust_pauses_for_hf_pipeline_output = adjust_pauses
