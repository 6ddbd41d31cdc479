"""Logits processors as batch-vectorized tensor functions.

Port of crisperwhisper_tpu/decoding/processors.py: the reference's Whisper
processor stack (hf generation/logits_process.py, in the order of
generation_whisper.py:1797-1836: begin-suppress -> suppress -> timestamp
grammar) with masks instead of per-row loops, and an explicit per-row
grammar state instead of re-scanning the generated ids every step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import GenerationOptions, SpecialTokens

NEG_INF = float("-inf")


@dataclass
class TimestampState:
    """Per-row grammar state (all [B])."""
    last_was_ts: torch.Tensor      # bool: seq[-1] is a timestamp token
    penult_was_ts: torch.Tensor    # bool: len(seq)<2 or seq[-2] is timestamp
    last_ts: torch.Tensor          # int32: most recent timestamp id (or -1)
    num_generated: torch.Tensor    # int32: tokens generated past begin_index

    @classmethod
    def init(cls, batch: int, device: torch.device | str = "cpu"
             ) -> "TimestampState":
        return cls(
            last_was_ts=torch.zeros((batch,), dtype=torch.bool,
                                    device=device),
            penult_was_ts=torch.ones((batch,), dtype=torch.bool,
                                     device=device),
            last_ts=torch.full((batch,), -1, dtype=torch.int32,
                               device=device),
            num_generated=torch.zeros((batch,), dtype=torch.int32,
                                      device=device))

    def update(self, token: torch.Tensor, ts_begin: int) -> "TimestampState":
        is_ts = token >= ts_begin
        # reference: penultimate_was_timestamp = len(seq) < 2 or
        # seq[-2] >= ts (logits_process.py:2029); after this update
        # len(seq) = num_generated + 1, so "len < 2" is num_generated == 0
        return TimestampState(
            last_was_ts=is_ts,
            penult_was_ts=(self.num_generated < 1) | self.last_was_ts,
            last_ts=torch.where(is_ts, token.to(torch.int32), self.last_ts),
            num_generated=self.num_generated + 1)

    def where(self, keep_new: torch.Tensor,
              old: "TimestampState") -> "TimestampState":
        """Rows where keep_new is True take self, the others old."""
        return TimestampState(*(torch.where(keep_new, n, o) for n, o in zip(
            (self.last_was_ts, self.penult_was_ts, self.last_ts,
             self.num_generated),
            (old.last_was_ts, old.penult_was_ts, old.last_ts,
             old.num_generated))))


def suppress_tokens_mask(vocab_size: int, tokens: tuple[int, ...]
                         ) -> np.ndarray:
    mask = np.zeros((vocab_size,), bool)
    for t in tokens:
        mask[t] = True
    return mask


def apply_suppress(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """SuppressTokensLogitsProcessor (logits_process.py:1883-1920)."""
    return scores.masked_fill(mask[None, :], NEG_INF)


def apply_begin_suppress(scores: torch.Tensor, mask: torch.Tensor,
                         is_begin: torch.Tensor) -> torch.Tensor:
    """SuppressTokensAtBeginLogitsProcessor (:1830-1880); is_begin is a
    scalar or [B] bool for 'we are at begin_index'."""
    is_begin = torch.as_tensor(is_begin, device=scores.device) \
        .broadcast_to(scores.shape[:1])
    return scores.masked_fill(is_begin[:, None] & mask[None, :], NEG_INF)


def apply_timestamp_rules(scores: torch.Tensor, state: TimestampState,
                          specials: SpecialTokens,
                          max_initial_timestamp_index: int | None,
                          detect_from_logprob: bool = True) -> torch.Tensor:
    """WhisperTimeStampLogitsProcessor (logits_process.py:2013-2058),
    vectorized. ``scores`` [B, V] f32; returns processed scores."""
    vocab = torch.arange(scores.shape[1], device=scores.device)[None, :]
    ts_begin = specials.timestamp_begin
    is_ts_tok = vocab >= ts_begin

    # 1. always suppress <|notimestamps|>
    scores = scores.masked_fill(vocab == specials.no_timestamps, NEG_INF)

    has_generated = state.num_generated >= 1
    # 2. pairing rules
    last, penult = state.last_was_ts, state.penult_was_ts
    # last ts & penult ts -> the next token must be text
    force_text = has_generated & last & penult
    scores = scores.masked_fill(force_text[:, None] & is_ts_tok, NEG_INF)
    # last ts & penult text -> only eos or timestamps (suppress < eos)
    force_close = has_generated & last & ~penult
    scores = scores.masked_fill(force_close[:, None] & (vocab < specials.eot),
                                NEG_INF)

    # 3. monotonic timestamps: suppress [ts_begin, ts_last) — the last
    # timestamp itself stays allowed inside an open pair, else last + 1
    has_ts = state.last_ts >= 0
    inside_pair = last & ~penult
    ts_last = torch.where(inside_pair, state.last_ts, state.last_ts + 1)
    mono = has_ts[:, None] & is_ts_tok & (vocab < ts_last[:, None])
    scores = scores.masked_fill(mono, NEG_INF)

    # 4. the first generated token is a timestamp, bounded by
    # max_initial_timestamp_index
    is_begin = state.num_generated == 0
    scores = scores.masked_fill(is_begin[:, None] & ~is_ts_tok, NEG_INF)
    if max_initial_timestamp_index is not None:
        last_allowed = ts_begin + max_initial_timestamp_index
        scores = scores.masked_fill(is_begin[:, None] & (vocab > last_allowed),
                                    NEG_INF)

    # 5. if P(any timestamp) > max P(text token): force a timestamp
    if detect_from_logprob:
        logprobs = torch.log_softmax(scores, dim=-1)
        ts_lp = torch.logsumexp(logprobs.masked_fill(~is_ts_tok, NEG_INF),
                                dim=-1)
        max_text_lp = logprobs.masked_fill(is_ts_tok, NEG_INF).amax(dim=-1)
        force_ts = ts_lp > max_text_lp
        scores = scores.masked_fill(force_ts[:, None] & ~is_ts_tok, NEG_INF)
    return scores


def process_scores(raw_scores: torch.Tensor, state: TimestampState,
                   specials: SpecialTokens, opts: GenerationOptions,
                   suppress: torch.Tensor | None,
                   begin_suppress: torch.Tensor | None,
                   return_timestamps: bool = True) -> torch.Tensor:
    """Apply the full processor stack in the reference's order."""
    scores = raw_scores
    is_begin = state.num_generated == 0
    if begin_suppress is not None:
        scores = apply_begin_suppress(scores, begin_suppress, is_begin)
    if suppress is not None:
        scores = apply_suppress(scores, suppress)
    if return_timestamps:
        scores = apply_timestamp_rules(
            scores, state, specials, opts.max_initial_timestamp_index)
    return scores
