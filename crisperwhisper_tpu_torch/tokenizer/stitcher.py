"""Chunk stitching: overlap-aware transcript assembly for the pipeline path.

Original design (round-2 rewrite). Behavioral contract — what the HF
pipeline's `tokenizer._decode_asr` + `_find_longest_common_sequence`
(hf tokenization_whisper.py:913-1282) produce — is pinned quirk-for-quirk
by tests/test_stitcher_fuzz.py and tests/test_tokenizer.py, but the
implementation is decomposed differently:

  * the overlap merge scores ALL alignments of two token runs in one
    vectorized pass: each relative shift is an anti-diagonal of the
    equality matrix, so per-shift match counts are a single `bincount`
    over diagonal indices instead of a Python window loop (this is also
    what removes the O(n²)-Python host cost on hour-scale audio);
  * the per-chunk token walk is split into vectorized classification +
    a rollover-clock prepass (`_emitted_times`) + a small event loop,
    with cross-chunk state held by `_OverlapBuffer` / `_Assembler`.

Preserved corner cases (SURVEY.md §7 hard part (c)): stride-timestamp
skipping, the duplicate-timestamp workaround (a closing timestamp equal
to the open one re-opens instead of closing), and >30 s rollover
bookkeeping.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .languages import LANGUAGES
from .whisper_tokenizer import WhisperTokenizer
from .words import collate_word_timestamps

# --------------------------------------------------------------------------
# Overlap merge
# --------------------------------------------------------------------------


def _best_overlap_cut(left, right, left_ts=None,
                      right_ts=None) -> tuple[int, int]:
    """Pick the midpoint cut that best aligns `right` slid across `left`.

    For shift s (1 ≤ s < L+R) the overlap window pairs left[a] with
    right[a-L+s]; all such cells live on one anti-diagonal of the L×R
    equality matrix, so match counts for every shift come from a single
    bincount of diagonal indices. A shift is eligible with ≥2 matches;
    score is matches/s plus a tiny s/1e4 bonus that prefers longer
    overlaps on ties; the earliest shift achieving the maximum wins.
    With no eligible shift the runs are concatenated whole (cut at the
    far ends). In timestamped mode a cell only counts when the left
    token's time does not exceed the right token's (monotonicity gate).

    Returns (left_mid, right_mid): keep left[:left_mid], then
    right[right_mid:].
    """
    L, R = len(left), len(right)
    if L == 0 or R == 0:
        return L, 0
    eq = np.asarray(left).reshape(-1, 1) == np.asarray(right).reshape(1, -1)
    if left_ts is not None:
        lts = np.asarray(left_ts, np.float64)
        rts = np.asarray(right_ts, np.float64)
        if lts.ndim == 1:
            eq &= lts[:, None] <= rts[None, :]
        else:
            # word mode carries (start, end) tuples; Python compares them
            # lexicographically
            ls, le = lts[:, 0][:, None], lts[:, 1][:, None]
            rs, re = rts[:, 0][None, :], rts[:, 1][None, :]
            eq &= (ls < rs) | ((ls == rs) & (le <= re))
    rows, cols = np.nonzero(eq)
    counts = np.bincount(L - rows + cols, minlength=L + R)[1:L + R]
    shifts = np.arange(1, L + R)
    scores = counts / shifts + shifts / 10000.0
    scores[counts <= 1] = -1.0
    best = int(np.argmax(scores))
    if scores[best] <= 0.0:
        return L, 0
    s = int(shifts[best])
    lo_l, hi_l = max(0, L - s), min(L, L + R - s)
    lo_r, hi_r = max(0, s - L), min(R, s)
    return (lo_l + hi_l) // 2, (lo_r + hi_r) // 2


def find_longest_common_sequence(sequences: list[list[int]],
                                 token_timestamp_sequences: list | None = None
                                 ):
    """Fold a list of token runs left-to-right, resolving each adjacent
    overlap at the best-alignment midpoint (see `_best_overlap_cut`)."""
    carry = list(sequences[0])
    use_ts = bool(token_timestamp_sequences)
    carry_ts = list(token_timestamp_sequences[0]) if use_ts else None
    merged: list[int] = []
    merged_ts: list = []
    for k in range(1, len(sequences)):
        nxt = list(sequences[k])
        nxt_ts = list(token_timestamp_sequences[k]) if use_ts else None
        cut_l, cut_r = _best_overlap_cut(carry, nxt, carry_ts, nxt_ts)
        merged.extend(carry[:cut_l])
        carry = nxt[cut_r:]
        if use_ts:
            merged_ts.extend(carry_ts[:cut_l])
            carry_ts = nxt_ts[cut_r:]
    merged.extend(carry)
    if token_timestamp_sequences is None:
        return merged
    if use_ts:
        merged_ts.extend(carry_ts)
        return merged, merged_ts
    return merged, []


# --------------------------------------------------------------------------
# decode_asr
# --------------------------------------------------------------------------


def _emitted_times(ids: np.ndarray, ts_mask: np.ndarray, tsb: int,
                   tp: float, time_offset: float,
                   segment_size: int) -> dict[int, float]:
    """Rollover clock: absolute emitted time per timestamp-token position.

    A timestamp lower than the running maximum means the window re-based:
    after a full closing pair the clock resumes from the penultimate
    timestamp; after a single trailing timestamp the seek advanced one
    whole window (segment_size frames).
    """
    times: dict[int, float] = {}
    cur_max = penult = rolled = 0.0
    for i in np.nonzero(ts_mask)[0]:
        i = int(i)
        raw = float((int(ids[i]) - tsb) * tp)
        if raw < cur_max:
            if i < 2 or (ts_mask[i - 1] and ts_mask[i - 2]):
                cur_max = penult
                rolled += penult
            else:
                rolled += tp * segment_size
        penult, cur_max = cur_max, raw
        times[i] = round(raw + time_offset + rolled, 2)
    return times


def _overlap_guard(ids: np.ndarray, ts_mask: np.ndarray, tsb: int,
                   tp: float, window_end_s: float) -> int | None:
    """Smallest timestamp token of the trailing run at/after the
    right-stride boundary. Timestamps ≥ the guard belong to audio the
    NEXT chunk re-decodes, so they must not close segments here."""
    guard = None
    for i in range(len(ids) - 1, -1, -1):
        if not ts_mask[i]:
            continue
        if guard is not None and (int(ids[i]) - tsb) * tp < window_end_s:
            break
        guard = int(ids[i])
    return guard


class _OverlapBuffer:
    """Token runs (and word-mode per-token times) awaiting resolution
    across chunk boundaries."""

    def __init__(self):
        self.runs: list[list[int]] = []
        self.ts_runs: list[list] = []

    def push(self, run: list[int], ts_run: list | None = None) -> None:
        self.runs.append(run)
        if ts_run is not None:
            self.ts_runs.append(ts_run)

    def __bool__(self) -> bool:
        return bool(self.runs)

    @property
    def all_empty(self) -> bool:
        return not any(self.runs)

    def resolve(self) -> tuple[list[int], list]:
        return find_longest_common_sequence(self.runs, self.ts_runs)

    def resolve_tokens_only(self) -> list[int]:
        return find_longest_common_sequence(self.runs)

    def clear(self) -> None:
        self.runs = []
        self.ts_runs = []


class _Assembler:
    """Output-side state: the open segment and the finished list."""

    def __init__(self, tok: WhisperTokenizer, word_mode: bool,
                 return_language):
        self.tok = tok
        self.word_mode = word_mode
        self.return_language = return_language
        self.done: list[dict] = []
        self.language = None           # most recent language token seen
        self.open = self._fresh()

    def _fresh(self) -> dict:
        return {"language": self.language, "timestamp": [None, None],
                "text": ""}

    def reopen(self) -> None:
        self.open = self._fresh()

    def close(self, buffer: _OverlapBuffer) -> None:
        """Resolve the buffer into the open segment and finish it."""
        tokens, tstamps = buffer.resolve()
        self.open["text"] = self.tok.decode(tokens)
        if self.word_mode:
            self.open["words"] = collate_word_timestamps(
                self.tok, tokens, tstamps, self.language,
                self.return_language)
        self.done.append(self.open)
        buffer.clear()
        self.reopen()

    def close_text_only(self, buffer: _OverlapBuffer) -> None:
        """Language-switch flush: tokens only, no timestamp resolution."""
        self.open["text"] = self.tok.decode(buffer.resolve_tokens_only())
        self.done.append(self.open)
        buffer.runs = []               # quirk: ts_runs intentionally kept
        self.reopen()


def decode_asr(tok: WhisperTokenizer, model_outputs: list[dict[str, Any]],
               *, return_timestamps, return_language,
               time_precision: float, segment_size: int = 1500):
    """Stitch per-chunk model outputs into (full_text, {"chunks": ...}).

    model_outputs: dicts with "tokens" ([1, T] array), optionally
    "token_timestamps" ([1, T] seconds) and "stride"
    ((chunk_len_s, left_s, right_s)).
    """
    word_mode = return_timestamps == "word"
    tsb = tok.timestamp_begin
    specials = set(tok.all_special_ids)
    lang_memo: dict[int, str | None] = {}

    def language_of(token: int) -> str | None:
        if token not in lang_memo:
            lang_memo[token] = LANGUAGES.get(tok.decode([token])[2:-2])
        return lang_memo[token]

    asm = _Assembler(tok, word_mode, return_language)
    buffer = _OverlapBuffer()
    clock = 0.0                        # running absolute offset (seconds)
    skip_overlap = False               # persists across chunks

    for output in model_outputs:
        ids_list = tok.strip_prompt(
            [int(t) for t in np.asarray(output["tokens"][0])])
        ids = np.asarray(ids_list, np.int64)
        ts_mask = ids >= tsb
        if word_mode:
            tok_times = [float(t)
                         for t in np.asarray(output["token_timestamps"][0])]

        guard = None
        earliest_valid = tsb           # timestamps below this are overlap
        stride = output.get("stride")
        if stride is not None:
            chunk_len, stride_left, stride_right = stride
            clock -= stride_left
            if stride_left:
                earliest_valid = stride_left / time_precision + tsb
            if stride_right:
                guard = _overlap_guard(ids, ts_mask, tsb, time_precision,
                                       chunk_len - stride_right)

        emitted = _emitted_times(ids, ts_mask, tsb, time_precision, clock,
                                 segment_size)

        run: list[int] = []
        run_times: list = []
        for i, token in enumerate(ids_list):
            if token in specials:
                lang = language_of(token)
                if lang is None:
                    continue
                if (asm.language and lang != asm.language
                        and not return_timestamps):
                    buffer.push(run)
                    run = []
                    asm.close_text_only(buffer)
                asm.open["language"] = lang
                asm.language = lang
            elif ts_mask[i]:
                t = emitted[i]
                if guard is not None and token >= guard:
                    skip_overlap = True
                elif skip_overlap or (buffer and token < earliest_valid):
                    skip_overlap = False
                elif asm.open["timestamp"][0] is None:
                    asm.open["timestamp"][0] = t
                elif t != asm.open["timestamp"][0]:
                    asm.open["timestamp"][1] = t
                    buffer.push(run, run_times if word_mode else None)
                    run, run_times = [], []
                    asm.close(buffer)
                # else: duplicate of the opening timestamp — ignore (the
                # generate loop can emit <|t|><|t|> at a segment seam)
            else:
                run.append(token)
                if word_mode:
                    prev = 0.0 if i == 0 else tok_times[i - 1]
                    run_times.append((round(prev + clock, 2),
                                      round(tok_times[i] + clock, 2)))

        if stride is not None:
            clock += chunk_len - stride_right
        if run:
            buffer.push(run, run_times if word_mode else None)
        elif buffer.all_empty:
            # nothing carried and nothing new: drop any half-open segment
            buffer.clear()
            asm.reopen()

    if buffer:
        asm.close(buffer)

    chunks = asm.done
    full_text = "".join(c["text"] for c in chunks)
    if return_timestamps or return_language:
        for c in chunks:
            if return_timestamps:
                c["timestamp"] = tuple(c["timestamp"])
            else:
                c.pop("timestamp")
            if not return_language:
                c.pop("language")
        if word_mode:
            words = [w for c in chunks for w in c["words"]]
            return full_text, {"chunks": words}
        return full_text, {"chunks": chunks}
    return full_text, {}
