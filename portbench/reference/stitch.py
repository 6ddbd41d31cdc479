"""The pipeline's host tail, plain Python: a recording's windows of served
tokens and token times -> the overlap merge -> text and words -> the
pause adjustment (``transcribe``, word mode), or served tokens -> the
overlap merge -> text (``transcribe_text``, text mode).

Frozen copies of the port's ``tokenizer/stitcher.py`` (the overlap merge,
``find_longest_common_sequence`` with and without times, and
``decode_asr``'s walk), ``tokenizer/words.py`` (unicode and space
grouping, punctuation gluing) and ``pipeline/pauses.py``, cut to the path
the benchmark's traffic takes: every served token is a text token (the
mixes suppress every id from <|endoftext|> on, and the prompt holds
<|notimestamps|>), so no window carries a timestamp, language or special
token, and the merged tokens form one segment. A token outside the
vocabulary's text ids raises ValueError. The text comes from ``pieces``,
the bytes of each text id that the cell's architecture file gives
(``text_pieces()``), not from the program's tokenizer.
"""

from __future__ import annotations

import re

import numpy as np


TIMESTAMP_RE = re.compile(r"<\|\d+\.\d+\|>")
PREPEND_PUNCTUATIONS = "\"'“¡¿([{-"
APPEND_PUNCTUATIONS = "\"'.。,，!！?？:：”)]}、"
PUNCT = "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
REP = "�"


def piece(token: int, pieces: list[bytes]) -> bytes:
    if not 0 <= token < len(pieces):
        raise ValueError(f"token {token} is not a text token")
    return pieces[token]


def decode(tokens, pieces: list[bytes]) -> str:
    text = b"".join(piece(int(t), pieces) for t in tokens).decode(
        "utf-8", errors="replace")
    return TIMESTAMP_RE.sub("", text)


# -- the overlap merge ------------------------------------------------------

def best_overlap_cut(left, right, left_ts=None,
                     right_ts=None) -> tuple[int, int]:
    """(left_mid, right_mid): keep left[:left_mid], then right[right_mid:].
    Every relative shift s of ``right`` over ``left`` is scored by its
    matches (equal tokens, and with times, whose (start, end) on the left
    does not come after the right's) over s, plus s/1e4; a shift needs two
    matches; the earliest best wins; with none the runs are joined
    whole."""
    L, R = len(left), len(right)
    if L == 0 or R == 0:
        return L, 0
    eq = np.asarray(left).reshape(-1, 1) == np.asarray(right).reshape(1, -1)
    if left_ts is not None:
        lts = np.asarray(left_ts, np.float64)
        rts = np.asarray(right_ts, np.float64)
        ls, le = lts[:, 0][:, None], lts[:, 1][:, None]
        rs, re_ = rts[:, 0][None, :], rts[:, 1][None, :]
        eq &= (ls < rs) | ((ls == rs) & (le <= re_))
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


def merge_runs(runs: list, ts_runs: list | None = None) -> tuple:
    """(tokens, token times) of the overlap merge of ``runs``; without
    ``ts_runs`` (text mode) the merge has no time gate and the times are
    None."""
    timed = ts_runs is not None
    if not timed:
        ts_runs = [[None] * len(r) for r in runs]
    carry, carry_ts = list(runs[0]), list(ts_runs[0])
    merged, merged_ts = [], []
    for nxt, nxt_ts in zip(runs[1:], ts_runs[1:]):
        times = (carry_ts, nxt_ts) if timed else (None, None)
        cut_l, cut_r = best_overlap_cut(carry, nxt, *times)
        merged += carry[:cut_l]
        merged_ts += carry_ts[:cut_l]
        carry, carry_ts = list(nxt[cut_r:]), list(nxt_ts[cut_r:])
    return merged + carry, merged_ts + carry_ts if timed else None


# -- words ------------------------------------------------------------------

def split_on_unicode(tokens, pieces: list[bytes]):
    parts = [piece(int(t), pieces) for t in tokens]
    full_text = b"".join(parts).decode("utf-8", errors="replace")
    words, indices = [], []
    buf, idxs, offset = bytearray(), [], 0
    for k in range(len(tokens)):
        buf += parts[k]
        idxs.append(k)
        text = buf.decode("utf-8", errors="replace")
        bad = text.find(REP)
        if bad == -1 or full_text[offset + bad] == REP:
            words.append(text)
            indices.append(idxs)
            buf, idxs = bytearray(), []
            offset += len(text)
    return words, indices


def split_on_spaces(tokens, pieces: list[bytes]):
    words, indices = [], []
    for text, idx in zip(*split_on_unicode(tokens, pieces)):
        if not words or text.startswith(" ") or text.strip() in PUNCT:
            words.append(text)
            indices.append(idx)
        else:
            words[-1] += text
            indices[-1] += idx
    return words, indices


def merge_punctuations(words: list, indices: list) -> tuple[list, list]:
    n = len(words)
    w, x = list(words), [list(i) for i in indices]
    anchor = n - 1
    for i in range(n - 2, -1, -1):
        if w[i].startswith(" ") and w[i].strip() in PREPEND_PUNCTUATIONS:
            w[anchor] = w[i] + w[anchor]
            x[anchor][:0] = x[i]
            w[i], x[i] = "", []
        else:
            anchor = i
    anchor = 0
    for j in range(1, n):
        if not w[anchor].endswith(" ") and w[j] in APPEND_PUNCTUATIONS:
            w[anchor] += w[j]
            x[anchor] += x[j]
            w[j], x[j] = "", []
        else:
            anchor = j
    return [v for v in w if v], [v for v in x if v]


def adjust_pauses(words: list, split_threshold: float) -> list:
    for i in range(len(words) - 1):
        left_start, left_end = words[i]["timestamp"]
        right_start, right_end = words[i + 1]["timestamp"]
        gap = right_start - left_end
        if gap <= 0:
            continue
        half = (split_threshold if gap > split_threshold else gap) / 2
        words[i]["timestamp"] = (left_start, left_end + half)
        words[i + 1]["timestamp"] = (right_start - half, right_end)
    return words


# -- one recording ----------------------------------------------------------

def transcribe(windows: list, pause_threshold: float | None,
               pieces: list[bytes]) -> dict:
    """``{"text", "chunks": [{"text", "timestamp": (start, end)}]}`` of one
    recording from its windows in order, each (tokens, token times in s,
    (length, left stride, right stride) in s)."""
    runs, ts_runs, clock = [], [], 0.0
    for tokens, times, (length, left, right) in windows:
        clock -= left
        tokens = [int(t) for t in tokens]
        times = [float(t) for t in times]
        for t in tokens:
            piece(t, pieces)
        if tokens:
            runs.append(tokens)
            ts_runs.append([(round((0.0 if i == 0 else times[i - 1])
                                   + clock, 2), round(times[i] + clock, 2))
                            for i in range(len(tokens))])
        clock += length - right
    if not runs:
        return {"text": "", "chunks": []}
    tokens, stamps = merge_runs(runs, ts_runs)
    words, indices = merge_punctuations(*split_on_spaces(tokens, pieces))
    chunks = [{"text": word, "timestamp": (stamps[idx[0]][0],
                                           stamps[idx[-1]][1])}
              for word, idx in zip(words, indices)]
    if pause_threshold is not None:
        chunks = adjust_pauses(chunks, pause_threshold)
    return {"text": decode(tokens, pieces), "chunks": chunks}


def transcribe_text(windows: list, pieces: list[bytes]) -> dict:
    """``{"text"}`` of one recording from its windows' served tokens in
    order: the text-mode walk, which merges the runs without times and
    makes no words."""
    runs = []
    for tokens in windows:
        tokens = [int(t) for t in tokens]
        for t in tokens:
            piece(t, pieces)
        if tokens:
            runs.append(tokens)
    return {"text": decode(merge_runs(runs)[0], pieces) if runs else ""}
