"""Evaluation metrics: WER and word-segmentation F1 / IOU.

The reference's published numbers (BASELINE.md) are WER (with the English
normalizer applied to both sides) and word-segmentation F1 at a 50 ms
collar plus average IOU (ref:README.md:59-92, methodology from the
CrisperWhisper paper). These are the tools to reproduce those tables.

Two APIs:
  * `wer` / `word_segmentation_score` — corpus WER and GREEDY
    text+collar matching of word chunks (round-1 API, kept stable).
  * `word_error_rate` / `segmentation_scores` — per-utterance WER with
    S/D/I breakdown, and segmentation scored over the LEVENSHTEIN
    ALIGNMENT of the word sequences (preferred: greedy matching can pair
    a hypothesis word with the wrong same-text instance when words
    repeat; the alignment is unambiguous and collar-independent).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np


def _edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    # thin wrapper over the shared DP builder below (one Levenshtein
    # implementation serves wer / word_error_rate / align_matched_words)
    return int(_levenshtein_matrix(list(ref), list(hyp))[len(ref),
                                                         len(hyp)])


def wer(references: Sequence[str], hypotheses: Sequence[str],
        normalizer: Callable[[str], str] | None = None) -> float:
    """Corpus word error rate; normalizer applied to both sides."""
    errors = 0
    words = 0
    for ref, hyp in zip(references, hypotheses):
        if normalizer is not None:
            ref, hyp = normalizer(ref), normalizer(hyp)
        r, h = ref.split(), hyp.split()
        errors += _edit_distance(r, h)
        words += len(r)
    return errors / max(words, 1)


@dataclass
class SegmentationScore:
    f1: float
    precision: float
    recall: float
    avg_iou: float


def _iou(a: tuple[float, float], b: tuple[float, float]) -> float:
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = max(a[1], b[1]) - min(a[0], b[0])
    return inter / union if union > 0 else 0.0


def word_segmentation_score(
        reference: list[dict], hypothesis: list[dict],
        collar: float = 0.05,
        normalizer: Callable[[str], str] | None = None
        ) -> SegmentationScore:
    """Greedy one-to-one matching of word chunks ({"text", "timestamp"})
    — a hypothesis word is correct when an unmatched reference word has
    the same (normalized) text and both boundaries within `collar`.
    avg IOU is over matched-by-text pairs (boundary-quality measure)."""
    def norm(t: str) -> str:
        t = t.strip().lower()
        return normalizer(t) if normalizer else t

    used = [False] * len(reference)
    tp = 0
    ious: list[float] = []
    for h in hypothesis:
        hs, he = h["timestamp"]
        best = None
        for i, r in enumerate(reference):
            if used[i] or norm(r["text"]) != norm(h["text"]):
                continue
            rs, re_ = r["timestamp"]
            if abs(hs - rs) <= collar and abs(he - re_) <= collar:
                best = i
                break
        if best is not None:
            used[best] = True
            tp += 1
        # IOU over text-matched nearest reference (collar-independent)
        cands = [(_iou((hs, he), r["timestamp"]), i)
                 for i, r in enumerate(reference)
                 if norm(r["text"]) == norm(h["text"])]
        if cands:
            ious.append(max(cands)[0])
    precision = tp / max(len(hypothesis), 1)
    recall = tp / max(len(reference), 1)
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return SegmentationScore(f1=f1, precision=precision, recall=recall,
                             avg_iou=(sum(ious) / len(ious)) if ious
                             else 0.0)


# ---------------------------------------------------------------------------
# Alignment-based API (preferred; see module docstring)
# ---------------------------------------------------------------------------

Word = tuple[str, float, float]          # (text, start_s, end_s)


def _to_words(text_or_words) -> list[str]:
    if isinstance(text_or_words, str):
        return text_or_words.split()
    return list(text_or_words)


def _levenshtein_matrix(ref: list[str], hyp: list[str]) -> np.ndarray:
    """DP cost matrix [len(ref)+1, len(hyp)+1]; substitutions, deletions
    and insertions all cost 1 (standard WER)."""
    n, m = len(ref), len(hyp)
    d = np.zeros((n + 1, m + 1), np.int32)
    d[:, 0] = np.arange(n + 1)
    d[0, :] = np.arange(m + 1)
    hyp_arr = np.asarray(hyp, object)
    for i in range(1, n + 1):
        sub = d[i - 1, :-1] + (hyp_arr != ref[i - 1])
        # vectorized over j except the running insertion minimum, which
        # is inherently sequential — keep that scalar loop tight
        dele = d[i - 1, 1:] + 1
        best = np.minimum(sub, dele)
        run = d[i, 0]
        row = d[i]
        for j in range(1, m + 1):
            run = min(best[j - 1], run + 1)
            row[j] = run
    return d


@dataclass
class WerResult:
    wer: float
    substitutions: int
    deletions: int
    insertions: int
    num_ref_words: int


def word_error_rate(reference, hypothesis,
                    normalizer: Callable[[str], str] | None = None
                    ) -> WerResult:
    """WER between reference and hypothesis (strings or word lists)."""
    if normalizer is not None:
        if not isinstance(reference, str) or not isinstance(hypothesis, str):
            raise ValueError("normalizer requires string inputs")
        reference, hypothesis = normalizer(reference), normalizer(hypothesis)
    ref, hyp = _to_words(reference), _to_words(hypothesis)
    if not ref:
        return WerResult(float(len(hyp) > 0), 0, 0, len(hyp), 0)
    d = _levenshtein_matrix(ref, hyp)
    # backtrace for S/D/I counts
    i, j = len(ref), len(hyp)
    s = dele = ins = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] \
                and ref[i - 1] == hyp[j - 1]:
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + 1:
            s += 1
            i, j = i - 1, j - 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            dele += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return WerResult((s + dele + ins) / len(ref), s, dele, ins, len(ref))


def align_matched_words(ref: Sequence[str], hyp: Sequence[str]
                        ) -> list[tuple[int, int]]:
    """(ref_idx, hyp_idx) pairs of STRING-EQUAL words on the Levenshtein
    alignment path (substituted pairs are not matches)."""
    ref, hyp = list(ref), list(hyp)
    d = _levenshtein_matrix(ref, hyp)
    pairs: list[tuple[int, int]] = []
    i, j = len(ref), len(hyp)
    while i > 0 and j > 0:
        if d[i, j] == d[i - 1, j - 1] and ref[i - 1] == hyp[j - 1]:
            pairs.append((i - 1, j - 1))
            i, j = i - 1, j - 1
        elif d[i, j] == d[i - 1, j - 1] + 1:
            i, j = i - 1, j - 1
        elif d[i, j] == d[i - 1, j] + 1:
            i -= 1
        else:
            j -= 1
    pairs.reverse()
    return pairs


@dataclass
class SegmentationResult:
    f1: float
    precision: float
    recall: float
    avg_iou: float
    matched: int                  # aligned string-equal pairs
    true_positives: int           # matched AND both boundaries in collar


def segmentation_scores(ref_words: Sequence[Word],
                        hyp_words: Sequence[Word],
                        collar: float = 0.05,
                        normalize_word: Callable[[str], str] | None = None
                        ) -> SegmentationResult:
    """Word-boundary F1 @ `collar` seconds + avg IOU
    (ref:README.md:83-90 metric family; collar 0.05 = the table's 50 ms).

    `normalize_word` (e.g. str.lower with punctuation stripping) is
    applied to word strings before alignment so boundary scoring is not
    hostage to casing/punctuation mismatches.
    """
    norm = normalize_word or (lambda w: w)
    ref_txt = [norm(w) for w, _, _ in ref_words]
    hyp_txt = [norm(w) for w, _, _ in hyp_words]
    pairs = align_matched_words(ref_txt, hyp_txt)
    tp = 0
    ious: list[float] = []
    for ri, hi in pairs:
        _, rs, re = ref_words[ri]
        _, hs, he = hyp_words[hi]
        if abs(hs - rs) <= collar and abs(he - re) <= collar:
            tp += 1
        inter = max(0.0, min(re, he) - max(rs, hs))
        union = max(re, he) - min(rs, hs)
        ious.append(inter / union if union > 0 else 0.0)
    precision = tp / len(hyp_words) if hyp_words else 0.0
    recall = tp / len(ref_words) if ref_words else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return SegmentationResult(f1, precision, recall,
                              float(np.mean(ious)) if ious else 0.0,
                              len(pairs), tp)


def chunks_to_words(chunks: Sequence[dict]) -> list[Word]:
    """Adapt the pipeline's word-chunk output
    ({"text": ..., "timestamp": (s, e)}) to (word, start, end) tuples.

    Open-ended timestamps (segment-mode output can leave the final
    segment's end — or both bounds — as None, tokenizer/stitcher.py):
    a None end falls back to the start (zero-length interval, scores
    0 IOU); a chunk with no start at all is skipped."""
    out: list[Word] = []
    for c in chunks:
        s, e = c["timestamp"]
        if s is None:
            continue
        out.append((c["text"].strip(), float(s),
                    float(s if e is None else e)))
    return out
