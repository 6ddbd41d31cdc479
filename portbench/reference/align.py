"""Word-timestamp alignment, plain NumPy: the alignment heads' cross
attention -> z-norm over tokens -> median over frames -> head mean -> DTW
-> the first frame of each token (hf generation_whisper.py:46-118 and
:344-383)."""

from __future__ import annotations

import numpy as np


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Sliding median of odd ``width`` along the last axis, reflect-padded
    at both ends."""
    pad = width // 2
    if x.shape[-1] <= pad:
        return x
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    win = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(win, axis=-1)


def dtw_first_frames(cost: np.ndarray) -> np.ndarray:
    """DTW over an [N, M] cost (diagonal only on strict <, else up only on
    strict <, else left), backtraced from (N, M): the first frame each of
    the N token rows reaches."""
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), np.int8)
    rows = np.arange(n + 1)
    for d in range(2, n + m + 1):          # anti-diagonal i + j = d
        i = rows[(rows >= max(1, d - m)) & (rows <= min(n, d - 1))]
        j = d - i
        c0, c1, c2 = acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1]
        take0 = (c0 < c1) & (c0 < c2)
        take1 = ~take0 & (c1 < c0) & (c1 < c2)
        acc[i, j] = cost[i - 1, j - 1] + np.where(
            take0, c0, np.where(take1, c1, c2))
        trace[i, j] = np.where(take0, 0, np.where(take1, 1, 2))
    trace[0, :] = 2
    trace[:, 0] = 1
    i, j = n, m
    first = np.zeros(n, np.int64)
    while i > 0 or j > 0:
        if i > 0:
            first[i - 1] = j - 1
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.maximum(first, 0)


def token_times(probs: np.ndarray, n_tokens: int, n_frames: int,
                width: int, n_out: int, time_precision: float = 0.02
                ) -> np.ndarray:
    """Seconds of each of ``n_out`` tokens from the alignment heads'
    probabilities [A, T, K] of the generated query rows: the first
    ``n_tokens`` rows and ``n_frames`` frames enter the alignment; tokens
    past ``n_tokens`` repeat the last time."""
    w = probs[:, :n_tokens, :n_frames].astype(np.float64)
    mean = w.mean(axis=1, keepdims=True)
    std = w.std(axis=1, keepdims=True)
    z = (w - mean) / np.maximum(std, 1e-10)
    cost = -median_filter(z, width).mean(axis=0)
    frames = dtw_first_frames(cost) if n_tokens > 0 else np.zeros(0, int)
    out = np.empty(n_out, np.float64)
    k = min(n_out, len(frames))
    out[:k] = frames[:k] * time_precision
    out[k:] = frames[-1] * time_precision if len(frames) else 0.0
    return out
