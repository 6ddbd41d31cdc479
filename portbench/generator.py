"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and yields the calls of a closed loop.

A mix fixes a set of recording lengths that is the same for every seed;
the seed draws the audio and the order. Two length rules exist:

* ``log_uniform_windows``: lengths spread log-uniformly over [min_s,
  max_s] by a golden-ratio sequence, added until their windows fill
  ``windows`` exactly (the last recording cut to fit);
* ``grid``: min_s, min_s + step_s, ..., max_s.

``per_call`` is ``"all"`` (each call sends every recording, in a new
order drawn from the seed) or ``"one"`` (each call sends one recording;
each pass over the list takes a new order). A call decodes
``ceil(per_audio_s * seconds)`` new tokens a window, at most ``max``, or
``max`` when ``per_audio_s`` is null. The windows are those of the
pipeline's chunking (``chunk_iter`` below, a frozen copy of the port's).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

SR = 16000
WINDOW = 30 * SR                 # samples of one window
STRIDE = 5 * SR                  # chunk_length / 6 on each side
GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


def chunk_bounds(n: int, n_samples: int = WINDOW,
                 stride: int = STRIDE) -> list[tuple[int, int]]:
    """(start, length) of each window the pipeline cuts from n samples
    (the port's ``pipeline.asr.chunk_iter``)."""
    out = []
    step = n_samples - 2 * stride
    for start in range(0, n, step):
        length = min(n_samples, n - start)
        left = 0 if start == 0 else stride
        if length > left:
            out.append((start, length))
        if start + n_samples >= n:
            break
    return out


def samples_for_windows(r: int) -> int:
    """The longest recording that makes exactly r >= 1 windows."""
    return WINDOW + (r - 1) * (WINDOW - 2 * STRIDE)


def lengths(rule: dict) -> list[int]:
    """The mix's recording lengths in samples (independent of the seed)."""
    if rule["rule"] == "grid":
        n = int(round((rule["max_s"] - rule["min_s"]) / rule["step_s"]))
        return [int(round((rule["min_s"] + i * rule["step_s"]) * SR))
                for i in range(n + 1)]
    if rule["rule"] == "log_uniform_windows":
        lo, hi, target = rule["min_s"], rule["max_s"], rule["windows"]
        out, total, k = [], 0, 0
        while total < target:
            k += 1
            u = (k * GOLDEN) % 1.0
            n = int(round(lo * (hi / lo) ** u * SR))
            w = len(chunk_bounds(n))
            if total + w > target:
                n = samples_for_windows(target - total)
                w = target - total
            out.append(n)
            total += w
        return out
    raise ValueError(f"unknown length rule {rule['rule']!r}")


def new_tokens(rule: dict, n_samples: int) -> int:
    per = rule.get("per_audio_s")
    if per is None:
        return int(rule["max"])
    return int(min(rule["max"], math.ceil(per * n_samples / SR)))


def make_audio(rng: np.random.Generator, n: int, spec: dict) -> np.ndarray:
    """Speech-like audio, 16 kHz f32: segments of ``segment_s`` seconds,
    each voiced (a pitch drawn from ``pitch_hz`` with its second
    harmonic at half the level, sin x (1 + cos x); a level drawn from
    ``level``) or, with probability
    ``pause``, silent; white noise of ``noise_amp`` under it all."""
    seg = int(spec["segment_s"] * SR)
    n_seg = -(-n // seg)
    pitch = rng.uniform(*spec["pitch_hz"], n_seg)
    level = rng.uniform(*spec["level"], n_seg) * (
        rng.random(n_seg) >= spec["pause"])
    # the phase restarts each segment: [n_seg, seg] in f32
    phase = np.outer((2.0 * np.pi / SR) * pitch,
                     np.arange(seg)).astype(np.float32)
    voice = np.cos(phase)
    voice += 1.0
    voice *= np.sin(phase)
    voice *= level.astype(np.float32)[:, None]
    out = voice.reshape(-1)[:n]
    out += spec["noise_amp"] * rng.standard_normal(n, np.float32)
    return out


@dataclass
class Call:
    recordings: list[int]          # indices into Traffic.audio
    max_new: int                   # new tokens a window


class Traffic:
    """The calls of one run: ``warmup()`` once, then ``next_call()``."""

    def __init__(self, mix: dict, seed: int, batch_size: int):
        self.mix = mix
        self.rng = np.random.default_rng([int(seed) % 2 ** 63, 0])
        self.lengths = lengths(mix["lengths"])
        self.audio = [make_audio(self.rng, n, mix["audio"])
                      for n in self.lengths]
        self.batch_size = batch_size
        self._queue: list[int] = []

    def call_of(self, recordings: list[int]) -> Call:
        longest = max(self.lengths[i] for i in recordings)
        return Call(recordings, new_tokens(self.mix["new_tokens"], longest))

    def next_call(self) -> Call:
        n = len(self.lengths)
        if self.mix["per_call"] == "all":
            return self.call_of([int(i) for i in self.rng.permutation(n)])
        if not self._queue:
            self._queue = [int(i) for i in self.rng.permutation(n)]
        return self.call_of([self._queue.pop()])

    def warmup(self) -> list[tuple[list[np.ndarray], int]]:
        """(audio list, new tokens) of the calls that warm every shape the
        window uses: for ``all``, one recording of exactly one batch of
        windows (every batch of the window is full); for ``one``, each
        distinct new-token count once, on the shortest recording that
        has it."""
        if self.mix["per_call"] == "all":
            n = samples_for_windows(self.batch_size)
            audio = make_audio(np.random.default_rng(0), n,
                               self.mix["audio"])
            return [([audio], new_tokens(self.mix["new_tokens"], n))]
        seen: dict[int, int] = {}
        for i in sorted(range(len(self.lengths)),
                        key=lambda i: self.lengths[i]):
            seen.setdefault(new_tokens(self.mix["new_tokens"],
                                       self.lengths[i]), i)
        return [([self.audio[i]], k) for k, i in sorted(seen.items())]

    def windows(self, call: Call) -> list[tuple[int, int, int]]:
        """(recording, start, length) of every window of a call, in the
        pipeline's order."""
        return [(r, s, n) for r in call.recordings
                for s, n in chunk_bounds(self.lengths[r])]
