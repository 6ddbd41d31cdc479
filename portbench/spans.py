"""The benchmark's spans around the port's layer calls, and the capture
of what the timed path served.

``Capture`` wraps the pipeline's call of the seek-loop ``generate`` and
keeps each window's tokens and token times for the check; it is on in
every run and costs a list append a batch. ``Spans`` (traced runs only)
wraps the layer entry points as the pipeline reaches them:

=============  ==============================================  ==========
span           port callable (module attribute replaced)       clock
=============  ==============================================  ==========
mel            pipeline.asr.extract_features                   CUDA events
encode         decoding.longform.encode                        CUDA events
decode         decoding.longform.greedy_decode                 host, synced
align_tail     decoding.longform.attention_to_jump_times       CUDA events
stitch         pipeline.asr.decode_asr, pipeline.asr.adjust_pauses   host
=============  ==============================================  ==========

Each span also opens a ``record_function("pb.<span>")`` range, so the
profiler's timeline says what the host was doing in a device gap. A span
records the rows (windows) it served and, for ``decode``, the steps of
its loop.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from crisperwhisper_tpu_torch.decoding import longform
from crisperwhisper_tpu_torch.pipeline import asr


def _replace(module, name: str, wrapper, undo: list) -> None:
    undo.append((module, name, getattr(module, name)))
    setattr(module, name, wrapper)


class Capture:
    """Every batch's served tokens and token times, in call order:
    ``batches`` is a list of lists of (tokens int64 [n], times f32 [n])
    per row."""

    def __init__(self):
        self.batches: list[list] = []
        self._undo: list = []

    def install(self) -> "Capture":
        real = asr.generate

        def generate(*args, **kwargs):
            out = real(*args, **kwargs)
            rows = []
            for segs in out.segments:
                toks = [s["tokens"] for s in segs]
                tts = [s.get("token_timestamps") for s in segs]
                rows.append((_cat(toks, "int64"),
                             _cat([t for t in tts if t is not None],
                                  "float32")))
            self.batches.append(rows)
            return out

        _replace(asr, "generate", generate, self._undo)
        return self

    def uninstall(self) -> None:
        while self._undo:
            module, name, real = self._undo.pop()
            setattr(module, name, real)


def _cat(parts: list, dtype: str) -> np.ndarray:
    if not parts:
        return np.zeros(0, dtype)
    return np.concatenate([np.asarray(p) for p in parts]).astype(dtype)


@dataclass
class Record:
    name: str
    rows: int
    steps: int = 0
    host_s: float = 0.0
    events: tuple | None = None      # (start, stop) CUDA events


@dataclass
class Spans:
    device: str
    records: list[Record] = field(default_factory=list)
    _undo: list = field(default_factory=list)

    def _timed(self, name: str, real, rows_of, steps_of=None,
               sync: bool = False, events: bool = True):
        cuda = self.device == "cuda"

        def wrapper(*args, **kwargs):
            rec = Record(name, rows_of(args, kwargs),
                         steps_of(args, kwargs) if steps_of else 0)
            with torch.profiler.record_function("pb." + name):
                if sync and cuda:
                    torch.cuda.synchronize()
                if events and cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                t0 = time.perf_counter()
                try:
                    return real(*args, **kwargs)
                finally:
                    if events and cuda:
                        stop.record()
                        rec.events = (start, stop)
                    if sync and cuda:
                        torch.cuda.synchronize()
                    rec.host_s = time.perf_counter() - t0
                    self.records.append(rec)
        return wrapper

    def install(self) -> "Spans":
        def first_rows(args, kwargs):
            return int(args[0].shape[0])

        _replace(asr, "extract_features", self._timed(
            "mel", asr.extract_features, first_rows), self._undo)
        _replace(longform, "encode", self._timed(
            "encode", longform.encode,
            lambda a, k: int(a[2].shape[0])), self._undo)
        _replace(longform, "greedy_decode", self._timed(
            "decode", longform.greedy_decode,
            lambda a, k: int(a[4].shape[0]),
            lambda a, k: int(k["max_new_tokens"]), sync=True,
            events=False), self._undo)
        _replace(longform, "attention_to_jump_times", self._timed(
            "align_tail", longform.attention_to_jump_times,
            first_rows), self._undo)
        _replace(asr, "decode_asr", self._timed(
            "stitch", asr.decode_asr, lambda a, k: len(a[1]),
            events=False), self._undo)
        _replace(asr, "adjust_pauses", self._timed(
            "stitch", asr.adjust_pauses, lambda a, k: 0,
            events=False), self._undo)
        return self

    def uninstall(self) -> None:
        while self._undo:
            module, name, real = self._undo.pop()
            setattr(module, name, real)

    def of(self, name: str) -> list[Record]:
        return [r for r in self.records if r.name == name]

    def device_s(self, name: str) -> float | None:
        """Seconds on the device between each span's events, summed (after
        the window's final sync); None without events."""
        recs = self.of(name)
        if not recs or any(r.events is None for r in recs):
            return None
        return sum(a.elapsed_time(b) for a, b in
                   (r.events for r in recs)) / 1e3
