"""Single-stream LIVE transcription session (incremental feed); port of
crisperwhisper_tpu/serving/live.py, statement for statement.

The chunked pipeline (pipeline/asr.py) and the cross-stream batcher
(serving/batcher.py) both consume COMPLETE audio. A live caption source
(microphone, RTP leg) produces samples incrementally; this session
mirrors `chunk_iter`'s windowing (hf chunk_iter :61-84 — step =
chunk - left - right strides, first chunk no left stride, last no right)
over an APPEND-ONLY buffer, decodes each 30 s window the moment its
samples exist (one window, batch 1: under quantize="serving" with
b1_decode_kernel, the whole-step kernel's b1 mode), and re-stitches the
prefix after every chunk.

Equivalence contract (test-pinned): `finish()` returns exactly what
`pipe(whole_audio)` would — the incremental chunk boundaries are the
same as chunk_iter's, and a window decodes the same alone as in a padded
batch (tests/test_torch_serving.py pins both), so feeding the same audio
in any piece sizes yields the identical final transcript and word
timestamps.

Partial stability matches the batcher's contract: every delivered word
except the trailing (open) one survives verbatim into the final result
(serving/batcher.py submit docstring).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from ..pipeline.asr import ASRPipeline, Chunk


class LiveSession:
    """Incremental single-stream transcription over one ASRPipeline.

    Usage:
        sess = LiveSession(pipe, on_partial=render)
        for block in microphone():      # any block sizes, 16 kHz f32
            sess.feed(block)
        final = sess.finish()

    NOT thread-safe: one producer drives feed()/finish() (wrap with the
    StreamingBatcher for concurrent streams).
    """

    def __init__(self, pipeline: ASRPipeline,
                 return_timestamps: Any = "word",
                 adjust_pauses_threshold: float | None = None,
                 on_partial: Callable[[dict], None] | None = None):
        self.pipeline = pipeline
        self.return_timestamps = return_timestamps
        self.adjust_pauses_threshold = adjust_pauses_threshold
        self.on_partial = on_partial
        cfg = pipeline.feat_cfg
        sr = cfg.sampling_rate
        sl_s, sr_s = pipeline.pipe_opts.strides()
        self._n_samples = int(round(pipeline.pipe_opts.chunk_length_s * sr))
        self._stride_left = int(round(sl_s * sr))
        self._stride_right = int(round(sr_s * sr))
        self._step = (self._n_samples - self._stride_left
                      - self._stride_right)
        if self._step <= 0:
            raise ValueError("strides leave no chunk step")
        self._buf: list[np.ndarray] = []
        self._buf_len = 0
        self._next_start = 0            # sample offset of the next chunk
        self._outputs: list[dict] = []  # per-chunk model outputs, in order
        self._finished = False
        self._final: dict | None = None

    # ------------------------------------------------------------------
    def feed(self, samples: np.ndarray) -> dict | None:
        """Append audio; decode every chunk window that became complete.
        Returns the newest partial result (or None if no new chunk)."""
        if self._finished:
            raise RuntimeError("session already finished")
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size:
            self._buf.append(samples)
            self._buf_len += samples.size
        partial = None
        # a NON-final chunk is decodable once a full window exists AND we
        # know it is not the last (more samples follow its window end —
        # chunk_iter marks is_last by start + n_samples >= len, which an
        # open stream can only decide once the buffer moved past it)
        while self._buf_len > self._next_start + self._n_samples:
            partial = self._decode_chunk(is_last=False)
        return partial

    def finish(self) -> dict:
        """Flush the tail chunk(s) and return the final result —
        identical to running the whole audio through the pipeline."""
        if self._finished:
            return self._final  # type: ignore[return-value]
        # remaining chunks incl. the final one (chunk_iter: emit while
        # start < len and the chunk has content beyond its left stride)
        while (self._next_start < self._buf_len
               and self._buf_len - self._next_start
               > (self._stride_left if self._next_start else 0)):
            last = self._next_start + self._n_samples >= self._buf_len
            self._decode_chunk(is_last=last)
            if last:
                break
        self._finished = True
        self._final = self._stitch(final=True)
        return self._final

    # ------------------------------------------------------------------
    def _audio(self, start: int, end: int) -> np.ndarray:
        flat = (np.concatenate(self._buf) if len(self._buf) != 1
                else self._buf[0])
        if len(self._buf) > 1:          # keep the flattened form around
            self._buf = [flat]
        return flat[start:min(end, self._buf_len)]

    def _decode_chunk(self, is_last: bool) -> dict | None:
        start = self._next_start
        samples = self._audio(start, start + self._n_samples)
        stride_left = 0 if start == 0 else self._stride_left
        stride_right = 0 if is_last else self._stride_right
        chunk = Chunk(0, samples,
                      (samples.shape[0], stride_left, stride_right),
                      is_last)
        out = self.pipeline._run_chunks([chunk], self._n_samples,
                                        self.return_timestamps)[0]
        sr = self.pipeline.feat_cfg.sampling_rate
        cl, left, right = out["stride"]
        out = dict(out)
        out["stride"] = (cl / sr, left / sr, right / sr)
        self._outputs.append(out)
        self._next_start = start + self._step
        if is_last:
            return None
        partial = self._stitch(final=False)
        if partial is not None and self.on_partial is not None:
            try:
                self.on_partial(partial)
            except Exception:
                pass                     # client callbacks never kill us
        return partial

    def _stitch(self, final: bool) -> dict:
        from ..pipeline.pauses import adjust_pauses
        from ..tokenizer.stitcher import decode_asr
        if not self._outputs:            # empty / too-short stream
            result = ({"text": "", "chunks": []}
                      if self.return_timestamps else {"text": ""})
            if not final:
                result.update(is_partial=True, n_chunks_done=0)
            return result
        cfg = self.pipeline.feat_cfg
        text, optional = decode_asr(
            self.pipeline.tokenizer, [dict(o) for o in self._outputs],
            return_timestamps=self.return_timestamps,
            return_language=False,
            time_precision=(cfg.chunk_length
                            / self.pipeline.arch.max_source_positions))
        result = {"text": text, **optional}
        if final:
            if (self.adjust_pauses_threshold is not None
                    and self.return_timestamps == "word"):
                result = adjust_pauses(result,
                                       self.adjust_pauses_threshold)
        else:
            result.update(is_partial=True,
                          n_chunks_done=len(self._outputs))
        return result
