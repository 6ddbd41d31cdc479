"""Multi-stream serving batcher over one ASRPipeline (port of
crisperwhisper_tpu/serving/batcher.py, statement for statement).

The reference's only batching is the DataLoader collation inside one
pipeline call (SURVEY.md §2.6). Here N concurrent audio streams share the
card: every stream's 30 s chunk windows land in one global queue, a
worker drains it into device batches of at most batch_size windows
(``ASRPipeline._run_chunks`` pads a lone short group to the next power of
2, so a warmed pipeline meets only shapes it has seen), and each stream's
result is stitched and delivered when its chunks are complete.

Thread model: callers submit from any thread; a single worker thread owns
the card (it alone calls ``_run_chunks``, whose ``torch.inference_mode``
is per thread and so stays on that method; the thread's current CUDA
device and stream are its own, the first device and its default stream);
a separate finalizer thread runs the host-side stitching and tokenizer
work, so it overlaps the next device batch instead of stalling the
device's owner. A failure in the worker fails the streams of its batch:
their ``result()`` raises it.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..pipeline.asr import ASRPipeline, Chunk, chunk_iter


@dataclass
class _Request:
    request_id: int
    n_chunks: int
    return_timestamps: Any
    adjust_pauses_threshold: float | None
    on_partial: Any = None
    outputs: list = field(default_factory=list)
    emitted_contig: int = 0          # chunks covered by the last partial
    partial: dict | None = None      # latest partial result
    done: threading.Event = field(default_factory=threading.Event)
    result: dict | None = None
    error: Exception | None = None


class StreamHandle:
    """Future-like handle for one submitted stream."""

    def __init__(self, req: _Request):
        self._req = req

    def result(self, timeout: float | None = None) -> dict:
        if not self._req.done.wait(timeout):
            raise TimeoutError("transcription not finished")
        if self._req.error is not None:
            raise self._req.error
        return self._req.result  # type: ignore[return-value]

    def done(self) -> bool:
        return self._req.done.is_set()

    def partial(self) -> dict | None:
        """Latest live partial result ({"text", "chunks", "is_partial":
        True, "n_chunks_done", "n_chunks"}), or None before the first
        chunk completes. See submit(on_partial=...) for the push form
        and the stability contract."""
        return self._req.partial


class StreamingBatcher:
    """Cross-stream chunk batcher over one ASRPipeline."""

    def __init__(self, pipeline: ASRPipeline,
                 max_batch_delay_s: float = 0.05,
                 warmup: bool = False):
        self.pipeline = pipeline
        self.max_batch_delay_s = max_batch_delay_s
        if warmup:
            # run every power-of-2 batch size BEFORE accepting traffic:
            # the kernel build, cuBLAS's workspaces and the allocator's
            # pool for each batch shape are paid here, not mid-stream
            pipeline.warmup()
        self._queue: queue.Queue = queue.Queue()
        self._requests: dict[int, _Request] = {}
        self._lock = threading.Lock()
        self._next_id = 0
        self._stop = threading.Event()
        # host-side finalization runs off the device thread; ONE thread,
        # so tokenizer state is never touched concurrently. Queues exist
        # BEFORE any thread starts — the worker may finish a batch and
        # enqueue finalization work immediately.
        self._finalize_queue: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._finalizer = threading.Thread(target=self._finalize_loop,
                                           daemon=True)
        self._finalizer.start()

    # ------------------------------------------------------------------
    def submit(self, audio: Any, return_timestamps: Any = "word",
               adjust_pauses_threshold: float | None = None,
               on_partial: Any = None) -> StreamHandle:
        """Submit one audio stream; returns a future-like StreamHandle.

        on_partial: optional callable(dict) — LIVE incremental results
        (live word-level timestamps): each time the
        stream's contiguous chunk prefix grows, the prefix is stitched
        and delivered as {"text", "chunks", "is_partial": True,
        "n_chunks_done", "n_chunks"} (also readable by polling
        StreamHandle.partial(); pass on_partial=True for poll-only
        tracking without a callback). In word-timestamp mode partials are
        PREFIX-STABLE EXCEPT THE LAST WORD: the stitcher cuts each
        non-final chunk at (chunk_end - right_stride), so every delivered
        word but the final one is outside later chunks' overlap zones and
        survives into the final result verbatim; the trailing word is
        OPEN — the next chunk's tokens may extend it or move its end time
        (measured: boundary-word merge in the stitcher). Live-captioning
        clients should render the last word as tentative. Runs on the
        host-finalizer thread — callbacks must not block."""
        from ..audio.io import load_audio
        cfg = self.pipeline.feat_cfg
        sr = cfg.sampling_rate
        sl_s, sr_s = self.pipeline.pipe_opts.strides()
        n_samples = int(round(self.pipeline.pipe_opts.chunk_length_s * sr))
        samples = load_audio(audio, sr)
        chunks = list(chunk_iter(samples, 0, n_samples,
                                 int(round(sl_s * sr)),
                                 int(round(sr_s * sr))))
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            req = _Request(rid, len(chunks), return_timestamps,
                           adjust_pauses_threshold, on_partial=on_partial)
            if chunks:
                self._requests[rid] = req
        if not chunks:                       # empty/too-short audio
            req.result = {"text": "", "chunks": []} \
                if return_timestamps else {"text": ""}
            req.done.set()
            return StreamHandle(req)
        for pos, c in enumerate(chunks):
            self._queue.put((rid, pos, c))
        return StreamHandle(req)

    def shutdown(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5)
        self._finalizer.join(timeout=5)
        # the worker can enqueue finalization work after the finalizer's
        # own drain ran; flush anything left so no future is dropped
        while True:
            try:
                kind, req = self._finalize_queue.get_nowait()
            except queue.Empty:
                break
            if kind == "final":
                self._finalize(req)

    # ------------------------------------------------------------------
    def _run(self) -> None:
        bs = self.pipeline.pipe_opts.batch_size
        n_samples = int(round(self.pipeline.pipe_opts.chunk_length_s
                              * self.pipeline.feat_cfg.sampling_rate))
        while not self._stop.is_set():
            batch: list[tuple[int, int, Chunk]] = []
            try:
                batch.append(self._queue.get(timeout=0.1))
            except queue.Empty:
                continue
            deadline = time.monotonic() + self.max_batch_delay_s
            while len(batch) < bs:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._process(batch, n_samples)
            except Exception as e:                     # fail the streams
                with self._lock:
                    for rid, _, _ in batch:
                        req = self._requests.get(rid)
                        if req is not None and not req.done.is_set():
                            req.error = e
                            req.done.set()

    def _process(self, batch, n_samples) -> None:
        want_words = any(r.return_timestamps == "word"
                         for rid, _, _ in batch
                         for r in [self._requests[rid]])
        chunks = [c for _, _, c in batch]
        outs = self.pipeline._run_chunks(
            chunks, n_samples, "word" if want_words else True)
        finished: list[_Request] = []
        partials: list[_Request] = []
        with self._lock:
            for (rid, pos, c), out in zip(batch, outs):
                req = self._requests[rid]
                req.outputs.append((pos, c, out))
                if len(req.outputs) == req.n_chunks:
                    finished.append(req)
                    del self._requests[rid]
            # live partials: emit when a stream's CONTIGUOUS chunk prefix
            # grew and it is not finishing this batch anyway (the final
            # delivery covers the last growth)
            touched: dict[int, _Request] = {}
            for rid, _, _ in batch:
                r = self._requests.get(rid)     # finished rids are gone
                if r is not None:
                    touched[rid] = r
            for req in touched.values():
                if not req.on_partial:   # None/False: no partial tracking
                    continue
                have = {pos for pos, _, _ in req.outputs}
                contig = 0
                while contig in have:
                    contig += 1
                if contig > req.emitted_contig:
                    req.emitted_contig = contig
                    partials.append(req)
        for req in partials:
            self._finalize_queue.put(("partial", req))
        for req in finished:
            self._finalize_queue.put(("final", req))

    def _finalize_loop(self) -> None:
        while not self._stop.is_set():
            try:
                kind, req = self._finalize_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if kind == "partial":
                self._finalize_partial(req)
            else:
                self._finalize(req)
        # drain on stop: batches whose device work completed must still
        # deliver their futures, else callers blocked in result() hang
        while True:
            try:
                kind, req = self._finalize_queue.get_nowait()
            except queue.Empty:
                break
            if kind == "final":
                self._finalize(req)

    def _finalize_partial(self, req: _Request) -> None:
        """Stitch the stream's contiguous chunk prefix and deliver it as
        a live partial. The last prefix chunk keeps its right stride, so
        the stitcher's time cut excludes the overlap zone — delivered
        words are final (see submit docstring). Errors are swallowed:
        partials are best-effort; the final delivery is authoritative."""
        from ..tokenizer.stitcher import decode_asr
        if req.done.is_set():
            return
        cfg = self.pipeline.feat_cfg
        sr = cfg.sampling_rate
        with self._lock:
            contig = req.emitted_contig
            prefix = sorted((p_o for p_o in req.outputs
                             if p_o[0] < contig), key=lambda x: x[0])
        if not prefix:
            return
        model_outputs = []
        for pos, c, out in prefix:
            cl, left, right = out["stride"]
            out = dict(out)
            out["stride"] = (cl / sr, left / sr, right / sr)
            model_outputs.append(out)
        try:
            text, optional = decode_asr(
                self.pipeline.tokenizer, model_outputs,
                return_timestamps=req.return_timestamps,
                return_language=False,
                time_precision=(cfg.chunk_length
                                / self.pipeline.arch.max_source_positions))
            partial = {"text": text, **optional, "is_partial": True,
                       "n_chunks_done": len(prefix),
                       "n_chunks": req.n_chunks}
        except Exception:
            return
        if req.done.is_set():       # final already delivered — stay quiet
            return
        req.partial = partial
        if callable(req.on_partial):
            try:
                req.on_partial(partial)
            except Exception:
                pass                 # client callback errors never kill us

    def _finalize(self, req: _Request) -> None:
        from ..pipeline.pauses import adjust_pauses
        from ..tokenizer.stitcher import decode_asr
        cfg = self.pipeline.feat_cfg
        sr = cfg.sampling_rate
        model_outputs = []
        for pos, c, out in sorted(req.outputs, key=lambda x: x[0]):
            cl, left, right = out["stride"]
            out = dict(out)
            out["stride"] = (cl / sr, left / sr, right / sr)
            model_outputs.append(out)
        time_precision = cfg.chunk_length / \
            self.pipeline.arch.max_source_positions
        try:
            text, optional = decode_asr(
                self.pipeline.tokenizer, model_outputs,
                return_timestamps=req.return_timestamps,
                return_language=False, time_precision=time_precision)
            result = {"text": text, **optional}
            if (req.adjust_pauses_threshold is not None
                    and req.return_timestamps == "word"):
                result = adjust_pauses(result, req.adjust_pauses_threshold)
            req.result = result
        except Exception as e:
            req.error = e
        req.done.set()
