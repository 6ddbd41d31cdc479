"""Chunked long-form ASR pipeline — the primary serving path.

Port of crisperwhisper_tpu/pipeline/asr.py (hf
pipelines/automatic_speech_recognition.py + ChunkPipeline): overlapping
30 s windows (stride chunk/6 each side, :447-448), batched across chunks
and audios into [B, n_samples] device batches, mel + encode + seek-loop
decode per batch, then the ``decode_asr`` stitcher (the port's copy of
tokenizer/stitcher.py) merges the overlaps and forms the words. An
assistant makes the greedy windows speculative (decoding/assisted.py).

``Chunk``, ``chunk_iter`` and ``specials_from_tokenizer`` are verbatim
copies of the originals, and ``ASRPipeline.warmup`` has the original's
code (tests/test_torch_pipeline.py pins them). Each call's audio and wall
seconds go to ``pipe.meter`` (utils/tracing.RTFMeter, the reference's);
serving/ batches many streams over ``_run_chunks``. Spans
(utils/tracing.py): ``cw.call`` a call (recordings, audio seconds),
``cw.mel`` and ``cw.generate`` each device batch (rows, and the rows that
are real chunks), ``cw.stitch`` the stitching of the call's recordings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import (FeatureConfig, GenerationOptions, PipelineOptions,
                       SpecialTokens, WhisperArch)
from .pauses import adjust_pauses
from ..tokenizer.stitcher import decode_asr
from ..tokenizer.whisper_tokenizer import WhisperTokenizer

from ..audio.io import load_audio
from ..audio.mel import extract_features
from ..decoding.longform import generate
from ..utils.tracing import RTFMeter, trace_span


@dataclass
class Chunk:
    audio_idx: int
    samples: np.ndarray            # raw window (<= n_samples)
    stride: tuple[int, int, int]   # (chunk_samples, left, right) in samples
    is_last: bool


def chunk_iter(audio: np.ndarray, audio_idx: int, n_samples: int,
               stride_left: int, stride_right: int) -> Iterable[Chunk]:
    """Overlapping window generator (hf chunk_iter :61-84): step =
    chunk - left - right; first chunk has no left stride, last no right."""
    inputs_len = audio.shape[0]
    step = n_samples - stride_left - stride_right
    for chunk_start in range(0, inputs_len, step):
        chunk = audio[chunk_start:chunk_start + n_samples]
        _stride_left = 0 if chunk_start == 0 else stride_left
        is_last = chunk_start + n_samples >= inputs_len
        _stride_right = 0 if is_last else stride_right
        if chunk.shape[0] > _stride_left:
            yield Chunk(audio_idx, chunk,
                        (chunk.shape[0], _stride_left, _stride_right),
                        is_last)
        if is_last:
            break


class ASRPipeline:
    """``pipe(audio, return_timestamps="word")``, the equivalent of
    ref:transcribe.py:21-33. ``params`` live on one device; every batch
    runs there, or, on a mesh, on every rank of it.

    On a mesh every rank builds the pipeline and rank 0 is the controller:
    it makes every call (``pipe()``, ``warmup()``, a StreamingBatcher's
    worker), and each of its device batches first goes to the other ranks
    (``broadcast_object_list``: the chunks, the call's options and rank
    0's gen_opts, pipe_opts and detect_language), which run it in
    ``follow()`` until rank 0 calls ``close()``. So every rank enters the
    same collectives with the same batch and options."""

    def __init__(self, params: Any, arch: WhisperArch,
                 tokenizer: WhisperTokenizer,
                 specials: SpecialTokens | None = None,
                 gen_opts: GenerationOptions = GenerationOptions(),
                 pipe_opts: PipelineOptions = PipelineOptions(),
                 feat_cfg: FeatureConfig | None = None,
                 mesh: Any | None = None,
                 assistant: Any | None = None):
        """mesh: optional ("data", "model") mesh (parallel/mesh.make_mesh):
        ``params`` are this rank's tensor-parallel slices
        (parallel/mesh.shard_params; hub.load_pipeline(mesh=...) does it)
        and each chunk batch is split over "data" (reference asr.py:72-99).

        assistant: optional speculative-decoding assistant passed to
        generate(): a (draft_params, draft_arch) pair (e.g.
        decoding.assisted.make_self_draft) or "prompt_lookup". When None,
        gen_opts.prompt_lookup still turns on prompt lookup."""
        self.params = params
        self.arch = arch
        self.tokenizer = tokenizer
        self.specials = specials or specials_from_tokenizer(tokenizer)
        self.gen_opts = gen_opts
        self.pipe_opts = pipe_opts
        self.feat_cfg = feat_cfg or FeatureConfig(
            feature_size=arch.num_mel_bins)
        self.assistant = assistant
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import DATA, axis_sizes
            data = axis_sizes(mesh)[DATA]
            if pipe_opts.batch_size % data:
                raise ValueError(
                    f"batch_size {pipe_opts.batch_size} must be a multiple "
                    f"of the mesh data axis ({data})")
        self.device = params["decoder"]["tok_emb"].device
        self.meter = RTFMeter()
        # auto language detection for multilingual checkpoints when no
        # language is pinned (hf _retrieve_init_tokens :1560-1590)
        self.detect_language = False

    def warmup(self, return_timestamps: str | bool = "word") -> list[int]:
        """Run one batch of silent windows at every batch size that
        ``_run_chunks`` can form (the powers of 2 below batch_size, then
        batch_size) before traffic arrives, and return those sizes. On the
        card, this is where the CUDA kernel library gets built (nvcc on
        the first call of a process), cuBLAS creates its handle and
        workspaces for each batch's shapes, and the caching allocator's
        pool grows to a batch's working set, so that no request pays for
        them. The outputs are discarded."""
        bs = self.pipe_opts.batch_size
        n_samples = int(round(self.pipe_opts.chunk_length_s
                              * self.feat_cfg.sampling_rate))
        sizes, s = [], 1
        while s < bs:
            sizes.append(s)
            s <<= 1
        sizes.append(bs)
        zeros = np.zeros((n_samples,), np.float32)
        for s in sizes:
            chunks = [Chunk(0, zeros, (n_samples, 0, 0), i == s - 1)
                      for i in range(s)]
            self._run_chunks(chunks, n_samples, return_timestamps)
        return sizes

    def __call__(self, inputs: Any, return_timestamps: str | bool | None
                 = None, adjust_pauses_threshold: float | None = None,
                 return_language: bool = False,
                 prompt: Any | None = None):
        """prompt: an optional domain-vocabulary bias for this call, a
        string (tokenized by tokenizer.get_prompt_ids) or an array of
        prompt ids (hf pipeline generate_kwargs={'prompt_ids': ...})."""
        single = not isinstance(inputs, (list, tuple))
        audios = [inputs] if single else list(inputs)
        results = self.transcribe_batch(
            audios,
            return_timestamps=(return_timestamps
                               if return_timestamps is not None
                               else self.pipe_opts.return_timestamps),
            return_language=return_language,
            adjust_pauses_threshold=adjust_pauses_threshold,
            prompt=prompt)
        return results[0] if single else results

    def transcribe_batch(self, audios: Sequence[Any], return_timestamps,
                         return_language=False,
                         adjust_pauses_threshold: float | None = None,
                         prompt: Any | None = None):
        with trace_span("cw.call", recordings=len(audios)) as span:
            cfg = self.feat_cfg
            sr = cfg.sampling_rate
            sl_s, sr_s = self.pipe_opts.strides()
            n_samples = int(round(self.pipe_opts.chunk_length_s * sr))
            stride_left = int(round(sl_s * sr))
            stride_right = int(round(sr_s * sr))

            chunks: list[Chunk] = []
            total_audio_s = 0.0
            for idx, a in enumerate(audios):
                audio = load_audio(a, sr)
                total_audio_s += audio.shape[0] / sr
                chunks.extend(chunk_iter(audio, idx, n_samples, stride_left,
                                         stride_right))
            span.count(audio_s=total_audio_s)

            with self.meter.measure(total_audio_s, "pipeline"):
                chunk_outputs = self._run_chunks(chunks, n_samples,
                                                 return_timestamps,
                                                 prompt=prompt)

            results = []
            time_precision = cfg.chunk_length / self.arch.max_source_positions
            with trace_span("cw.stitch", recordings=len(audios)):
                for idx in range(len(audios)):
                    model_outputs = [co for c, co in zip(chunks,
                                                         chunk_outputs)
                                     if c.audio_idx == idx]
                    # stride samples -> seconds (postprocess :616-623)
                    for out in model_outputs:
                        cl, left, right = out["stride"]
                        out["stride"] = (cl / sr, left / sr, right / sr)
                    text, optional = decode_asr(
                        self.tokenizer, model_outputs,
                        return_timestamps=return_timestamps,
                        return_language=return_language,
                        time_precision=time_precision)
                    result = {"text": text, **optional}
                    if adjust_pauses_threshold is not None and \
                            return_timestamps == "word":
                        result = adjust_pauses(result, adjust_pauses_threshold)
                    results.append(result)
        return results

    @torch.inference_mode()
    def _run_chunks(self, chunks: list[Chunk], n_samples: int,
                    return_timestamps, prompt: Any | None = None
                    ) -> list[dict]:
        """Batch chunk windows into [B, n_samples] device batches and
        decode each with the seek-loop generate; on a mesh, rank 0 sends
        the call to the other ranks first."""
        if self.mesh is not None:
            if dist.get_rank() != 0:
                raise RuntimeError("on a mesh, rank 0 makes the calls; "
                                   "the other ranks run pipe.follow()")
            dist.broadcast_object_list(
                [((chunks, n_samples, return_timestamps, prompt),
                  (self.gen_opts, self.pipe_opts, self.detect_language))],
                src=0)
        return self._decode_chunks(chunks, n_samples, return_timestamps,
                                   prompt)

    def follow(self) -> None:
        """On a mesh rank other than 0: run each batch rank 0 sends, until
        rank 0 calls ``close()``."""
        if self.mesh is None or dist.get_rank() == 0:
            raise RuntimeError("follow() runs on the mesh ranks other "
                               "than 0")
        while True:
            box: list = [None]
            dist.broadcast_object_list(box, src=0)
            if box[0] is None:
                return
            call, (self.gen_opts, self.pipe_opts,
                   self.detect_language) = box[0]
            self._decode_chunks(*call)

    def close(self) -> None:
        """On rank 0 of a mesh: end the other ranks' ``follow()``. Does
        nothing off a mesh."""
        if self.mesh is not None:
            dist.broadcast_object_list([None], src=0)

    @torch.inference_mode()
    def _decode_chunks(self, chunks: list[Chunk], n_samples: int,
                       return_timestamps, prompt: Any | None = None
                       ) -> list[dict]:
        bs = self.pipe_opts.batch_size
        want_words = return_timestamps == "word"
        opts = self.gen_opts
        if not want_words and opts.return_token_timestamps:
            opts = GenerationOptions(
                **{**opts.__dict__, "return_token_timestamps": False})
        if prompt is not None:
            ids = (self.tokenizer.get_prompt_ids(prompt)
                   if isinstance(prompt, str) else np.asarray(prompt))
            opts = GenerationOptions(
                **{**opts.__dict__,
                   "prompt_ids": tuple(int(t) for t in ids)})

        data_shard = None
        if self.mesh is not None:
            from ..parallel.mesh import data_sharding
            data_shard = data_sharding(self.mesh)

        outputs: list[dict] = [None] * len(chunks)  # type: ignore
        for start in range(0, len(chunks), bs):
            group = chunks[start:start + bs]
            # pad the tail group to the full batch (dummy rows dropped
            # below); a single short group rounds up to the next power of
            # 2 instead, bounding the set of batch shapes to log2(bs)
            if len(chunks) > bs:
                gb = bs
            else:
                gb = min(1 << max(len(group) - 1, 0).bit_length(), bs)
            if data_shard is not None:
                # every data rank gets rows (reference asr.py:240-246)
                data = data_shard.axis.size
                gb = -(-gb // data) * data
            batch = np.zeros((gb, n_samples), np.float32)
            num_frames = np.full((gb,), n_samples // self.feat_cfg.hop_length,
                                 np.int64)
            for i, c in enumerate(group):
                batch[i, :len(c.samples)] = c.samples
                num_frames[i] = len(c.samples) // self.feat_cfg.hop_length
            with trace_span("cw.mel", rows=gb):
                feats = extract_features(
                    torch.from_numpy(batch).to(self.device), self.feat_cfg)
            lang_tok = self._language_token()
            assistant = (self.assistant if self.assistant is not None
                         else ("prompt_lookup" if opts.prompt_lookup
                               else None))
            # PipelineOptions.assistant_max_batch: speculate only on
            # batches of at most that many rows (reference asr.py:258-264)
            amb = self.pipe_opts.assistant_max_batch
            if amb is not None and gb > amb:
                assistant = None
            with trace_span("cw.generate", rows=gb, chunks=len(group)):
                gen = generate(self.params, self.arch, self.specials, opts,
                               feats, num_frames=num_frames,
                               language_token=lang_tok,
                               detect_language_first=(self.detect_language
                                                      and lang_tok is None),
                               batch_sharding=data_shard,
                               assistant=assistant)
            for i, c in enumerate(group):
                segs = gen.segments[i]
                toks = (np.concatenate([np.asarray(s["tokens"])
                                        for s in segs])
                        if segs else np.zeros(0, np.int64))
                out = {"tokens": toks[None], "stride": c.stride}
                if want_words:
                    tts = (np.concatenate(
                        [np.asarray(s["token_timestamps"]) for s in segs])
                        if segs else np.zeros(0, np.float32))
                    out["token_timestamps"] = tts[None]
                outputs[start + i] = out
        return outputs

    def _language_token(self) -> int | None:
        if self.gen_opts.language is None:
            return None
        return self.tokenizer.language_token_id(self.gen_opts.language)


def specials_from_tokenizer(tok: WhisperTokenizer) -> SpecialTokens:
    return SpecialTokens(
        eot=tok.eot, sot=tok.sot, translate=tok.translate,
        transcribe=tok.transcribe, sot_prev=tok.sot_prev,
        no_speech=tok.no_speech, no_timestamps=tok.no_timestamps,
        timestamp_begin=tok.timestamp_begin,
        language_begin=tok.sot + 1)
