"""Autoregressive decode loop (greedy or sampled) on the device.

Port of crisperwhisper_tpu/decoding/greedy.py. The reference runs the
whole decode as one ``lax.while_loop``; here it is a Python loop over
steps whose state stays on the device: prompt prefill, logits processing,
sampling, grammar state, alignment capture and EOS bookkeeping. The host
reads one flag per step (have all rows finished?). Each iteration runs
three spans (utils/tracing.py): ``cw.decode.step`` (the model step),
``cw.decode.select`` (processors, token choice and bookkeeping) and
``cw.decode.sync`` (that read); the cache build and the prompt prefill
are ``cw.decode.cache`` and ``cw.decode.prefill``.

The plain one-token step (models/whisper.decode_step) runs as one CUDA
graph a decode where ``step_graph_refusal`` finds nothing against it,
decided once a decode from what the inputs show: CUDA tensors, no
speech LM, no whole-step kernel, no tensor-parallel shard, and kernel 9
taking both attention halves of every layer. The first step runs
eagerly on a side stream (the warm-up of PyTorch's capture notes); the
graph is then captured once, in ``cw.decode.capture``, into this
thread's pool, and replayed for every later step, the token ids and the
position (which kernel 9 and the ring write read on the device) filled
into two static buffers first: three launches a step where the eager
step launches hundreds. Each ``cw.decode.step`` record counts ``graph``: 1
for a replay, 0 for an eager step. A decode's graph is never replayed
after it returns, so the thread's next capture shares its memory pool
and lets it go.

With ``opts.b1_decode_kernel`` and a quantized serving cache, each step
runs as one whole-step kernel (ops/decode_step.py): ``decode_step_b1`` at
batch 1, ``decode_step_rows`` at 2-8 rows, under the reference's gates
(greedy.py:160-201), which a key mask or a position offset closes;
anything else takes models/whisper.decode_step. The port reads only the
live ring prefix, so it has no staged ring growth.

A speech LM (``models/speech_moe.SpeechMoEArch``), decided
once a decode, runs the same loop and token selection on its own cache
(self K/V only), prefill (the prompt with the audio embeddings spliced
in, ``encoder_out`` being the adapter's output) and one-token step; it
has no alignment rows, no timestamp grammar and no no-speech
probability. While spans record, it records its routing on the device
(``DecodeResult.routing``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..config import GenerationOptions, SpecialTokens, WhisperArch

from ..models import speech_moe
from ..models.whisper import (decode_step, decode_step_multi, init_cache,
                              step_dtype)
from ..ops import decode_step as step_kernel
from ..ops.decode_attention import bind_decode_gemv
from ..parallel.mesh import model_shard
from ..utils import tracing
from ..utils.tracing import trace_span
from .processors import TimestampState, process_scores


@dataclass
class DecodeResult:
    """All [B]-leading outputs of one decode call (device tensors).

    sequences: [B, P + max_new] int32 — prompt + generated, eot-padded.
    num_generated: [B] int32 — generated tokens incl. the final eot.
    sum_logprobs: [B] f32 — sum of chosen-token logprobs (processed
      scores), as consumed by _retrieve_avg_logprobs.
    no_speech_probs: [B] f32 — P(<|nospeech|>) from the raw logits at the
      SOT position (logits_process.py:2063-2121).
    align_probs: [B, A, max_new, K] f32 — alignment-head cross-attention
      rows for the generated query tokens (generation_whisper.py:336-337).
    steps: host int — iterations of the decode loop after the prefill.
    routing: a speech LM's routing record (models/speech_moe
      .RoutingRecord), or None.
    """
    sequences: torch.Tensor
    num_generated: torch.Tensor
    sum_logprobs: torch.Tensor
    no_speech_probs: torch.Tensor
    align_probs: torch.Tensor
    steps: int
    routing: speech_moe.RoutingRecord | None = None


def _no_speech_prob(logits: torch.Tensor, no_speech: int) -> torch.Tensor:
    return torch.exp(logits[:, no_speech] - torch.logsumexp(logits, dim=-1))


def _device(x, dev) -> torch.Tensor | None:
    """A host array or tensor (or None) as a tensor on ``dev``."""
    if x is None:
        return None
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x).to(dev)


def _key_mask(prompt_mask, n_after: int, dev) -> torch.Tensor | None:
    """The self-attention key mask [B, P + n_after]: ``prompt_mask`` over
    the prompt slots, every slot after it attended."""
    if prompt_mask is None:
        return None
    pm = _device(prompt_mask, dev).to(torch.bool)
    return torch.cat([pm, torch.ones((pm.shape[0], n_after),
                                     dtype=torch.bool, device=dev)], 1)


def step_graph_refusal(params, arch, cache, key_mask, kernel5: bool
                       ) -> str | None:
    """Why a decode's one-token step does not run as one CUDA graph, or
    None where it does. The loop's step is always one token a row at one
    position for all rows; it can be captured once where its launches
    take the same arguments at every step with the position held on the
    device: not a speech LM's or the whole-step kernel's (kernel 5) own
    step, no collective (a tensor-parallel tree all-reduces inside the
    step), both attention halves of every layer through kernel 9 (the
    plain attentions slice the ring at the position on the host), on a
    CUDA card."""
    if isinstance(arch, speech_moe.SpeechMoEArch):
        return "a speech LM's step"
    if kernel5:
        return "the whole-step kernel"
    if model_shard(params) is not None:
        return "a tensor-parallel shard"
    dtype = step_dtype(params, cache)
    if (bind_decode_gemv(dtype, cache.self_k, cache.self_v,
                         cache.self_k_scale, cache.self_v_scale,
                         key_mask) is None
            or bind_decode_gemv(dtype, cache.cross_k, cache.cross_v,
                                cache.cross_k_scale,
                                cache.cross_v_scale) is None):
        return "kernel 9 declines the caches"
    if not cache.self_k.is_cuda:
        return "not on a CUDA card"
    return None


_CAPTURE = threading.local()        # .held: {device index: _CaptureContext}


class _CaptureContext:
    """A thread's side stream on one device and its last captured graph.
    Each capture shares the memory pool of the graph before it (``pool()``,
    PyTorch's way to share one), which this holds until then: a decode's
    graph is never replayed after its decode returns, so the next
    capture reuses its memory. The thread's own stream and pool keep two
    threads' decodes apart, and one stream keeps one cuBLAS workspace."""

    def __init__(self) -> None:
        self.stream = torch.cuda.Stream()
        self.last: torch.cuda.CUDAGraph | None = None

    @classmethod
    def of(cls, dev: torch.device) -> "_CaptureContext":
        """This thread's context on ``dev``, made at its first graphed
        decode there."""
        held = getattr(_CAPTURE, "held", None)
        if held is None:
            held = _CAPTURE.held = {}
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        if index not in held:
            with torch.cuda.device(index):
                held[index] = cls()
        return held[index]


class _StepGraph:
    """One decode's plain one-token step as a CUDA graph: the step reads
    its token ids and position from two static buffers. The first call
    runs it eagerly on the side stream (the warm-up, whose results are
    the step's); ``capture`` records it once; each later call replays it
    on the current stream and returns the graph's static outputs, which
    the next replay overwrites."""

    def __init__(self, step, params, arch, cache, align_sel, b: int,
                 dev: torch.device):
        self.step = step
        self.args = (params, arch)
        self.cache, self.align_sel = cache, align_sel
        self.tokens = torch.empty((b,), dtype=torch.long, device=dev)
        self.position = torch.zeros((), dtype=torch.int32, device=dev)
        self.context = _CaptureContext.of(dev)
        self.graph = self.out = None

    def _run(self):
        logits, _, align = self.step(*self.args, self.tokens, self.position,
                                     self.cache, align_sel=self.align_sel)
        return logits, align

    def __call__(self, tokens: torch.Tensor, t: int):
        self.tokens.copy_(tokens)
        self.position.fill_(t)
        if self.graph is not None:
            self.graph.replay()
            return self.out
        main = torch.cuda.current_stream(self.tokens.device)
        side = self.context.stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._run()
        main.wait_stream(side)
        return out

    def capture(self) -> None:
        """Record the step (nothing runs) on the side stream, into the
        pool of the thread's last graph, which it then lets go."""
        last = self.context.last
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.context.stream):
            graph.capture_begin(pool=None if last is None else last.pool(),
                                capture_error_mode="thread_local")
            try:
                self.out = self._run()
            finally:
                graph.capture_end()
        self.graph = self.context.last = graph


@torch.inference_mode()
def greedy_decode(params, arch: WhisperArch, specials: SpecialTokens,
                  opts: GenerationOptions, encoder_out: torch.Tensor,
                  prompt: torch.Tensor, *, max_new_tokens: int,
                  suppress_mask: torch.Tensor | None = None,
                  begin_suppress_mask: torch.Tensor | None = None,
                  align_sel: np.ndarray | None = None,
                  return_timestamps: bool = True,
                  temperature: float = 0.0,
                  generator: torch.Generator | None = None,
                  sot_position: int = 0,
                  cross_cache_dtype: str | None = None,
                  self_cache_dtype: str | None = None,
                  prompt_mask: np.ndarray | torch.Tensor | None = None,
                  pos_offset: np.ndarray | torch.Tensor | None = None
                  ) -> DecodeResult:
    """Decode a batch against precomputed encoder states.

    prompt: [B, P] int forced prefix (e.g. [sot, lang, task]); a
      condition-on-prev prompt is left-padded to P with ``prompt_mask``
      [B, P] bool False on the pads (the decoder attention mask).
    pos_offset: int32 [B], each row's left-pad count: shifts the learned
      position lookup only, so real tokens take positions 0..len-1 (the
      dynamic condition-on-prev mode); None keeps pads on positions.
    temperature: 0 => argmax; > 0 => categorical sampling from
      softmax(scores / temperature), drawn from ``generator`` (a
      torch.Generator on the device; the fallback ladder re-invokes this
      with higher temperatures).
    cross_cache_dtype/self_cache_dtype: None, "int8" or "int4" — the
      quantized cache halves of models/whisper.init_cache.
    """
    b, p = prompt.shape
    dev = encoder_out.device
    k_frames = encoder_out.shape[1]
    t_total = p + max_new_tokens
    if t_total > arch.max_target_positions:
        raise ValueError(f"prompt {p} + max_new {max_new_tokens} exceeds "
                         f"max_target_positions {arch.max_target_positions}")
    n_align = align_sel.shape[-1] if align_sel is not None else 1
    eot = specials.eot

    speech_lm = isinstance(arch, speech_moe.SpeechMoEArch)
    with trace_span("cw.decode.cache", rows=b):
        if speech_lm:
            cache = speech_moe.init_cache(arch, b, t_total, encoder_out.dtype,
                                          dev, recording=tracing.active())
        else:
            cache = init_cache(params, arch, encoder_out, cache_len=t_total,
                               cross_dtype=cross_cache_dtype,
                               self_dtype=self_cache_dtype)
    if speech_lm:
        audio_at = speech_moe.audio_offset(specials, encoder_out.shape[1])
        if tuple(prompt[0].tolist()) != specials.prompt:
            raise ValueError("a speech LM decodes its own window prompt")
        sot_position = -1                  # no no-speech probability
        return_timestamps = False          # nor timestamp tokens
    prompt = prompt.to(device=dev, dtype=torch.long)
    tokens = torch.cat([prompt, torch.full((b, max_new_tokens), eot,
                                           dtype=torch.long, device=dev)], 1)
    key_mask = _key_mask(prompt_mask, max_new_tokens, dev)
    pos_offset = _device(pos_offset, dev)

    # block prefill of prompt[:, :P-1]; the no-speech capture happens here
    # when the SOT position falls inside the prefill block
    no_speech = torch.zeros((b,), dtype=torch.float32, device=dev)
    t = 0
    if p > 1:
        with trace_span("cw.decode.prefill", rows=b, tokens=p - 1):
            if speech_lm:
                cache = speech_moe.prefill(params, arch, prompt[:, :p - 1],
                                           encoder_out, audio_at, cache)
            else:
                prefill_logits, cache, _ = decode_step_multi(
                    params, arch, prompt[:, :p - 1], 0, cache,
                    key_mask=key_mask, pos_offset=pos_offset)
                if sot_position <= p - 2:
                    no_speech = _no_speech_prob(
                        prefill_logits[:, sot_position], specials.no_speech)
        t = p - 1

    state = TimestampState.init(b, dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    sum_logprobs = torch.zeros((b,), dtype=torch.float32, device=dev)
    align_buf = torch.zeros((b, n_align, max_new_tokens, k_frames),
                            dtype=torch.float32, device=dev)

    # the whole-step kernel, decided once per decode as in the reference
    plain = key_mask is None and pos_offset is None and not speech_lm
    use_b1_kernel = (opts.b1_decode_kernel and b == 1 and plain
                     and step_kernel.supported(params, arch, cache, key_mask,
                                               1, 0, prompt[:, 0]))
    use_rows_kernel = (opts.b1_decode_kernel and not use_b1_kernel and plain
                       and step_kernel.supported_rows(params, arch, cache,
                                                      key_mask, 0,
                                                      prompt[:, 0]))
    if speech_lm:
        def step(params, arch, tokens, t, cache, align_sel=None):
            return (speech_moe.decode_step(params, arch, tokens, t, cache),
                    cache, None)
    elif use_b1_kernel or use_rows_kernel:
        step = (step_kernel.decode_step_b1 if use_b1_kernel
                else step_kernel.decode_step_rows)
    else:
        def step(*a, **kw):
            return decode_step(*a, key_mask=key_mask, pos_offset=pos_offset,
                               **kw)
    graphed = None
    if step_graph_refusal(params, arch, cache, key_mask,
                          use_b1_kernel or use_rows_kernel) is None:
        graphed = _StepGraph(step, params, arch, cache, align_sel, b, dev)

    # whether every row has finished is read after each step (before the
    # first, no row has)
    while t < t_total - 1:
        if graphed is not None and graphed.graph is None and t >= p:
            with trace_span("cw.decode.capture", rows=b):
                graphed.capture()
        replay = graphed is not None and graphed.graph is not None
        with trace_span("cw.decode.step", graph=int(replay)):
            if graphed is None:
                logits, cache, align = step(params, arch, tokens[:, t], t,
                                            cache, align_sel=align_sel)
            else:
                logits, align = graphed(tokens[:, t], t)
        with trace_span("cw.decode.select"):
            if t >= p and align is not None:
                # record alignment rows for generated-query steps
                slot = align_buf[:, :, t - p]
                slot.copy_(torch.where(finished[:, None, None], slot, align))
            if t == sot_position:
                # no-speech prob from the RAW logits of the step whose input
                # is <|startoftranscript|> (logits_process.py:2099-2105)
                no_speech = _no_speech_prob(logits, specials.no_speech)

            scores = process_scores(logits, state, specials, opts,
                                    suppress_mask, begin_suppress_mask,
                                    return_timestamps)
            is_sampling_step = t >= p - 1
            if not is_sampling_step:
                next_tok = tokens[:, t + 1]             # forced prompt feed
            elif temperature > 0:
                probs = torch.softmax(scores / max(temperature, 1e-6), dim=-1)
                next_tok = torch.multinomial(probs, 1,
                                             generator=generator)[:, 0]
            else:
                next_tok = scores.argmax(dim=-1)
            next_tok = torch.where(finished, eot, next_tok)

            if is_sampling_step:
                active = ~finished
                chosen_lp = (scores.gather(1, next_tok[:, None])[:, 0]
                             - torch.logsumexp(scores, dim=-1))
                sum_logprobs += torch.where(active, chosen_lp, 0.0)
                state = state.update(next_tok, specials.timestamp_begin) \
                    .where(active, state)
                finished = finished | (active & (next_tok == eot))
            tokens[:, t + 1] = next_tok
        t += 1
        with trace_span("cw.decode.sync"):
            done = bool(finished.all())
        if done:
            break

    return DecodeResult(sequences=tokens.to(torch.int32),
                        num_generated=state.num_generated,
                        sum_logprobs=sum_logprobs,
                        no_speech_probs=no_speech,
                        align_probs=align_buf,
                        steps=t - p + 1,
                        routing=cache.routing if speech_lm else None)
