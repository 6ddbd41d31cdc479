"""Short-form generation and the init-token prompt of a decode batch.

Port of crisperwhisper_tpu/decoding/generate.py. ``build_prompt`` is the
reference's host-side numpy, the code unchanged. ``generate_short_form``
is the reference model's ``generate(input_features,
return_timestamps=True, return_token_timestamps=True)`` on <= 30 s
windows: encode (the encoder-attention kernel on the card), one greedy or
sampled decode (decoding/greedy.py), then the token timestamps from the
alignment heads (ops/alignment.attention_to_jump_times: the align-prep
and DTW kernels on the card). The pipeline's own path is the seek loop
(decoding/longform.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..config import GenerationOptions, SpecialTokens, WhisperArch

from ..models.whisper import alignment_selector, encode
from ..ops.alignment import attention_to_jump_times
from .greedy import greedy_decode
from .processors import suppress_tokens_mask


@dataclass
class ShortFormOutput:
    """Host-side result of one short-form generate call."""
    sequences: np.ndarray           # [B, P+max_new] int32, eot-padded
    num_generated: np.ndarray       # [B]
    token_timestamps: np.ndarray    # [B, P+max_new] f32 seconds
    sum_logprobs: np.ndarray        # [B]
    no_speech_probs: np.ndarray     # [B]


def build_prompt(specials: SpecialTokens, batch: int,
                 language_token: int | None = None,
                 task_token: int | None = None,
                 return_timestamps: bool = True,
                 forced_tokens: tuple[int | None, ...] | None = None
                 ) -> np.ndarray:
    """Init tokens of a decode batch (hf generation_whisper.py:1467-1620):
    [sot, (lang), (task), (<|notimestamps|> when timestamps off)].

    forced_tokens: values of a legacy `forced_decoder_ids` config
    (positions 1..N). Consumed only when NEITHER a language token nor a
    task token is pinned — the reference silently ignores the legacy
    attribute when the modern `language`/`task` flags are set
    (:1503-1506). A pinned language REPLACES slot 1 rather than
    appending (:1578-1584); a pinned task is appended (:1595-1597 —
    replace_or_add's replace branch discards its result, so the
    reference's net effect is the append).

    language_token may also be a per-row sequence of length `batch`
    (the reference's generate(language=[...]) list form,
    :1544-1560) — every row shares the same prompt structure, so the
    static width is preserved."""
    if isinstance(language_token, (list, tuple, np.ndarray)):
        if len(language_token) != batch:
            raise ValueError(
                "When passing a list of languages, the length of the list "
                f"must match the batch size. Expected length of {batch}, "
                f"but got {len(language_token)} languages.")
        return np.concatenate(
            [build_prompt(specials, 1, int(lt), task_token,
                          return_timestamps, forced_tokens)
             for lt in language_token], axis=0)
    toks: list[int | None] = [specials.sot]
    if language_token is None and task_token is None and forced_tokens:
        toks.extend(forced_tokens)
    if language_token is not None:
        if len(toks) > 1:
            toks[1] = language_token
        else:
            toks.append(language_token)
    task_ids = tuple(t for t in (specials.transcribe, specials.translate)
                     if t is not None)
    if task_token is not None:
        toks.append(task_token)
    elif language_token is not None:
        if not any(t in task_ids for t in toks):
            toks.append(specials.transcribe)
    if not return_timestamps and toks[-1] != specials.no_timestamps:
        toks.append(specials.no_timestamps)
    elif return_timestamps and toks[-1] == specials.no_timestamps:
        toks = toks[:-1]
    toks = [t for t in toks if t is not None]
    return np.tile(np.asarray(toks, np.int32), (batch, 1))


@torch.inference_mode()
def generate_short_form(params: Any, arch: WhisperArch,
                        specials: SpecialTokens, opts: GenerationOptions,
                        input_features: torch.Tensor,
                        prompt: np.ndarray | None = None,
                        max_new_tokens: int | None = None,
                        num_frames: np.ndarray | None = None,
                        temperature: float = 0.0,
                        generator: torch.Generator | None = None,
                        compute_timestamps: bool | None = None
                        ) -> ShortFormOutput:
    """Run one batched short-form generation (reference
    generate.py:91-169) on the device of ``params``.

    input_features: [B, n_mels, 3000] log-mel, moved to that device.
    num_frames: optional [B] true mel-frame counts (< 3000 for padded
      tails); crops the DTW key axis to num_frames // 2 like
      generation_whisper.py:313-332.
    generator: a torch.Generator on that device for temperature > 0.
    """
    dev = params["decoder"]["tok_emb"].device
    feats = torch.as_tensor(input_features, device=dev)
    b = feats.shape[0]
    if prompt is None:
        prompt = build_prompt(specials, b,
                              return_timestamps=opts.return_timestamps)
    p = prompt.shape[1]
    max_new = max_new_tokens or min(opts.max_new_tokens,
                                    arch.max_target_positions - p)
    if compute_timestamps is None:
        compute_timestamps = (opts.return_token_timestamps
                              and len(opts.alignment_heads) > 0)

    suppress = (torch.from_numpy(suppress_tokens_mask(
        arch.vocab_size, opts.suppress_tokens)).to(dev)
        if opts.suppress_tokens else None)
    begin_suppress = (torch.from_numpy(suppress_tokens_mask(
        arch.vocab_size, opts.begin_suppress_tokens)).to(dev)
        if opts.begin_suppress_tokens else None)
    align_sel = (alignment_selector(arch, opts.alignment_heads)
                 if compute_timestamps else None)

    encoder_out = encode(params, arch, feats)
    result = greedy_decode(
        params, arch, specials, opts, encoder_out, torch.as_tensor(prompt),
        max_new_tokens=max_new, suppress_mask=suppress,
        begin_suppress_mask=begin_suppress, align_sel=align_sel,
        return_timestamps=opts.return_timestamps, temperature=temperature,
        generator=generator)

    num_generated = result.num_generated.cpu().numpy()
    sequences = result.sequences.cpu().numpy()

    t_total = sequences.shape[1]
    token_timestamps = np.zeros((b, t_total), np.float32)
    if compute_timestamps:
        # DTW over the rows of the queries g_1..g_{G-1}
        n_tokens = (result.num_generated - 1).clamp_min(0)
        if num_frames is not None:
            n_frames = torch.as_tensor(np.asarray(num_frames) // 2,
                                       dtype=torch.int32)
        else:
            n_frames = torch.full((b,), encoder_out.shape[1],
                                  dtype=torch.int32)
        jumps = attention_to_jump_times(
            result.align_probs, opts.median_filter_width, n_tokens,
            n_frames).cpu().numpy()                         # [B, max_new]
        jump_times = jumps.astype(np.float32) * opts.time_precision
        for i in range(b):
            g = int(num_generated[i])
            rows = max(g - 1, 0)
            if rows == 0:
                continue
            # [0]*P + jump_times (rows) + duplicate last
            # (generation_whisper.py:380-382)
            token_timestamps[i, p:p + rows] = jump_times[i, :rows]
            if p + rows < t_total:
                token_timestamps[i, p + rows] = jump_times[i, rows - 1]

    return ShortFormOutput(
        sequences=sequences,
        num_generated=num_generated,
        token_timestamps=token_timestamps,
        sum_logprobs=result.sum_logprobs.cpu().numpy(),
        no_speech_probs=result.no_speech_probs.cpu().numpy(),
    )
