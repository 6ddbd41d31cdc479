"""Sequential seek-loop generation with temperature fallback.

Port of crisperwhisper_tpu/decoding/longform.py (hf generation_whisper.py
:796-914 seek loop, :981-1127 fallback ladder). The device work per
window batch is one encode, one decode and one alignment pass; per-row
bookkeeping (segments, seek advance, fallback gates) runs on small host
arrays after ONE read-back per window batch.

Batch shrink (hf _maybe_reduce_batch :1837-1851) keeps the reference's
power-of-2 compaction: finished rows drop out and the live rows re-pack
into the next power-of-2 bucket, so a batch takes at most log2(B) shapes.

Quantized caches (``kv_cache_int8``/``int4``, ``self_kv_cache_int8``/
``int4``) map to init_cache's cache dtypes as in the reference
(longform.py:42-51). Windows at temperature 0 run beam search
(decoding/beam.py) when ``opts.num_beams`` > 1, else the speculative path
(decoding/assisted.py) when ``generate`` is given an assistant; the
speculative output is pinned to plain greedy's, so the fallback gates see
the same tokens. ``opts.prompt_ids`` and ``opts.condition_on_prev_tokens``
prefix each window's init tokens with the user prompt or the previous
segments' tokens (hf generation_whisper.py:1875-1943).

Spans (utils/tracing.py): ``cw.seek`` a seek pass (live rows, bucket);
in each window batch ``cw.encode``, ``cw.decode`` (rows, loop steps),
``cw.align_tail`` and ``cw.readback``, the one wait; ``cw.segments`` the
host bookkeeping after it (fallback gates, segment extraction).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import zlib

import numpy as np
import torch
import torch.distributed as dist

from ..config import GenerationOptions, SpecialTokens, WhisperArch

from ..models.whisper import INT4, INT8, alignment_selector, encode
from ..ops.alignment import attention_to_jump_times
from ..utils.tracing import trace_span
from .fallback import need_fallback
from .generate import build_prompt
from .greedy import greedy_decode
from .processors import suppress_tokens_mask
from .segments import pad_segments_to_max_length, retrieve_segment

INPUT_STRIDE = 2                      # conv stem downsample
TIME_PRECISION_FEATURES = 0.01        # seconds per mel frame


@dataclass
class GenerateOutput:
    sequences: np.ndarray                       # [B, L] int64 eot-padded
    token_timestamps: np.ndarray | None         # [B, L] f32 seconds
    segments: list[list[dict[str, Any]]]        # per item


def _kv_dtype(opts: GenerationOptions) -> str | None:
    if opts.kv_cache_int4:
        return INT4
    return INT8 if opts.kv_cache_int8 else None


def _self_kv_dtype(opts: GenerationOptions) -> str | None:
    if opts.self_kv_cache_int4:
        return INT4
    return INT8 if opts.self_kv_cache_int8 else None


def _decode_window(params, arch, specials, opts, segment_features,
                   prompt, max_new, suppress, begin_suppress, align_sel,
                   temperature, generator, dtw_frames, prompt_mask=None,
                   sot_position=0, assistant=None, pos_offset=None,
                   batch_sharding=None):
    """One batched decode of 30 s windows + the alignment pass. Returns
    host arrays: sequences, num_generated, score, is the score
    length-normalized, no_speech, jump_times (seconds, or None without
    alignment heads).

    With ``batch_sharding`` (parallel/mesh.data_sharding) and a row count
    that divides its data axis, this rank decodes only its data rank's
    rows, and the host arrays of every data rank are gathered, so every
    rank returns the whole batch (reference longform.py:256-259); another
    row count runs whole on every data rank. So does a sampled window
    (temperature > 0): every rank then draws the same numbers from the same
    generator state (``generate`` gives every rank rank 0's), as one
    process would. On a mesh the ranks then check that they hold the same
    tokens (``_check_agreement``)."""
    rows = segment_features.shape[0]
    axis = batch_sharding.axis if batch_sharding is not None else None
    if (axis is None or axis.size == 1 or rows % axis.size
            or temperature > 0):
        out = _decode_rows(params, arch, specials, opts, segment_features,
                           prompt, max_new, suppress, begin_suppress,
                           align_sel, temperature, generator, dtw_frames,
                           prompt_mask, sot_position, assistant, pos_offset)
    else:
        k = rows // axis.size
        mine = slice(axis.index * k, (axis.index + 1) * k)

        def part(x):
            return None if x is None else x[mine]

        local = _decode_rows(params, arch, specials, opts,
                             segment_features[mine], prompt[mine], max_new,
                             suppress, begin_suppress, align_sel, temperature,
                             generator, dtw_frames[mine], part(prompt_mask),
                             sot_position, assistant, part(pos_offset))
        out = _gather_rows(local, axis, specials.eot)
    if batch_sharding is not None:
        _check_agreement(out, segment_features.device)
    return out


def _check_agreement(out: tuple, device: torch.device) -> None:
    """Every rank of a mesh must hold the same tokens after a window: a
    rank whose logits or draws differed would feed its model group's
    all-reduces other rows and corrupt them without a sign. One all-reduce
    (max) of each rank's checksum of the sequences and their lengths, and
    of its negation; a mismatch is a RuntimeError on every rank."""
    h = zlib.crc32(np.ascontiguousarray(out[0]).tobytes(),
                   zlib.crc32(np.ascontiguousarray(out[1]).tobytes()))
    v = torch.tensor([h, -h], dtype=torch.int64, device=device)
    dist.all_reduce(v, op=dist.ReduceOp.MAX)
    if int(v[0]) != -int(v[1]):
        raise RuntimeError("the ranks of the mesh decoded different tokens "
                           "for one window; their model groups' sums are "
                           "no longer those of one model")


def _gather_rows(local: tuple, axis, eot: int) -> tuple:
    """Every data rank's host outputs of ``_decode_rows``, in data-rank
    order, joined along the rows (sequences padded with eot and jump times
    with zeros to the widest rank's)."""
    parts: list = [None] * axis.size
    dist.all_gather_object(parts, local, group=axis.group)

    def join(i, fill):
        arrs = [p[i] for p in parts]
        width = max(a.shape[1] for a in arrs)
        return np.concatenate([np.pad(a, ((0, 0), (0, width - a.shape[1])),
                                      constant_values=fill) for a in arrs])

    def rows(i):
        return np.concatenate([p[i] for p in parts])

    return (join(0, eot), rows(1), rows(2), local[3], rows(4),
            None if local[5] is None else join(5, 0.0))


def _decode_rows(params, arch, specials, opts, segment_features, prompt,
                 max_new, suppress, begin_suppress, align_sel, temperature,
                 generator, dtw_frames, prompt_mask=None, sot_position=0,
                 assistant=None, pos_offset=None):
    """``_decode_window`` on this rank's rows.

    Beam search runs only at temperature 0 (hf generate_with_fallback
    :1013-1016) and then takes precedence over an ``assistant``; its score
    is ``sequences_scores``, already normalized (the quantity the fallback
    gate reads, :1266). With an ``assistant`` ("prompt_lookup" or a
    (draft_params, draft_arch) pair) a greedy window at temperature 0
    decodes speculatively (reference longform.py:77-111); sampled
    temperatures decode plainly."""
    rows = segment_features.shape[0]
    with trace_span("cw.encode", rows=rows):
        encoder_out = encode(params, arch, segment_features)
    kw = dict(max_new_tokens=max_new, suppress_mask=suppress,
              begin_suppress_mask=begin_suppress, align_sel=align_sel,
              return_timestamps=opts.return_timestamps,
              cross_cache_dtype=_kv_dtype(opts),
              self_cache_dtype=_self_kv_dtype(opts),
              prompt_mask=prompt_mask, sot_position=sot_position,
              pos_offset=pos_offset)
    prompt = torch.from_numpy(prompt)
    use_beams = opts.num_beams > 1 and temperature == 0.0
    normalized = use_beams
    with trace_span("cw.decode", rows=rows) as span:
        if use_beams:
            from .beam import beam_decode
            res = beam_decode(params, arch, specials, opts, encoder_out,
                              prompt, num_beams=opts.num_beams, **kw)
            score = res.sequences_scores
        elif assistant is not None and temperature == 0.0:
            from .assisted import assisted_decode
            draft_params = draft_arch = draft_enc = None
            if assistant != "prompt_lookup":
                draft_params, draft_arch = assistant
                # a self-draft (no encoder of its own) reads the main states
                draft_enc = (encode(draft_params, draft_arch,
                                    segment_features)
                             if "encoder" in draft_params else encoder_out)
            res = assisted_decode(params, arch, draft_params, draft_arch,
                                  specials, opts, encoder_out, draft_enc,
                                  prompt, spec_len=opts.assistant_spec_len,
                                  **kw)
        else:
            res = greedy_decode(params, arch, specials, opts, encoder_out,
                                prompt, temperature=temperature,
                                generator=generator, **kw)
        span.count(steps=res.steps)
    if not use_beams:
        score = res.sum_logprobs
    outs = [res.sequences, res.num_generated, score, res.no_speech_probs]
    if align_sel is not None:
        # every row, full (1500 frames) or cropped, in one prep + one DTW
        with trace_span("cw.align_tail", rows=rows):
            n_tokens = (res.num_generated - 1).clamp_min(0)
            outs.append(attention_to_jump_times(
                res.align_probs, opts.median_filter_width, n_tokens,
                torch.as_tensor(dtw_frames, dtype=torch.int32)))
    # single read-back: queue every device->host copy, then wait once
    with trace_span("cw.readback", rows=rows):
        host = [x.to("cpu", non_blocking=True) for x in outs]
        if encoder_out.device.type == "cuda":
            torch.cuda.current_stream(encoder_out.device).synchronize()
    seqs, ngen, score, no_sp = (h.numpy() for h in host[:4])
    jump_times = None
    if align_sel is not None:
        jump_times = host[4].numpy().astype(np.float32) * opts.time_precision
    return seqs, ngen, score, normalized, no_sp, jump_times


@torch.inference_mode()
def generate(params: Any, arch: WhisperArch, specials: SpecialTokens,
             opts: GenerationOptions, input_features: torch.Tensor,
             num_frames: np.ndarray | None = None,
             max_frames: np.ndarray | None = None,
             language_token: int | None = None,
             task_token: int | None = None,
             detect_language_first: bool = False,
             generator: torch.Generator | None = None,
             monitor_progress: Any | None = None,
             assistant: tuple[Any, WhisperArch] | str | None = None,
             batch_sharding: Any | None = None
             ) -> GenerateOutput:
    """Transcribe batched (possibly > 30 s) mel features.

    input_features: [B, n_mels, total_frames] f32, on the model's device;
      windows are sliced there and never visit the host.
    num_frames: [B] true (unpadded) frame counts — used only to crop the
      DTW key axis (hf generation_whisper.py:1697-1705).
    max_frames: [B] per-row seek bound; defaults to total_frames.
    generator: torch.Generator on the features' device for the sampled
      fallback temperatures (default: seeded with opts.prompt_seed).
    monitor_progress: optional callable, called at the top of each seek
      pass with the int64 [B, 2] array of (seek, max_frames) per row (hf
      generation_whisper.py:796-798).
    assistant: optional (draft_params, draft_arch) pair, or
      "prompt_lookup": windows at temperature 0 decode speculatively
      (decoding/assisted.py), with the same output as plain greedy.
    batch_sharding: optional parallel/mesh.data_sharding(mesh): every
      rank holds the whole feature batch, and each data rank decodes its
      share of each window batch whose rows divide the data axis, with
      tensor parallelism inside its model group (``_decode_window``); the
      host bookkeeping stays the same on every rank, so every rank
      returns the whole batch. Every rank samples from rank 0's
      ``generator`` state, and a sampled fallback window runs whole on
      every data rank, so the mesh draws what one process would.
    """
    feats = input_features
    dev = feats.device
    b, n_mels, total_frames = feats.shape
    num_segment_frames = INPUT_STRIDE * arch.max_source_positions
    feats_pad: list[torch.Tensor] = []

    def device_window(rows: np.ndarray, seeks: np.ndarray,
                      lengths: np.ndarray) -> torch.Tensor:
        """[len(rows), n_mels, num_segment_frames] window per row, sliced
        on the device; positions >= lengths[j] are zeroed."""
        if not feats_pad:
            feats_pad.append(torch.nn.functional.pad(
                feats, (0, num_segment_frames)))
        fp = feats_pad[0]
        win = torch.stack([fp[int(r), :, int(s):int(s) + num_segment_frames]
                           for r, s in zip(rows, seeks)])
        keep = (torch.arange(num_segment_frames, device=dev)[None, :]
                < torch.as_tensor(lengths, device=dev)[:, None])
        return win * keep[:, None, :].to(win.dtype)

    max_frames = (np.asarray(max_frames, np.int64) if max_frames is not None
                  else np.full((b,), total_frames, np.int64))
    num_frames = (np.asarray(num_frames, np.int64) if num_frames is not None
                  else None)
    seek = np.zeros((b,), np.int64)

    if detect_language_first and language_token is None:
        # one batched detection on the first 30 s window per row
        # (hf _retrieve_init_tokens :1584 detects once, not per seek)
        from .language import detect_language
        if (total_frames == num_segment_frames
                and bool(np.all(max_frames >= num_segment_frames))):
            first = feats
        else:
            first = device_window(
                np.arange(b), np.zeros((b,), np.int64),
                np.minimum(np.minimum(max_frames, num_segment_frames),
                           total_frames))
        lang_ids = detect_language(params, arch, specials,
                                   encode(params, arch, first)).cpu().numpy()
        init_tokens = np.stack([
            np.concatenate([
                np.asarray([specials.sot, int(lang_ids[i]),
                            task_token if task_token is not None
                            else specials.transcribe], np.int32),
                (np.asarray([], np.int32) if opts.return_timestamps
                 else np.asarray([specials.no_timestamps], np.int32))])
            for i in range(b)])
    else:
        init_tokens = build_prompt(
            specials, b, language_token=language_token,
            task_token=task_token,
            return_timestamps=opts.return_timestamps,
            forced_tokens=opts.forced_tokens)
    conditioning = bool(opts.condition_on_prev_tokens)
    # the user prompt (hf generate(prompt_ids=...), :1875-1943 and
    # _prepare_segments :1130-1139)
    prompt_ids = (np.asarray(opts.prompt_ids, np.int32)
                  if opts.prompt_ids is not None else None)
    if opts.prompt_condition_type not in ("first-segment", "all-segments"):
        raise ValueError(
            f"prompt_condition_type={opts.prompt_condition_type!r} does not "
            "exist; use 'first-segment' or 'all-segments'")
    if (prompt_ids is not None
            and opts.prompt_condition_type == "all-segments"
            and not conditioning):
        raise ValueError(
            "Make sure to set condition_on_prev_tokens=True when setting "
            "prompt_condition_type='all-segments'.")
    # A conditioned window's prompt region has the fixed width cut_off +
    # len(bos), left-padded with eot under a mask; windows without earlier
    # context decode the bare init tokens (hf :1900). opts.condition_mode:
    # "static" lets the pads take learned positions (padding='max_length',
    # hf :1913-1921); "dynamic" shifts each row's positions by its pad
    # count, so real tokens take 0..len-1 (the reference's default
    # padding='longest' with mask-aware decoder_position_ids).
    cut_off = arch.max_target_positions // 2 - 1
    # the conditioned prefix begins with <|startofprev|>, or in
    # all-segments mode with the whole user prompt (hf _pad_to_max_length
    # never trims the bos tokens)
    cond_bos = (prompt_ids.astype(np.int64)
                if (prompt_ids is not None
                    and opts.prompt_condition_type == "all-segments")
                else np.asarray([specials.sot_prev], np.int64))
    prev_width = (cut_off + len(cond_bos)) if conditioning else 0
    # rows start out willing to condition (hf :1316); window 1 still
    # decodes bare unless the prompt seeded the segments below
    do_condition = np.full((b,), conditioning, bool)

    want_ts = opts.return_token_timestamps and len(opts.alignment_heads) > 0
    suppress = (torch.from_numpy(suppress_tokens_mask(
        arch.vocab_size, opts.suppress_tokens)).to(dev)
        if opts.suppress_tokens else None)
    begin_suppress = (torch.from_numpy(suppress_tokens_mask(
        arch.vocab_size, opts.begin_suppress_tokens)).to(dev)
        if opts.begin_suppress_tokens else None)
    align_sel = (alignment_selector(arch, opts.alignment_heads)
                 if want_ts else None)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(opts.prompt_seed)
    if batch_sharding is not None and any(t > 0 for t in opts.temperatures):
        # the ranks' generators may differ (a caller's, seeded per rank);
        # every rank takes rank 0's state
        state = [generator.get_state()]
        dist.broadcast_object_list(state, src=0)
        generator.set_state(state[0])
    current_segments: list[list[dict[str, Any]]] = [[] for _ in range(b)]
    prompt_seeded = False
    if prompt_ids is not None and opts.prompt_condition_type == \
            "first-segment":
        # the prompt seeds the previous context as a first "segment"
        # (its leading <|startofprev|> stripped: the conditioned prefix
        # adds it back as the bos), trimmed from the output below (hf :920)
        seed = (prompt_ids[1:] if len(prompt_ids) and
                prompt_ids[0] == specials.sot_prev else prompt_ids)
        current_segments = [[{"tokens": seed.astype(np.int64),
                              "token_timestamps":
                                  np.zeros(len(seed), np.float32)}]
                            for _ in range(b)]
        prompt_seeded = True

    while (seek < max_frames).any():
        with trace_span("cw.seek") as span:
            if monitor_progress is not None:
                monitor_progress(np.stack([seek, max_frames], axis=1))
            active = seek < max_frames
            time_offset = seek.astype(np.float64) * opts.time_precision \
                / INPUT_STRIDE
            seek_num_frames = np.minimum(max_frames - seek, num_segment_frames)

            # --- dynamic batch shrink: live rows in a power-of-2 bucket;
            # filler slots repeat the first live row and are discarded ---
            idx = np.nonzero(active)[0]
            nact = len(idx)
            bucket = 1
            while bucket < nact:
                bucket *= 2
            bucket = min(bucket, b)
            span.count(live=nact, bucket=bucket)
            rows = np.concatenate([idx, np.repeat(idx[:1], bucket - nact)])

            if (total_frames == num_segment_frames and nact == b
                    and not seek.any()
                    and bool(np.all(seek_num_frames == num_segment_frames))):
                segment = feats          # one full window per row, all at 0
            else:
                segment = device_window(rows, seek[rows],
                                        seek_num_frames[rows])

            if num_frames is not None:
                dtw_frames = np.minimum((num_frames - seek) // 2,
                                        arch.max_source_positions)
                dtw_frames = np.maximum(dtw_frames, 1)
            else:
                dtw_frames = np.full((b,), arch.max_source_positions,
                                     np.int64)

            # the conditioned decoder prompt (hf _prepare_decoder_input_ids)
            iter_prompt = init_tokens[rows]
            iter_mask = None
            iter_pos_offset = None
            if (conditioning and do_condition[rows].any()
                    and any(len(current_segments[i]) for i in rows)):
                prev_tok = pad_segments_to_max_length(
                    [current_segments[i] if do_condition[i] else []
                     for i in rows],
                    specials.eot, padding_side="left", cut_off_length=cut_off,
                    bos_token=cond_bos, skip_ending_double_timestamps=True,
                    timestamp_begin=specials.timestamp_begin,
                    fixed_total_length=prev_width)
                iter_prompt = np.concatenate(
                    [prev_tok.astype(np.int32), iter_prompt], axis=1)
                iter_mask = np.concatenate(
                    [prev_tok != specials.eot,
                     np.ones_like(init_tokens[rows], bool)], axis=1)
                if opts.condition_mode == "dynamic":
                    # the pads are contiguous on the left, so each row's
                    # offset is its pad count
                    iter_pos_offset = (~iter_mask).sum(axis=1).astype(
                        np.int32)
            elif prompt_ids is not None:
                # an unconditioned prompt prefixes the init tokens unmasked:
                # its slots are attended and take positions (hf :1932-1936)
                iter_prompt = np.concatenate(
                    [np.tile(prompt_ids, (len(rows), 1)), iter_prompt],
                    axis=1)
            p = iter_prompt.shape[1]
            max_new = min(opts.max_new_tokens, arch.max_target_positions - p)
            # the SOT slot inside the prompt: its raw logits carry
            # P(<|nospeech|>)
            sot_position = p - init_tokens.shape[1]

            # --- temperature fallback ladder (generate_with_fallback) ---
            resolved = np.zeros((bucket,), bool)
            resolved[nact:] = True                         # filler slots
            results: list[Any] = [None] * bucket
            for t_idx, temperature in enumerate(opts.temperatures):
                seqs, ngen, score, normalized, no_sp, jt = _decode_window(
                    params, arch, specials, opts, segment, iter_prompt,
                    max_new, suppress, begin_suppress, align_sel,
                    float(temperature),
                    generator, dtw_frames[rows], prompt_mask=iter_mask,
                    sot_position=sot_position, assistant=assistant,
                    pos_offset=iter_pos_offset, batch_sharding=batch_sharding)
                is_last = t_idx == len(opts.temperatures) - 1
                with trace_span("cw.segments", rows=nact):
                    for j in range(nact):
                        if resolved[j]:
                            continue
                        g = int(ngen[j])
                        seq_with_eos = seqs[j, p:p + g]
                        avg_lp = (score[j] if normalized
                                  else (score[j] / g) if g > 0 else 0.0)
                        nf, skip = need_fallback(seq_with_eos, avg_lp,
                                                 no_sp[j], arch.vocab_size,
                                                 opts)
                        if not nf or is_last:
                            results[j] = (seq_with_eos,
                                          jt[j] if jt is not None else None,
                                          skip)
                            resolved[j] = True
                            # condition the next window only on low-
                            # temperature results (hf generate_with_fallback
                            # :1100-1103)
                            do_condition[rows[j]] = (conditioning
                                                     and temperature < 0.5)
                if resolved.all():
                    break

            # --- segment extraction & seek advance ---
            with trace_span("cw.segments", rows=nact):
                for j in range(nact):
                    i = rows[j]
                    seq_with_eos, jt_row, skip = results[j]
                    if skip:
                        seek[i] += int(seek_num_frames[i])
                        continue
                    seq = seq_with_eos
                    if len(seq) > 0 and seq[-1] == specials.eot:
                        seq = seq[:-1]
                    tok_ts = jt_row[:len(seq)] if jt_row is not None else None
                    if tok_ts is not None and len(tok_ts) < len(seq):
                        tok_ts = np.pad(tok_ts, (0, len(seq) - len(tok_ts)),
                                        mode="edge")
                    segs, offset = retrieve_segment(
                        seq, tok_ts, float(time_offset[i]),
                        specials.timestamp_begin, int(seek_num_frames[i]),
                        opts.time_precision, TIME_PRECISION_FEATURES,
                        INPUT_STRIDE)
                    seek[i] += offset
                    current_segments[i] += segs

            if opts.force_unique_generate_call:
                break                # exactly one seek pass (hf :913)

    # the seeded prompt "segment" is context, not output (hf :918-922)
    final_segments = ([segs[1:] for segs in current_segments]
                      if prompt_seeded else current_segments)
    if want_ts:
        sequences, token_ts = pad_segments_to_max_length(
            final_segments, specials.eot, return_token_timestamps=True)
    else:
        sequences = pad_segments_to_max_length(final_segments, specials.eot)
        token_ts = None
    return GenerateOutput(sequences=sequences, token_timestamps=token_ts,
                          segments=final_segments)
