# Verbatim copy of crisperwhisper_tpu/decoding/segments.py: the functions are
# unchanged, only the imports point at the port's own modules. The port
# imports nothing of the JAX package; tests/test_torch_pipeline.py pins
# this copy to the original.
"""Segment extraction and output padding — host-side numpy logic.

Semantic ports (behavior-exact, re-derived for numpy) of:
  * _retrieve_segment       — hf generation_whisper.py:1998-2096
  * _pad_to_max_length      — hf generation_whisper.py:129-240

These run on small per-row token lists after the device decode; they are
not hot paths. The segment dict schema matches the reference so downstream
stitching (`_decode_asr` equivalent) and user code see identical shapes.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def retrieve_segment(seek_sequence: np.ndarray,
                     token_timestamps: np.ndarray | None,
                     time_offset: float,
                     timestamp_begin: int,
                     seek_num_frames: int,
                     time_precision: float,
                     time_precision_features: float,
                     input_stride: int,
                     ) -> tuple[list[dict[str, Any]], int]:
    """Split one generated sequence (prompt/eos already trimmed) into
    timestamp-delimited segments; return (segments, segment_offset_frames).

    token_timestamps, when given, is aligned with seek_sequence (entry k is
    the timestamp of token k, seconds within the window).
    """
    seq = np.asarray(seek_sequence)
    ts_tokens = seq >= timestamp_begin
    single_timestamp_ending = (len(seq) >= 2 and not ts_tokens[-2]
                               and ts_tokens[-1])
    pair_idx = np.where(ts_tokens[:-1] & ts_tokens[1:])[0] + 1

    segments: list[dict[str, Any]] = []
    if len(pair_idx) > 0:
        slices = list(pair_idx)
        if single_timestamp_ending:
            slices.append(len(seq))
        else:
            slices[-1] += 1
        last_slice = 0
        for i, current_slice in enumerate(slices):
            is_last_slice = i == len(slices) - 1
            sliced = seq[last_slice:current_slice]
            start_pos = int(sliced[0]) - timestamp_begin
            end_idx = -1 if (not is_last_slice or single_timestamp_ending) \
                else -2
            end_pos = int(sliced[end_idx]) - timestamp_begin
            seg = {
                "start": time_offset + start_pos * time_precision,
                "end": time_offset + end_pos * time_precision,
                "tokens": sliced,
                "idxs": (last_slice, current_slice),
            }
            if token_timestamps is not None:
                seg["token_timestamps"] = (
                    token_timestamps[last_slice:current_slice] + time_offset)
                # window-local copy: the reference's padded top-level output
                # slices the *result's* (unoffset) timestamps
                # (_pad_to_max_length :192-195)
                seg["token_timestamps_local"] = \
                    token_timestamps[last_slice:current_slice]
            segments.append(seg)
            last_slice = current_slice
        if single_timestamp_ending:
            segment_offset = int(seek_num_frames)
        else:
            last_ts_pos = int(seq[last_slice - 2]) - timestamp_begin
            segment_offset = last_ts_pos * input_stride
    else:
        timestamps = seq[ts_tokens]
        last_ts_pos = int(seek_num_frames * time_precision_features
                          / time_precision)
        if len(timestamps) > 0 and int(timestamps[-1]) != timestamp_begin:
            last_ts_pos = int(timestamps[-1]) - timestamp_begin
        seg = {
            "start": time_offset,
            "end": time_offset + last_ts_pos * time_precision,
            "tokens": seq,
            "idxs": (0, len(seq)),
        }
        if token_timestamps is not None:
            seg["token_timestamps"] = token_timestamps[:len(seq)] + time_offset
            seg["token_timestamps_local"] = token_timestamps[:len(seq)]
        segments.append(seg)
        segment_offset = int(seek_num_frames)

    return segments, segment_offset


def pad_segments_to_max_length(current_segments: list[list[dict[str, Any]]],
                               pad_token_id: int,
                               return_token_timestamps: bool = False,
                               cut_off_length: int | None = None,
                               bos_token: np.ndarray | None = None,
                               padding_side: str = "right",
                               skip_ending_double_timestamps: bool = False,
                               timestamp_begin: int | None = None,
                               fixed_total_length: int | None = None):
    """Concatenate per-item segment token lists and pad into a batch
    (hf _pad_to_max_length). Returns sequences [B, L] (+ timestamps).
    fixed_total_length forces the padded width (the reference's
    padding='max_length' mode used for static caches, :222)."""
    sequences, ts_list = [], []
    for seg_list in current_segments:
        if seg_list:
            parts = []
            for d in seg_list:
                toks = np.asarray(d["tokens"])
                if (skip_ending_double_timestamps and len(toks) > 2
                        and toks[-2] >= timestamp_begin):
                    toks = toks[:-1]
                parts.append(toks)
            seq = np.concatenate(parts) if parts else np.zeros(0, np.int64)
            if return_token_timestamps:
                # window-local timestamps, matching the reference's padded
                # output (result timestamps, not offset segment ones)
                ts = np.concatenate([
                    np.asarray(d.get("token_timestamps_local",
                                     d["token_timestamps"]))
                    for d in seg_list])
            if cut_off_length is not None:
                seq = seq[-cut_off_length:]
                if return_token_timestamps:
                    ts = ts[-cut_off_length:]
            if bos_token is not None:
                seq = np.concatenate([bos_token, seq])
                if return_token_timestamps:
                    ts = np.concatenate([np.zeros_like(bos_token, np.float32),
                                         ts])
        else:
            seq = (bos_token if bos_token is not None
                   else np.zeros(0, np.int64))
            if return_token_timestamps:
                ts = np.zeros(len(seq), np.float32)
        sequences.append(seq.astype(np.int64))
        if return_token_timestamps:
            ts_list.append(ts.astype(np.float32))

    max_len = (fixed_total_length if fixed_total_length is not None
               else max((len(s) for s in sequences), default=0))
    if fixed_total_length is not None:
        sequences = [s[-fixed_total_length:] for s in sequences]
        if return_token_timestamps:
            ts_list = [t[-fixed_total_length:] for t in ts_list]
    out = np.full((len(sequences), max_len), pad_token_id, np.int64)
    out_ts = np.zeros((len(sequences), max_len), np.float32)
    for i, s in enumerate(sequences):
        if padding_side == "right":
            out[i, :len(s)] = s
            if return_token_timestamps:
                out_ts[i, :len(s)] = ts_list[i]
                if len(ts_list[i]) > 0:
                    out_ts[i, len(s):] = ts_list[i][-1]
        else:
            out[i, max_len - len(s):] = s
            if return_token_timestamps and len(s) > 0:
                out_ts[i, max_len - len(s):] = ts_list[i]
    if return_token_timestamps:
        return out, out_ts
    return out
