"""Beam-search decode loop (num_beams > 1, deterministic).

Port of crisperwhisper_tpu/decoding/beam.py (hf generation/utils.py
``_beam_search`` with ``BeamSearchScorer`` bookkeeping): 2·NB candidates a
step, EOS candidates accepted only from the top NB ranks, a finished pool
with worst-eviction, the ``early_stopping=False`` attainability stop, and
``length_penalty`` as score / len**penalty. Like decoding/greedy.py, the
loop is a Python loop whose state stays on the device; the host reads one
flag per step (is every item done?).

The beams of an item share its cross cache (models/whisper.decode_step
with ``beam_groups``); only the self ring is per beam, and it is reordered
with the tokens, the grammar state and the alignment rows at every step.
The reorder gathers only the ring's live prefix (slots <= t), and the
alignment rows and their finished-pool snapshots only the rows recorded so
far: every later slot is still zero in every beam, so the result is the
reference's full gather for a fraction of the bytes.

With ``opts.b1_decode_kernel`` at batch 1 and a quantized serving cache,
each step is the whole-step kernel's beams mode
(ops/decode_step.decode_step_b1_beams) under the reference's gate
(beam.py:184-195); anything else takes models/whisper.decode_step.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..config import GenerationOptions, SpecialTokens, WhisperArch

from ..models.whisper import decode_step, decode_step_multi, init_cache
from ..ops import decode_step as step_kernel
from .greedy import _device, _key_mask, _no_speech_prob
from .processors import TimestampState, process_scores

NEG_INF = -1e9                        # f32 score of empty slots (beam.py:35)
_RINGS = ("self_k", "self_v", "self_k_scale", "self_v_scale")


@dataclass
class BeamResult:
    """The top hypothesis of each item (device tensors).

    sequences: [B, P + max_new] int32 — prompt + generated, eot-padded.
    num_generated: [B] int32 — generated tokens incl. the final eot.
    sequences_scores: [B] f32 — sum logprob / len**length_penalty.
    no_speech_probs: [B] f32 — from beam 0's raw logits at the SOT slot.
    align_probs: [B, A, max_new, K] f32 — the top hypothesis' rows.
    """
    sequences: torch.Tensor
    num_generated: torch.Tensor
    sequences_scores: torch.Tensor
    no_speech_probs: torch.Tensor
    align_probs: torch.Tensor


def top_k_stable(x: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of each row and their indices, ties in index
    order (``jax.lax.top_k``'s order; torch.topk promises none)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, NB, ...] gathered along the beam axis by idx [B, J]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _reorder_state(state: TimestampState, src: torch.Tensor
                   ) -> TimestampState:
    return TimestampState(*(getattr(state, f.name)[src]
                            for f in fields(state)))


@torch.inference_mode()
def beam_decode(params, arch: WhisperArch, specials: SpecialTokens,
                opts: GenerationOptions, encoder_out: torch.Tensor,
                prompt: torch.Tensor, *, max_new_tokens: int,
                num_beams: int, length_penalty: float = 1.0,
                suppress_mask: torch.Tensor | None = None,
                begin_suppress_mask: torch.Tensor | None = None,
                align_sel: np.ndarray | None = None,
                return_timestamps: bool = True,
                prompt_mask: np.ndarray | torch.Tensor | None = None,
                cross_cache_dtype: str | None = None,
                self_cache_dtype: str | None = None,
                sot_position: int = 0,
                pos_offset: np.ndarray | torch.Tensor | None = None
                ) -> BeamResult:
    """Beam search over ``num_beams`` hypotheses per item of ``prompt``
    [B, P] against ``encoder_out`` [B, K, d]. The other arguments are
    greedy_decode's; a pos_offset applies to every beam of its item."""
    b, p = prompt.shape
    nb = num_beams
    dev = encoder_out.device
    k_frames = encoder_out.shape[1]
    t_total = p + max_new_tokens
    if t_total > arch.max_target_positions:
        raise ValueError(f"prompt {p} + max_new {max_new_tokens} exceeds "
                         f"max_target_positions {arch.max_target_positions}")
    n_align = align_sel.shape[-1] if align_sel is not None else 1
    eot = specials.eot
    flat = b * nb
    items = torch.arange(b, device=dev)
    beam_ids = torch.arange(nb, device=dev)

    # one cross cache per item, one ring per beam
    cache = init_cache(params, arch, encoder_out, cache_len=t_total,
                       cross_dtype=cross_cache_dtype,
                       self_dtype=self_cache_dtype, self_batch=flat)
    pre_key_mask = _key_mask(prompt_mask, max_new_tokens, dev)
    key_mask = (None if pre_key_mask is None
                else pre_key_mask.repeat_interleave(nb, 0))
    pos_offset = _device(pos_offset, dev)
    flat_offset = (None if pos_offset is None
                   else pos_offset.repeat_interleave(nb, 0))

    prompt = prompt.to(device=dev, dtype=torch.long)
    tokens = torch.cat([prompt[:, None, :].expand(b, nb, p),
                        torch.full((b, nb, max_new_tokens), eot,
                                   dtype=torch.long, device=dev)], 2)
    beam_scores = torch.where(beam_ids == 0, 0.0, NEG_INF).to(
        torch.float32)[None].repeat(b, 1)

    # block prefill at batch B (the beams share the prompt), then each
    # item's ring columns repeated per beam
    no_speech = torch.zeros((b,), dtype=torch.float32, device=dev)
    t = 0
    if p > 1:
        pre = replace(cache, **{
            n: getattr(cache, n).new_zeros(
                (arch.decoder_layers, b) + getattr(cache, n).shape[2:])
            for n in _RINGS if getattr(cache, n) is not None})
        pre_logits, pre, _ = decode_step_multi(
            params, arch, prompt[:, :p - 1], 0, pre, key_mask=pre_key_mask,
            pos_offset=pos_offset)
        cache = replace(cache, **{
            n: getattr(pre, n).repeat_interleave(nb, 1)
            for n in _RINGS if getattr(pre, n) is not None})
        del pre
        if sot_position <= p - 2:
            no_speech = _no_speech_prob(pre_logits[:, sot_position],
                                        specials.no_speech)
        t = p - 1

    state = TimestampState.init(flat, dev)
    fin_tokens = torch.full((b, nb, t_total), eot, dtype=torch.long,
                            device=dev)
    fin_scores = torch.full((b, nb), NEG_INF, dtype=torch.float32,
                            device=dev)
    fin_lens = torch.zeros((b, nb), dtype=torch.int32, device=dev)
    fin_count = torch.zeros((b,), dtype=torch.int32, device=dev)
    fin_align = torch.zeros((b, nb, n_align, max_new_tokens, k_frames),
                            dtype=torch.float32, device=dev)
    align_buf = torch.zeros_like(fin_align)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)

    def length_pen(length: int) -> torch.Tensor:
        return torch.tensor(float(length), dtype=torch.float32,
                            device=dev) ** length_penalty

    # the whole-step kernel's beams mode, decided once (beam.py:190-195)
    use_beams_kernel = (opts.b1_decode_kernel and b == 1
                        and key_mask is None and pos_offset is None
                        and step_kernel.supported_beams(
                            params, arch, cache, key_mask, 0,
                            torch.zeros((flat,), dtype=torch.long)))
    if use_beams_kernel:
        step = step_kernel.decode_step_b1_beams
    else:
        def step(*a, **kw):
            return decode_step(*a, key_mask=key_mask, beam_groups=nb,
                               pos_offset=flat_offset, **kw)

    # every step samples: the prefill leaves t = P - 1 (beam.py's prompt
    # phase never runs after it)
    while t < t_total - 1 and not bool(done.all()):
        feed = tokens.reshape(flat, t_total)[:, t]
        logits, cache, align = step(params, arch, feed, t, cache,
                                    align_sel=align_sel)
        if t >= p:                         # rows of generated queries
            align_buf[:, :, :, t - p] = align.reshape(b, nb, n_align,
                                                      k_frames)
        if t == sot_position:
            no_speech = _no_speech_prob(logits, specials.no_speech
                                        ).reshape(b, nb)[:, 0]

        # log_softmax first, then the processors on the logprobs, left
        # unrenormalized (hf _beam_search; beam.py:235-240)
        logprobs = process_scores(torch.log_softmax(logits, dim=-1), state,
                                  specials, opts, suppress_mask,
                                  begin_suppress_mask, return_timestamps)
        v = logprobs.shape[-1]
        cand = (beam_scores[:, :, None]
                + logprobs.reshape(b, nb, v)).reshape(b, nb * v)
        top_scores, top_idx = top_k_stable(cand, 2 * nb)       # [B, 2NB]
        src_beam = top_idx // v
        tok = top_idx % v
        is_eos = tok == eot
        gen_len = t - p + 2                # generated tokens incl. this one
        rec = max(t - p + 1, 0)            # alignment rows recorded so far

        # the finished pool: EOS candidates of the top NB ranks, one at a
        # time in rank order, each evicting the worst when the pool is full
        # (ranks >= NB never enter, beam.py:268-309)
        eos_ok = is_eos[:, :nb] & ~done[:, None]
        fin_cand = top_scores[:, :nb] / length_pen(gen_len)
        for i in range(nb):
            sc = torch.where(eos_ok[:, i], fin_cand[:, i], NEG_INF)
            worst_idx = fin_scores.argmin(dim=1)
            worst = fin_scores.gather(1, worst_idx[:, None])[:, 0]
            has_room = fin_count < nb
            use_slot = torch.where(has_room, fin_count.long(), worst_idx)
            do = (sc > NEG_INF) & ((sc > worst) | has_room)
            onehot = (beam_ids[None, :] == use_slot[:, None]) & do[:, None]
            seq = tokens[items, src_beam[:, i]]                # [B, T]
            seq[:, t + 1] = eot
            fin_tokens = torch.where(onehot[:, :, None], seq[:, None],
                                     fin_tokens)
            fin_scores = torch.where(onehot, sc[:, None], fin_scores)
            fin_lens = torch.where(onehot, gen_len, fin_lens)
            fin_count = fin_count + (do & has_room).int()
            if rec:
                fin_align[items, use_slot, :, :rec] = torch.where(
                    do[:, None, None, None],
                    align_buf[items, src_beam[:, i], :, :rec],
                    fin_align[items, use_slot, :, :rec])

        # NB continuing (non-EOS) candidates in rank order
        live = ~is_eos
        live_rank = live.long().cumsum(1) - 1
        sel = ((live_rank[:, None, :] == beam_ids[None, :, None])
               & live[:, None, :]).to(torch.uint8).argmax(2)   # [B, NB]
        new_scores = top_scores.gather(1, sel)
        new_tok = tok.gather(1, sel)
        new_src = src_beam.gather(1, sel)
        keep = done[:, None]               # finished items stay frozen
        new_scores = torch.where(keep, beam_scores, new_scores)
        new_tok = torch.where(keep, eot, new_tok)
        new_src = torch.where(keep, beam_ids[None, :], new_src)

        # reorder the running buffers by source beam
        tokens = _take(tokens, new_src)
        tokens[:, :, t + 1] = new_tok
        if rec:
            align_buf[:, :, :, :rec] = _take(align_buf[:, :, :, :rec],
                                             new_src)
        flat_src = (new_src + items[:, None] * nb).reshape(flat)
        state = _reorder_state(state, flat_src)
        state = state.update(new_tok.reshape(flat), specials.timestamp_begin
                             ).where(~done.repeat_interleave(nb), state)
        # the rings' live prefix (slots <= t) with their scales
        for name in _RINGS:
            ring = getattr(cache, name)
            if ring is not None:
                ring[:, :, :, :t + 1] = ring[:, flat_src, :, :t + 1]

        # attainability stop (early_stopping=False, beam.py:347-353)
        attainable = new_scores.max(dim=1).values / length_pen(gen_len)
        worst_fin = torch.where(fin_count >= nb, fin_scores.min(dim=1).values,
                                NEG_INF)
        done = done | (worst_fin >= attainable)
        beam_scores = new_scores
        t += 1

    # length-stopped items: fold the running beams into the pool; done
    # items skip them (BeamSearchScorer.finalize, beam.py:417-448)
    run_scores = beam_scores / length_pen(max_new_tokens)
    all_scores = torch.cat([fin_scores, run_scores], 1)
    all_lens = torch.cat([fin_lens, torch.full_like(fin_lens,
                                                    max_new_tokens)], 1)
    valid = torch.cat([fin_scores > NEG_INF,
                       (~done)[:, None].expand(b, nb)], 1)
    masked = torch.where(valid, all_scores, NEG_INF)
    best = masked.argmax(dim=1)
    pick = best[:, None]
    return BeamResult(
        sequences=_take(torch.cat([fin_tokens, tokens], 1), pick)[:, 0]
        .to(torch.int32),
        num_generated=all_lens.gather(1, pick)[:, 0],
        sequences_scores=masked.gather(1, pick)[:, 0],
        no_speech_probs=no_speech,
        align_probs=_take(torch.cat([fin_align, align_buf], 1), pick)[:, 0])
