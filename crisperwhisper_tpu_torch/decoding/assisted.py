"""Assisted (speculative) decoding: a draft proposes, the main model verifies.

Port of crisperwhisper_tpu/decoding/assisted.py (hf assistant_model and
prompt_lookup_num_tokens). Each round proposes ``spec_len`` candidate
tokens per row and checks them with ONE verify block of the main model
(models/whisper.decode_step_multi, or the whole-step kernel's multi mode,
ops/decode_step.decode_step_b1_multi, at batch 1 under
``opts.b1_decode_kernel``), so the main model's weights and cross cache are
read once per block instead of once per token. Candidates come from:

  * a draft model (``draft_params``), e.g. ``make_self_draft``: the first
    K decoder layers of the main checkpoint, proposing greedily with the
    timestamp grammar (on ops/decode_step.decode_step_b1 at batch 1 when
    its weights and caches fit the kernel's gate);
  * a script (``draft_script``, benches and tests: acceptance on demand);
  * prompt lookup (neither): ``ngram_propose`` continues the trailing
    n-gram of the committed tokens.

Exactness contract (the reference's, tested): for any draft, the result
equals ``greedy_decode``'s — sequences, token counts, log-probability
sums, no-speech probabilities and alignment rows. Batched like the
reference: each row keeps its own committed length, so the draft chain
and the verify block run at per-row cache positions (the ring writes of
ops/ring_write.py) and rows accept independently.

The loop runs on the host, one round per verify block; the accept runs on
the device and the host reads back one small tensor per round (each row's
committed count and finished flag).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..config import GenerationOptions, SpecialTokens, WhisperArch
from ..models.whisper import (INT4, INT8, decode_step, decode_step_multi,
                              init_cache)
from ..ops import decode_step as step_kernel
from .greedy import DecodeResult, _device, _key_mask, _no_speech_prob
from .processors import TimestampState, process_scores


def make_self_draft(params: Any, arch: WhisperArch, num_layers: int
                    ) -> tuple[Any, WhisperArch]:
    """Layer-truncated self-draft: the first ``num_layers`` decoder layers
    of the main checkpoint (with its embeddings and final LayerNorm)
    propose. The draft has no "encoder" entry: it reads the main encoder
    states, against which its cross-attention weights were trained
    (decoding/longform.py reuses them). Works on quantized layouts too.
    Returns (draft_params, draft_arch)."""
    if not 1 <= num_layers <= arch.decoder_layers:
        raise ValueError(f"num_layers {num_layers} out of range "
                         f"(decoder has {arch.decoder_layers})")
    dec = dict(params["decoder"])
    dec["layers"] = dec["layers"][:num_layers]
    return {"decoder": dec}, dataclasses.replace(arch,
                                                 decoder_layers=num_layers)


def ngram_propose(tokens: torch.Tensor, lengths: torch.Tensor,
                  spec_len: int, ngram_sizes: tuple[int, ...] = (3, 2),
                  fill: int = 0) -> torch.Tensor:
    """Prompt-lookup candidates: for each row, match the trailing n-gram of
    tokens[:lengths] against earlier window starts (largest n first, the
    first match wins: hf candidate_generator.py) and return the
    ``spec_len`` tokens that followed it. Rows without a match, or shorter
    than n + 1, get ``fill`` (the verify block rejects them).

    tokens: int [B, TT] (committed prefix and a filler tail); lengths:
    int [B]. Returns int64 drafts [B, spec_len]."""
    b, tt = tokens.shape
    dev = tokens.device
    tokens = tokens.long()
    lengths = lengths.to(device=dev, dtype=torch.long)
    idx = torch.arange(tt, device=dev)
    drafts = torch.full((b, spec_len), fill, dtype=torch.long, device=dev)
    have = torch.zeros((b,), dtype=torch.bool, device=dev)
    for n in ngram_sizes:                          # largest first
        tgt = tokens.gather(1, (lengths[:, None] - n
                                + torch.arange(n, device=dev)[None, :])
                            .clamp(0, tt - 1))                     # [B, n]
        # a match at start i: tokens[i + j] == tgt[j] for every j, with a
        # continuation token before the trailing n-gram (i + n <= len - 1)
        match = torch.ones((b, tt), dtype=torch.bool, device=dev)
        for j in range(n):
            shifted = tokens.gather(
                1, (idx + j).clamp(0, tt - 1).expand(b, tt))
            match &= shifted == tgt[:, j:j + 1]
        match &= (idx[None, :] + n <= lengths[:, None] - 1) \
            & (lengths[:, None] >= n + 1)
        found = match.any(dim=1)
        first = match.to(torch.uint8).argmax(dim=1)    # the first True
        cand = tokens.gather(1, (first[:, None] + n
                                 + torch.arange(spec_len, device=dev)[None, :])
                             .clamp(0, tt - 1))
        drafts = torch.where((found & ~have)[:, None], cand, drafts)
        have |= found
    return drafts


def _with_pos_overshoot(params: Any, s: int) -> Any:
    """``params`` with ``s - 1`` copies of the last learned position
    appended: the draft chain and the verify block index positions up to
    t_total + s - 2, past the table when t_total == max_target_positions
    (only for slots that are never committed). The reference extends the
    table the same way (assisted.py:170-179); a clamp would change which
    row a committed slot reads."""
    dec = dict(params["decoder"])
    pe = dec["pos_emb"]
    dec["pos_emb"] = torch.cat([pe, pe[-1:].expand(s - 1, -1)])
    return {**params, "decoder": dec}


def _quantized_fused(params: Any) -> bool:
    lay = params["decoder"]["layers"][0]
    return ("qkv" in lay["self"] and "w_q" in lay["self"]["qkv"]
            and "w_q" in lay["mlp"]["fc1"])


@torch.inference_mode()
def assisted_decode(params: Any, arch: WhisperArch,
                    draft_params: Any, draft_arch: WhisperArch | None,
                    specials: SpecialTokens, opts: GenerationOptions,
                    encoder_out: torch.Tensor,
                    draft_encoder_out: torch.Tensor | None,
                    prompt: torch.Tensor, *, max_new_tokens: int,
                    spec_len: int = 4,
                    suppress_mask: torch.Tensor | None = None,
                    begin_suppress_mask: torch.Tensor | None = None,
                    align_sel: np.ndarray | None = None,
                    return_timestamps: bool = True,
                    cross_cache_dtype: str | None = None,
                    self_cache_dtype: str | None = None,
                    sot_position: int = 0,
                    prompt_mask: np.ndarray | torch.Tensor | None = None,
                    pos_offset: np.ndarray | torch.Tensor | None = None,
                    draft_script: torch.Tensor | None = None,
                    counts: dict | None = None) -> DecodeResult:
    """Greedy decode of ``prompt`` [B, P] against ``encoder_out`` with
    speculation; the arguments and the result are ``greedy_decode``'s.
    ``prompt_mask`` and ``pos_offset`` reach the draft chain and the
    verify block alike (assisted.py:134-138 of the reference).
    draft_params None: ``draft_script`` int [B, >= P + max_new] (the
    candidate for token slot t is draft_script[b, t]) or, without one,
    prompt lookup. A real draft runs on ``draft_encoder_out``.

    counts (benches): a dict that gains "blocks" (verify blocks), "drafts"
    (candidates verified by rows still decoding, spec_len - 1 a block)
    and "accepted" (those of them committed); accepted / drafts is the
    acceptance rate."""
    b, p = prompt.shape
    s = spec_len
    dev = encoder_out.device
    use_draft_model = draft_params is not None
    k_frames = encoder_out.shape[1]
    t_total = p + max_new_tokens
    if t_total > arch.max_target_positions:
        raise ValueError(f"prompt {p} + max_new {max_new_tokens} exceeds "
                         f"max_target_positions {arch.max_target_positions}")
    if s > 1:
        params = _with_pos_overshoot(params, s)
        if use_draft_model:
            draft_params = _with_pos_overshoot(draft_params, s)
    n_align = align_sel.shape[-1] if align_sel is not None else 1
    eot, ts_begin = specials.eot, specials.timestamp_begin

    # caches with room for the block's overshoot past the last committed
    # token (those columns are masked, and overwritten by a later block)
    cache = init_cache(params, arch, encoder_out, cache_len=t_total + s,
                       cross_dtype=cross_cache_dtype,
                       self_dtype=self_cache_dtype)
    # the draft chain runs on the batch-1 kernel when the draft's weights
    # are fused and quantized (a self-draft of quantized weights is); its
    # numerics move only the acceptance rate
    key_mask = _key_mask(prompt_mask, max_new_tokens + s, dev)
    pos_offset = _device(pos_offset, dev)
    plain = key_mask is None and pos_offset is None
    draft_quant = (use_draft_model and b == 1 and opts.b1_decode_kernel
                   and plain and cross_cache_dtype in (INT8, INT4)
                   and _quantized_fused(draft_params))
    draft_cache = None
    if use_draft_model:
        draft_cache = init_cache(
            draft_params, draft_arch, draft_encoder_out,
            cache_len=t_total + s,
            cross_dtype=cross_cache_dtype if draft_quant else None,
            self_dtype=INT8 if draft_quant else None)

    prompt = prompt.to(device=dev, dtype=torch.long)
    no_speech = torch.zeros((b,), dtype=torch.float32, device=dev)
    if p > 1:
        pre_logits, cache, _ = decode_step_multi(
            params, arch, prompt[:, :p - 1], 0, cache, key_mask=key_mask,
            pos_offset=pos_offset)
        if use_draft_model:
            decode_step_multi(draft_params, draft_arch, prompt[:, :p - 1], 0,
                              draft_cache, key_mask=key_mask,
                              pos_offset=pos_offset)
        if sot_position <= p - 2:
            no_speech = _no_speech_prob(pre_logits[:, sot_position],
                                        specials.no_speech)

    # token buffer with the overshoot tail; alignment buffer with one
    # leading junk slot that takes the rows of uncommitted block queries
    tokens = torch.cat([prompt, torch.full((b, max_new_tokens + s), eot,
                                           dtype=torch.long, device=dev)], 1)
    align_buf = torch.zeros((b, n_align, 1 + max_new_tokens + s, k_frames),
                            dtype=torch.float32, device=dev)

    def proc(logits, state):
        return process_scores(logits, state, specials, opts, suppress_mask,
                              begin_suppress_mask, return_timestamps)

    # the whole-step kernel for the verify block at batch 1, decided once
    # (the reference's gate, assisted.py:256-263)
    block0 = torch.zeros((1, s), dtype=torch.long)
    use_b1_kernel = (opts.b1_decode_kernel and b == 1 and plain
                     and step_kernel.supported_multi(params, arch, cache,
                                                     key_mask, 0, block0))
    use_b1_draft_kernel = (use_b1_kernel and draft_quant
                           and step_kernel.supported(
                               draft_params, draft_arch, draft_cache, None,
                               1, 0, prompt[:, 0]))

    def at(pos_h: np.ndarray):
        """Cache positions: an int at batch 1, else per-row host int32."""
        return int(pos_h[0]) if b == 1 else torch.from_numpy(
            pos_h.astype(np.int32))

    state = TimestampState.init(b, dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    sum_lp = torch.zeros((b,), dtype=torch.float32, device=dev)
    steps = torch.arange(s, device=dev)
    lengths_h = np.full((b,), p, np.int64)
    finished_h = np.zeros((b,), bool)
    while (~finished_h & (lengths_h < t_total)).any():
        lengths = torch.from_numpy(lengths_h).to(dev)
        feed0 = tokens.gather(1, lengths[:, None] - 1)[:, 0]
        if use_draft_model:
            # the draft chain: s greedy proposals under the grammar
            dstate, tok, props = state, feed0, []
            for i in range(s):
                if use_b1_draft_kernel:
                    lgt, _, _ = step_kernel.decode_step_b1(
                        draft_params, draft_arch, tok, at(lengths_h - 1 + i),
                        draft_cache)
                else:
                    lgt, _, _ = decode_step(draft_params, draft_arch, tok,
                                            at(lengths_h - 1 + i),
                                            draft_cache, key_mask=key_mask,
                                            pos_offset=pos_offset)
                tok = proc(lgt, dstate).argmax(dim=-1)
                dstate = dstate.update(tok, ts_begin)
                props.append(tok)
            drafts = torch.stack(props, 1)
        elif draft_script is not None:
            script = draft_script.to(device=dev, dtype=torch.long)
            drafts = script.gather(1, (lengths[:, None] + steps[None, :])
                                   .clamp(0, script.shape[1] - 1))
        else:
            drafts = ngram_propose(tokens, lengths, s, fill=eot)

        # the verify block: [tok[len - 1], d_1 .. d_{s-1}] at len - 1
        block = torch.cat([feed0[:, None], drafts[:, :s - 1]], 1)
        if use_b1_kernel:
            logits, cache, align = step_kernel.decode_step_b1_multi(
                params, arch, block, at(lengths_h - 1), cache,
                align_sel=align_sel)
        else:
            logits, cache, align = decode_step_multi(
                params, arch, block, at(lengths_h - 1), cache,
                align_sel=align_sel, key_mask=key_mask,
                pos_offset=pos_offset)        # [B, S, V], [B, A, S, K]

        # sequential accept over the block, all rows at once: row r keeps
        # going while its target equals its own next input (draft d_{i+1})
        alive = torch.ones((b,), dtype=torch.bool, device=dev)
        tgts, commits = [], []
        for i in range(s):
            lg = logits[:, i]
            scores = proc(lg, state)
            tgt = scores.argmax(dim=-1)
            commit = alive & ~finished & (lengths + i < t_total)
            lp = (scores.gather(1, tgt[:, None])[:, 0]
                  - torch.logsumexp(scores, dim=-1))
            sum_lp += torch.where(commit, lp, 0.0)
            no_speech = torch.where(lengths - 1 + i == sot_position,
                                    _no_speech_prob(lg, specials.no_speech),
                                    no_speech)
            state = state.update(tgt, ts_begin).where(commit, state)
            finished = finished | (commit & (tgt == eot))
            alive = commit & (tgt == drafts[:, i]) & (i + 1 < s)
            tgts.append(tgt)
            commits.append(commit)
        tgts, commits = torch.stack(tgts, 1), torch.stack(commits, 1)

        # commit tokens at per-row offsets (uncommitted slots keep eot
        # until a later block overwrites them)
        slot = lengths[:, None] + steps[None, :]                   # [B, S]
        tokens.scatter_(1, slot, torch.where(commits, tgts, eot))
        # block row i of row r is the query at input position len - 1 + i;
        # its alignment row belongs to generated slot len - p + i, or, when
        # uncommitted or a prompt query, to the junk slot 0
        row_committed = commits & (slot - 1 >= p)
        dst = torch.where(row_committed, slot - p, 0)
        align_buf[torch.arange(b, device=dev)[:, None], :, dst] = \
            align.transpose(1, 2)

        back = torch.stack([commits.sum(1), finished.long()]).cpu().numpy()
        if counts is not None:
            live = ~finished_h & (lengths_h < t_total)
            for key, n in (("blocks", 1), ("drafts", live.sum() * (s - 1)),
                           ("accepted", (back[0][live] - 1).sum())):
                counts[key] = counts.get(key, 0) + int(n)
        lengths_h = lengths_h + back[0]
        finished_h = back[1].astype(bool)

    return DecodeResult(
        sequences=tokens[:, :t_total].to(torch.int32),
        num_generated=state.num_generated,
        sum_logprobs=sum_lp,
        no_speech_probs=no_speech,
        align_probs=align_buf[:, :, 1:1 + max_new_tokens].contiguous())
