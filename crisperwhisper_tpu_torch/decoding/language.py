"""Language detection — one decoder step from <|startoftranscript|>.

Port of crisperwhisper_tpu/decoding/language.py. Parity contract: hf
generation_whisper.py:1622-1685 detect_language: a single forward from
[sot], logits restricted to the language-token range, argmax per row.
"""

from __future__ import annotations

import torch

from ..config import SpecialTokens, WhisperArch

from ..models.whisper import decode_step, init_cache


@torch.inference_mode()
def detect_language(params, arch: WhisperArch, specials: SpecialTokens,
                    encoder_out: torch.Tensor,
                    num_languages: int | None = None) -> torch.Tensor:
    """[B, K, d] encoder states -> [B] int32 language token ids."""
    b = encoder_out.shape[0]
    n_lang = num_languages or specials.num_languages
    cache = init_cache(params, arch, encoder_out, cache_len=8)
    tokens = torch.full((b,), specials.sot, dtype=torch.long,
                        device=encoder_out.device)
    logits, _, _ = decode_step(params, arch, tokens, 0, cache)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    lang = (vocab >= specials.language_begin) \
        & (vocab < specials.language_begin + n_lang)
    masked = logits.masked_fill(~lang[None, :], float("-inf"))
    return masked.argmax(dim=-1).to(torch.int32)
