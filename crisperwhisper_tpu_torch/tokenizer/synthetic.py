"""Synthetic tokenizer with the STANDARD multilingual Whisper layout.

For benchmarks and load tests where no checkpoint tokenizer is available
(no hub access): a byte-level BPE over the 256 raw bytes plus the full
special-token table at the real multilingual-v2 ids (SpecialTokens
defaults / SURVEY.md §2.9), so host-side postprocessing (stitcher, word
grouping, VTT) runs at realistic cost against model-range token ids.
Text ids above the byte range must be folded into it first
(`fold_text_ids`) — a real checkpoint's vocab covers the whole id range.
"""

from __future__ import annotations

import numpy as np

from ..config import SpecialTokens
from .bpe import ByteLevelBPE, bytes_to_unicode
from .languages import LANGUAGE_CODES
from .whisper_tokenizer import WhisperTokenizer


def synthetic_standard_tokenizer(sp: SpecialTokens | None = None
                                 ) -> WhisperTokenizer:
    sp = sp or SpecialTokens()
    byte_vocab = list(bytes_to_unicode().values())
    encoder = {tok: i for i, tok in enumerate(byte_vocab)}
    bpe = ByteLevelBPE(encoder=encoder, bpe_ranks={})
    added = {
        "<|endoftext|>": sp.eot,
        "<|startoftranscript|>": sp.sot,
        "<|translate|>": sp.translate,
        "<|transcribe|>": sp.transcribe,
        "<|startofprev|>": sp.sot_prev,
        "<|nospeech|>": sp.no_speech,
        "<|notimestamps|>": sp.no_timestamps,
    }
    for i, code in enumerate(LANGUAGE_CODES[:sp.num_languages]):
        added[f"<|{code}|>"] = sp.language_begin + i
    return WhisperTokenizer(bpe, added)


def fold_text_ids(ids: np.ndarray, sp: SpecialTokens | None = None,
                  printable_only: bool = True) -> np.ndarray:
    """Map model-range TEXT token ids into the byte vocab (so every text
    token decodes to one byte); specials/timestamps pass through."""
    sp = sp or SpecialTokens()
    ids = np.asarray(ids)
    is_text = ids < sp.eot
    folded = (ids % 95 + 32) if printable_only else (ids % 256)
    return np.where(is_text, folded, ids)
