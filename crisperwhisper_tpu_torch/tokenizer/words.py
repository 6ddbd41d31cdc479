"""Word grouping and punctuation merging (round-2 original rewrite).

Behavioral contract — the outputs of hf tokenization_whisper.py's
`_combine_tokens_into_words` chain (:1285-1417) — pinned by
tests/test_tokenizer.py::test_combine_tokens_into_words_parity and the
pipeline word-timestamp parity suite, but re-derived:

  * unicode grouping works directly on each token's raw bytes (one O(n)
    byte-accumulation pass) instead of re-decoding every prefix — the
    byte-level BPE can split one codepoint across tokens, so a group
    closes exactly when its bytes no longer end in a truncated sequence
    the rest of the stream would complete;
  * word folding and punctuation gluing are expressed as boundary
    classification + anchor sweeps over copies.

The CrisperWhisper adjusted vocab (space is its own token, [UH]/[UM]
fillers — SURVEY.md §2.9, ref:README.md:281-283) is what makes the
space-boundary rule yield clean words.
"""

from __future__ import annotations

from typing import Sequence

from .languages import NO_SPACE_LANGUAGES
from .whisper_tokenizer import WhisperTokenizer

PREPEND_PUNCTUATIONS = "\"'“¡¿([{-"
APPEND_PUNCTUATIONS = "\"'.。,，!！?？:：”)]}、"
_PUNCT = "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
_REP = "�"


def _piece_bytes(tok: WhisperTokenizer, token: int) -> bytes:
    """Raw decoded bytes of one token: added/special tokens and timestamps
    render as their ASCII tags, text tokens resolve the GPT-2 byte-level
    indirection."""
    if token in tok.added_decoder:
        return tok.added_decoder[token].encode("utf-8")
    if tok.timestamp_begin is not None and token >= tok.timestamp_begin:
        t = (token - tok.timestamp_begin) * 0.02
        return f"<|{t:.2f}|>".encode("utf-8")
    piece = tok.bpe.decoder.get(token, "")
    return bytes(tok.bpe.byte_decoder[c] for c in piece)


def split_tokens_on_unicode(tok: WhisperTokenizer, tokens: Sequence[int]):
    """Minimal token runs whose concatenated bytes decode to complete
    unicode. A run stays open exactly while its decode ends in a
    replacement char that the full byte stream resolves to a real
    codepoint (i.e. the tail is a truncated multi-byte sequence)."""
    pieces = [_piece_bytes(tok, int(t)) for t in tokens]
    full_text = b"".join(pieces).decode("utf-8", errors="replace")
    words: list[str] = []
    word_tokens: list[list[int]] = []
    token_indices: list[list[int]] = []
    buf = bytearray()
    toks: list[int] = []
    idxs: list[int] = []
    offset = 0
    for k, t in enumerate(tokens):
        buf += pieces[k]
        toks.append(int(t))
        idxs.append(k)
        text = buf.decode("utf-8", errors="replace")
        bad = text.find(_REP)
        if bad == -1 or full_text[offset + bad] == _REP:
            words.append(text)
            word_tokens.append(toks)
            token_indices.append(idxs)
            buf, toks, idxs = bytearray(), [], []
            offset += len(text)
    return words, word_tokens, token_indices


def split_tokens_on_spaces(tok: WhisperTokenizer, tokens: Sequence[int]):
    """Fold unicode runs into words: a run opens a new word when it is a
    special token, carries a leading space, or is bare punctuation —
    otherwise it continues the previous word."""
    runs = zip(*split_tokens_on_unicode(tok, tokens))
    words: list[str] = []
    word_tokens: list[list[int]] = []
    token_indices: list[list[int]] = []
    for text, rtoks, ridx in runs:
        starts_word = (not words
                       or rtoks[0] >= tok.eot
                       or text.startswith(" ")
                       or text.strip() in _PUNCT)
        if starts_word:
            words.append(text)
            word_tokens.append(rtoks)
            token_indices.append(ridx)
        else:
            words[-1] += text
            word_tokens[-1] += rtoks
            token_indices[-1] += ridx
    return words, word_tokens, token_indices


def merge_punctuations(words, tokens, indices,
                       prepended=PREPEND_PUNCTUATIONS,
                       appended=APPEND_PUNCTUATIONS) -> None:
    """Glue floating opener punctuation onto the word after it and bare
    closer punctuation onto the word before it (in place).

    Membership tests are substring tests and emptied slots re-enter the
    closer sweep — deliberate quirk-compat with the HF contract
    (hf tokenization_whisper.py:1382-1417)."""
    n = len(words)
    w = list(words)
    t = [list(x) for x in tokens]
    x = [list(i) for i in indices]
    # opener sweep, right to left: " X"-style openers prepend onto the
    # nearest non-opener to their right
    anchor = n - 1
    for i in range(n - 2, -1, -1):
        if w[i].startswith(" ") and w[i].strip() in prepended:
            w[anchor] = w[i] + w[anchor]
            t[anchor][:0] = t[i]
            x[anchor][:0] = x[i]
            w[i], t[i], x[i] = "", [], []
        else:
            anchor = i
    # closer sweep, left to right: bare closers append onto the nearest
    # non-closer to their left (unless it already ends in a space)
    anchor = 0
    for j in range(1, n):
        if not w[anchor].endswith(" ") and w[j] in appended:
            w[anchor] += w[j]
            t[anchor] += t[j]
            x[anchor] += x[j]
            w[j], t[j], x[j] = "", [], []
        else:
            anchor = j
    words[:] = [v for v in w if v]
    tokens[:] = [v for v in t if v]
    indices[:] = [v for v in x if v]


def combine_tokens_into_words(tok: WhisperTokenizer, tokens: Sequence[int],
                              language: str | None = None,
                              prepend_punctuations=PREPEND_PUNCTUATIONS,
                              append_punctuations=APPEND_PUNCTUATIONS):
    if language is None:
        language = tok.language or "english"
    split = (split_tokens_on_unicode if language in NO_SPACE_LANGUAGES
             else split_tokens_on_spaces)
    words, word_tokens, token_indices = split(tok, tokens)
    merge_punctuations(words, word_tokens, token_indices,
                       prepend_punctuations, append_punctuations)
    return words, word_tokens, token_indices


def collate_word_timestamps(tok: WhisperTokenizer, tokens: Sequence[int],
                            token_timestamps: Sequence[tuple[float, float]],
                            language: str | None = None,
                            return_language: bool = False):
    """Per-word {"text", "timestamp": (first-token start, last-token end)}
    chunks (contract: hf tokenization_whisper.py:1285-1298)."""
    words, _, token_indices = combine_tokens_into_words(tok, tokens,
                                                        language)
    extra = {"language": language} if return_language else {}
    return [{"text": word,
             "timestamp": (token_timestamps[idx[0]][0],
                           token_timestamps[idx[-1]][1]),
             **extra}
            for word, idx in zip(words, token_indices)]
