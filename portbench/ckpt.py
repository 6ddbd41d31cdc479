"""A weightless checkpoint directory for a configuration.

The benchmark's own copy of the port's ``testing.write_large_v3_configs``
and its vocabulary rule: every id below <|endoftext|> decodes to a
space-led word (the 256 byte symbols first), so host post-processing of
random-weight tokens costs what it would on real ones. The special tokens
take the multilingual layout of ``config.SpecialTokens``'s defaults.
The weights come from ``weights.make`` and reach the pipeline as
``params``; no safetensors file is written.
"""

from __future__ import annotations

import json
import os

EOT, SOT = 50257, 50258
LANGUAGE_BEGIN, NUM_LANGUAGES = 50259, 99
TRANSLATE, TRANSCRIBE, SOT_PREV, NO_SPEECH, NO_TIMESTAMPS = (
    50358, 50359, 50361, 50362, 50363)
TIMESTAMP_BEGIN = 50364

LANGUAGE_CODES = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
]


def language_token(code: str) -> int:
    return LANGUAGE_BEGIN + LANGUAGE_CODES.index(code)


def prompt_ids(language: str, timestamps: bool) -> list[int]:
    """The decoder prompt of one window: <|startoftranscript|>, the
    language, <|transcribe|>, and <|notimestamps|> without segment
    timestamps."""
    ids = [SOT, language_token(language), TRANSCRIBE]
    return ids if timestamps else ids + [NO_TIMESTAMPS]


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _base36(n: int) -> str:
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    out = ""
    while True:
        out = digits[n % 36] + out
        n //= 36
        if n == 0:
            return out


def text_pieces() -> list[bytes]:
    """The bytes of every text id (< <|endoftext|>) in ``write``'s
    vocabulary: the 256 byte symbols, then " w<base36 id>"."""
    byte_of = {c: b for b, c in bytes_to_unicode().items()}
    pieces = [bytes([byte_of[c]]) for c in bytes_to_unicode().values()]
    pieces += [b" w" + _base36(i).encode("ascii")
               for i in range(len(pieces), EOT)]
    return pieces


def _write_json(path: str, obj) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False)


def write(path: str, hf_config: dict, alignment_heads: list) -> str:
    """The checkpoint directory of ``hf_config`` (the configuration file's
    published keys) with its alignment heads; returns ``path``."""
    os.makedirs(path, exist_ok=True)
    vocab = {tok: i for i, tok in enumerate(bytes_to_unicode().values())}
    for i in range(len(vocab), EOT):
        vocab[f"Ġw{_base36(i)}"] = i
    added = {"<|endoftext|>": EOT, "<|startoftranscript|>": SOT}
    for j, code in enumerate(LANGUAGE_CODES[:NUM_LANGUAGES]):
        added[f"<|{code}|>"] = LANGUAGE_BEGIN + j
    added.update({"<|translate|>": TRANSLATE, "<|transcribe|>": TRANSCRIBE,
                  "<|startofprev|>": SOT_PREV, "<|nospeech|>": NO_SPEECH,
                  "<|notimestamps|>": NO_TIMESTAMPS})
    _write_json(os.path.join(path, "vocab.json"), vocab)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
    _write_json(os.path.join(path, "added_tokens.json"), added)
    _write_json(os.path.join(path, "config.json"), hf_config)
    _write_json(os.path.join(path, "generation_config.json"), {
        "alignment_heads": [list(h) for h in alignment_heads],
        "max_initial_timestamp_index": 50,
        "no_timestamps_token_id": NO_TIMESTAMPS,
        "eos_token_id": EOT, "pad_token_id": EOT,
        "decoder_start_token_id": SOT, "is_multilingual": True})
    _write_json(os.path.join(path, "preprocessor_config.json"), {
        "feature_size": hf_config["num_mel_bins"], "sampling_rate": 16000,
        "n_fft": 400, "hop_length": 160, "chunk_length": 30})
    return path
