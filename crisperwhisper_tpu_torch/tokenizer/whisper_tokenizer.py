"""Whisper tokenizer: specials, timestamps, prefix builder, decode.

Behavioral port of hf models/whisper/tokenization_whisper.py (decode paths
only are hot; cited per method). Works off a local checkpoint dir
containing vocab.json / merges.txt / added_tokens.json (and optionally
tokenizer_config.json with added_tokens_decoder), including the
CrisperWhisper *adjusted* vocabulary where space is its own token and
[UH]/[UM] filler tokens exist (SURVEY.md §2.9).
"""

from __future__ import annotations

import json
import os
import re
from typing import Sequence

import numpy as np

from .bpe import ByteLevelBPE
from .languages import LANGUAGE_CODES, LANGUAGES, TO_LANGUAGE_CODE

# the timestamp-token surface form HF's _filter_timestamp_ids strips
_TIMESTAMP_RE = re.compile(r"<\|\d+\.\d+\|>")



class WhisperTokenizer:
    def __init__(self, bpe: ByteLevelBPE,
                 added_tokens: dict[str, int] | None = None,
                 language: str | None = None,
                 task: str | None = None,
                 predict_timestamps: bool = True,
                 special_added: set[str] | None = None):
        """special_added: which added tokens are SPECIAL (skipped by
        skip_special_tokens=True and counted in all_special_ids). None
        (default) marks every added token special — the vanilla whisper
        checkpoint layout, where added_tokens.json holds exactly the
        control tokens. CrisperWhisper-style filler tokens ([UH]/[UM])
        registered as NON-special added tokens (hf added_tokens_decoder
        "special": false) must be excluded here so they survive
        skip_special_tokens=True and don't shift timestamp_begin
        (hf tokenization_utils.py added-token specialness contract)."""
        self.bpe = bpe
        self.added_tokens = dict(added_tokens or {})
        self.added_decoder = {v: k for k, v in self.added_tokens.items()}
        self.added_special = (set(self.added_tokens)
                              if special_added is None
                              else set(special_added))
        self.language = language
        self.task = task
        self.predict_timestamps = predict_timestamps

        def _find(tok: str) -> int | None:
            if tok in self.added_tokens:
                return self.added_tokens[tok]
            return self.bpe.encoder.get(tok)

        self.eot = _find("<|endoftext|>")
        self.sot = _find("<|startoftranscript|>")
        self.translate = _find("<|translate|>")
        self.transcribe = _find("<|transcribe|>")
        self.sot_prev = _find("<|startofprev|>")
        self.no_timestamps = _find("<|notimestamps|>")
        self.no_speech = (_find("<|nospeech|>")
                          if _find("<|nospeech|>") is not None
                          else (self.no_timestamps - 1
                                if self.no_timestamps else None))
        # special ids: the added tokens flagged special plus eot;
        # timestamp tokens live above all of them. Non-special added
        # tokens (verbatim fillers) are deliberately excluded — they are
        # vocabulary, not control tokens.
        special_ids = {self.added_tokens[t] for t in self.added_special
                       if t in self.added_tokens}
        if self.eot is not None:
            special_ids.add(self.eot)
        self.all_special_ids: list[int] = sorted(special_ids)
        self.timestamp_begin = (self.all_special_ids[-1] + 1
                                if self.all_special_ids else None)
        self.language_tokens = {
            code: (self.sot + 1 + i) if self.sot is not None else None
            for i, code in enumerate(LANGUAGE_CODES)}
        self.id_to_language_code = {v: k for k, v
                                    in self.language_tokens.items()}

    # --- construction -----------------------------------------------------
    @classmethod
    def from_dir(cls, model_dir: str, **kw) -> "WhisperTokenizer":
        bpe = ByteLevelBPE.from_dir(model_dir)
        added: dict[str, int] = {}
        # Specialness per added token: legacy added_tokens.json carries no
        # flag — default special=True (the vanilla whisper layout, where
        # that file is exactly the control-token set); explicit
        # "special" flags in tokenizer_config.json's added_tokens_decoder
        # override (hf tokenization_utils_base.from_pretrained), and
        # special_tokens_map.json entries force special=True.
        flags: dict[str, bool] = {}
        at_path = os.path.join(model_dir, "added_tokens.json")
        if os.path.exists(at_path):
            with open(at_path, encoding="utf-8") as f:
                legacy = json.load(f)
            added.update(legacy)
            flags.update({t: True for t in legacy})
        elif os.path.exists(os.path.join(model_dir, "tokenizer.json")):
            # fast-format-only export: added tokens live in the top-level
            # "added_tokens" array of tokenizer.json ([{id, content,
            # special}, ...]) — same data hf's fast tokenizer reads.
            with open(os.path.join(model_dir, "tokenizer.json"),
                      encoding="utf-8") as f:
                fast = json.load(f)
            for spec in fast.get("added_tokens", []):
                added[spec["content"]] = int(spec["id"])
                flags[spec["content"]] = bool(spec.get("special", True))
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            for idx, spec in cfg.get("added_tokens_decoder", {}).items():
                added[spec["content"]] = int(idx)
                flags[spec["content"]] = bool(spec.get("special", True))
            kw.setdefault("language", cfg.get("language"))
            kw.setdefault("task", cfg.get("task"))
        map_path = os.path.join(model_dir, "special_tokens_map.json")
        if os.path.exists(map_path):
            with open(map_path, encoding="utf-8") as f:
                smap = json.load(f)
            for v in smap.values():
                for entry in (v if isinstance(v, list) else [v]):
                    content = (entry["content"] if isinstance(entry, dict)
                               else entry)
                    if content in added:
                        flags[content] = True
        kw.setdefault("special_added",
                      {t for t, special in flags.items() if special})
        return cls(bpe, added, **kw)

    # --- vocabulary helpers -------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.bpe.encoder)

    def token_to_id(self, token: str) -> int | None:
        if token in self.added_tokens:
            return self.added_tokens[token]
        return self.bpe.encoder.get(token)

    def id_to_token(self, idx: int) -> str:
        if idx in self.added_decoder:
            return self.added_decoder[idx]
        if self.timestamp_begin is not None and idx >= self.timestamp_begin:
            return f"<|{(idx - self.timestamp_begin) * 0.02:.2f}|>"
        return self.bpe.decoder.get(idx, "")

    def language_token_id(self, language: str) -> int:
        lang = language.lower()
        code = TO_LANGUAGE_CODE.get(lang, lang)
        if code not in self.language_tokens:
            raise ValueError(f"unsupported language: {language}")
        return self.language_tokens[code]

    # --- prefix (init) tokens (tokenization_whisper.py:406-438) -----------
    def prefix_tokens(self) -> list[int]:
        seq = [self.sot]
        if self.language is not None:
            seq.append(self.language_token_id(self.language))
        if self.task is not None:
            seq.append(self.transcribe if self.task == "transcribe"
                       else self.translate)
        if not self.predict_timestamps:
            seq.append(self.no_timestamps)
        return seq

    # --- encode -------------------------------------------------------------
    def encode(self, text: str) -> list[int]:
        """BPE-encode, recognizing added tokens embedded in the text.

        hf's tokenize() splits the input on the added-token vocabulary
        BEFORE byte-level BPE runs (tokenization_utils.py tokens_trie
        split), so '<|startoftranscript|>' or an added '[UH]' filler maps
        to its single id rather than byte pieces. Longest-match split,
        matching the trie's behavior for plain (no lstrip/rstrip)
        added tokens."""
        if not self.added_tokens:
            return self.bpe.encode(text)
        ordered = sorted(self.added_tokens, key=len, reverse=True)
        out: list[int] = []
        start = 0
        i = 0
        n = len(text)
        while i < n:
            for tok in ordered:
                if text.startswith(tok, i):
                    if start < i:
                        out.extend(self.bpe.encode(text[start:i]))
                    out.append(self.added_tokens[tok])
                    i += len(tok)
                    start = i
                    break
            else:
                i += 1
        if start < n:
            out.extend(self.bpe.encode(text[start:]))
        return out

    def get_prompt_ids(self, text: str) -> np.ndarray:
        """Convert prompt text to ids for generate(prompt_ids=...)
        (tokenization_whisper.py:865-877): [<|startofprev|>, *ids of
        ' ' + text.strip()]. Raises on text that maps to any special or
        timestamp token — prompts must be plain vocabulary."""
        ids = self.encode(" " + text.strip())
        if self.all_special_ids:
            first_special = self.all_special_ids[0]
            bad = next((t for t in ids if t >= first_special), None)
            if bad is not None:
                raise ValueError(
                    "Encountered text in the prompt corresponding to "
                    f"disallowed special token: {self.id_to_token(bad)}.")
        return np.asarray([self.sot_prev] + list(ids), np.int32)

    # --- decode (tokenization_whisper.py:675-792) ---------------------------
    def decode(self, token_ids: Sequence[int],
               skip_special_tokens: bool = False,
               decode_with_timestamps: bool = False,
               time_precision: float = 0.02,
               segment_size: int = 1500) -> str:
        ids = [int(t) for t in token_ids]
        if decode_with_timestamps:
            return self._decode_with_timestamps(
                ids, skip_special_tokens, time_precision, segment_size)
        parts: list[str] = []
        pending: list[int] = []
        special_set = set(self.all_special_ids)
        for t in ids:
            if self.timestamp_begin is not None and t >= self.timestamp_begin:
                # Timestamps are ignored by decode() — but HF strips them
                # by PATTERN on the rendered string (_filter_timestamp_ids
                # regex), so an ADDED token whose id happens to live above
                # the timestamp block (tokenizer.add_tokens appends at
                # len(vocab)) still renders (and then loses any embedded
                # timestamp-shaped substring to the regex pass below).
                if t not in self.added_decoder:
                    continue
            if t in special_set or t in self.added_decoder:
                if pending:
                    parts.append(self.bpe.decode(pending))
                    pending = []
                if t not in special_set:
                    # non-special added token (e.g. a [UH]/[UM] verbatim
                    # filler): vocabulary, not a control token — rendered
                    # as its literal string regardless of
                    # skip_special_tokens (hf convert_ids_to_tokens only
                    # filters all_special_ids)
                    parts.append(self.added_decoder[t])
                elif not skip_special_tokens:
                    parts.append(self.added_decoder.get(t, ""))
            else:
                pending.append(t)
        if pending:
            parts.append(self.bpe.decode(pending))
        # HF strips timestamp-SHAPED substrings from the final rendered
        # string (_filter_timestamp_ids, tokenization_whisper.py:745):
        # literal '<|1.23|>' text spelled by ordinary BPE tokens, or
        # embedded inside a longer added-token string, is stripped too —
        # not just real timestamp ids (ADVICE r4 item 1).
        return _TIMESTAMP_RE.sub("", "".join(parts))

    def _decode_with_timestamps(self, token_ids: list[int],
                                skip_special_tokens: bool,
                                time_precision: float,
                                segment_size: int) -> str:
        """Timestamp-annotated decode with >30 s segment rollover
        (tokenization_whisper.py:533-573)."""
        timestamp_begin = self.timestamp_begin
        outputs: list = [[]]
        cur_max_timestamp = 0.0
        prev_segments_len = 0.0
        penultimate_timestamp = 0.0
        for i, token in enumerate(token_ids):
            if token >= timestamp_begin:
                timestamp = float((token - timestamp_begin) * time_precision)
                if timestamp < cur_max_timestamp:
                    # next segment started
                    last_was_single_ending = i >= 2 and not (
                        token_ids[i - 1] >= timestamp_begin
                        and token_ids[i - 2] >= timestamp_begin)
                    if last_was_single_ending:
                        prev_segments_len += time_precision * segment_size
                    else:
                        cur_max_timestamp = penultimate_timestamp
                        prev_segments_len += penultimate_timestamp
                        outputs = outputs[:-2]
                penultimate_timestamp = cur_max_timestamp
                cur_max_timestamp = timestamp
                outputs.append(f"<|{(timestamp + prev_segments_len):.2f}|>")
                outputs.append([])
            else:
                outputs[-1].append(token)
        return "".join(
            s if isinstance(s, str)
            else self.decode(s, skip_special_tokens=skip_special_tokens)
            for s in outputs)

    # --- misc helpers -------------------------------------------------------
    def strip_prompt(self, token_ids: list[int]) -> list[int]:
        """Drop a leading <|startofprev|>...<|startoftranscript|> prompt
        (tokenization_whisper.py:879 _strip_prompt)."""
        if not token_ids or token_ids[0] != self.sot_prev:
            return token_ids
        if self.sot in token_ids:
            return token_ids[token_ids.index(self.sot):]
        return []

    def compute_offsets(self, token_ids: Sequence[int],
                        time_precision: float = 0.02,
                        segment_size: int = 1500) -> list[dict]:
        """Segment offsets from paired timestamps with rollover
        (tokenization_whisper.py:575-641)."""
        ids = [int(t) for t in token_ids]
        offsets = []
        ts_begin = self.timestamp_begin
        start_idx = None
        start_time = None
        cur_max_timestamp = 0.0
        prev_segments_len = 0.0
        penultimate_timestamp = 0.0
        i = 0
        n = len(ids)
        while i < n:
            t = ids[i]
            if t >= ts_begin:
                timestamp = (t - ts_begin) * time_precision
                if timestamp < cur_max_timestamp:
                    last_was_single_ending = i >= 2 and not (
                        ids[i - 1] >= ts_begin and ids[i - 2] >= ts_begin)
                    if last_was_single_ending:
                        prev_segments_len += time_precision * segment_size
                    else:
                        cur_max_timestamp = penultimate_timestamp
                        prev_segments_len += penultimate_timestamp
                penultimate_timestamp = cur_max_timestamp
                cur_max_timestamp = timestamp
                if start_idx is None:
                    start_idx, start_time = i, timestamp + prev_segments_len
                else:
                    text_ids = [x for x in ids[start_idx + 1:i]
                                if x < ts_begin]
                    offsets.append({
                        "text": self.decode(text_ids,
                                            skip_special_tokens=True),
                        "timestamp": (start_time,
                                      timestamp + prev_segments_len)})
                    start_idx, start_time = None, None
            i += 1
        return offsets


__all__ = ["WhisperTokenizer", "LANGUAGES", "TO_LANGUAGE_CODE"]
