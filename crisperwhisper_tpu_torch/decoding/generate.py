"""Init-token prompt for a decode batch.

Port of crisperwhisper_tpu/decoding/generate.py::build_prompt (host-side
numpy, the code unchanged). ``generate_short_form`` is not
ported: the pipeline's path is the seek loop (decoding/longform.py).
"""

from __future__ import annotations

import numpy as np

from ..config import SpecialTokens


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
