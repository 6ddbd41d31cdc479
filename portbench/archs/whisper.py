"""The Whisper encoder-decoder: CrisperWhisper and every Whisper geometry
that ``WhisperArch.from_hf_config`` reads.

The architecture file of every configuration whose published
``model_type`` is ``whisper``. Thin adapters over the benchmark's Whisper code: the shapes, the
weights (``weights.py``), the weightless checkpoint and prompt
(``ckpt.py``), the reference check (``check.compare`` over
``reference/``), the operation and byte counts (``work.py``) and the
text vocabulary (``ckpt.text_pieces``).
"""

from __future__ import annotations

from portbench import check, ckpt, harness
from portbench import weights as _weights
from portbench import work  # noqa: F401  (the readers' ctx.work)


def arch(cfg: dict):
    from crisperwhisper_tpu_torch.config import WhisperArch
    return WhisperArch.from_hf_config(cfg)


def weights(arch, seed: int, device, dtype) -> dict:
    return _weights.make(arch, seed, device, dtype)


def checkpoint(path: str, cfg: dict) -> str:
    return ckpt.write(path, harness.hf_config(cfg), cfg["alignment_heads"])


def prompt_ids(mix: dict) -> list[int]:
    return ckpt.prompt_ids(mix["language"],
                           bool(mix["generation"]["return_timestamps"]))


def compare(params: dict, arch, cfg: dict, windows: list, audio: list,
            prompt: list[int], mix: dict, mode: str, device,
            control: str | None) -> dict:
    """``check.compare``; the token times (alignment heads, median filter,
    DTW) only where the mix asks for word times."""
    word = mix["generation"]["return_token_timestamps"]
    return check.compare(
        params, arch, windows, audio, prompt, mix.get("suppress_ids_from"),
        cfg["alignment_heads"] if word else None, cfg["median_filter_width"],
        mode, device, control=control)


text_pieces = ckpt.text_pieces
