"""Interactive transcription app on the card — the ref:app.py equivalent
(port of crisperwhisper_tpu/app.py).

The reusable pieces (audio normalization, VTT subtitle rendering, black-
video muxing, HTML transcript, the app's pipeline) are copies of the
originals, function for function (tests/test_torch_pipeline.py pins
them); the Streamlit UI is import-gated so the module works headless.
The pipeline runs on the CUDA card (``hub.load_pipeline``'s default).
Run with:

    streamlit run -m crisperwhisper_tpu_torch.app -- --model_id /path/to/ckpt

Behavioral notes vs the reference:
  * process_audio_bytes mirrors ref:app.py:85-96 — z-score normalize,
    divide by 8, resample to 16 kHz (scipy polyphase instead of
    torchaudio).
  * timestamps_to_vtt mirrors ref:app.py:74-82.
  * the app sets median_filter_width=3 like ref:app.py:41.
  * like the reference app, pause adjustment is NOT applied (only the
    README's library recipe uses it, SURVEY.md §3.3 note).
"""

from __future__ import annotations

import argparse
import html
import os
import shutil
import subprocess
import tempfile
from typing import Any

import numpy as np


def process_audio_bytes(audio_bytes: bytes,
                        target_sr: int = 16000) -> np.ndarray:
    """audio bytes -> normalized mono f32 at target_sr (ref:app.py:85-96).

    Accepts the `streamlit_mic_recorder` output contract (WAV bytes from
    `audio["bytes"]`, ref:app.py:121-139) as well as uploaded files; any
    non-RIFF container is decoded through the ffmpeg path."""
    from .audio.io import ffmpeg_read, read_wav, resample
    if audio_bytes[:4] == b"RIFF":
        sr, waveform = read_wav(audio_bytes)
    else:
        waveform = ffmpeg_read(audio_bytes, target_sr)
        sr = target_sr
    waveform = waveform.astype(np.float32)
    std = waveform.std()
    waveform = (waveform - waveform.mean()) / max(std, 1e-8)
    waveform = waveform / 8.0
    return resample(waveform, sr, target_sr)


def _fmt_ts(seconds: float) -> str:
    h = int(seconds // 3600)
    m = int((seconds % 3600) // 60)
    s = seconds % 60
    return f"{h:02d}:{m:02d}:{s:06.3f}"


def timestamps_to_vtt(chunks: list[dict[str, Any]]) -> str:
    """Word chunks -> WebVTT subtitles (ref:app.py:74-82)."""
    lines = ["WEBVTT", ""]
    for c in chunks:
        start, end = c["timestamp"]
        if start is None or end is None:
            continue
        lines.append(f"{_fmt_ts(float(start))} --> {_fmt_ts(float(end))}")
        lines.append(c["text"].strip())
        lines.append("")
    return "\n".join(lines)


def transcript_html(chunks: list[dict[str, Any]]) -> str:
    """Clickable word-level transcript (ref:app.py HTML rendering)."""
    spans = []
    for c in chunks:
        start, end = c["timestamp"]
        spans.append(
            f'<span data-start="{start}" data-end="{end}" '
            f'title="{start:.2f}s – {end:.2f}s">'
            f"{html.escape(c['text'])}</span>")
    return "<div class='transcript'>" + "".join(spans) + "</div>"


def wav_to_black_mp4(wav_path: str, mp4_path: str) -> str | None:
    """Mux audio onto a black video via ffmpeg (ref:app.py:64-71 used
    moviepy, which shells out to ffmpeg anyway). Returns None when no
    ffmpeg binary is available."""
    if shutil.which("ffmpeg") is None:
        return None
    cmd = ["ffmpeg", "-y", "-f", "lavfi", "-i", "color=c=black:s=320x240",
           "-i", wav_path, "-shortest", "-c:v", "libx264", "-c:a", "aac",
           mp4_path]
    subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    return mp4_path


def build_app_pipeline(model_id: str):
    """Pipeline with the app's overrides (median_filter_width=3)."""
    from .hub import load_pipeline
    return load_pipeline(model_id, median_filter_width=3)


def main() -> None:
    try:
        import streamlit as st
    except ImportError as e:
        raise SystemExit(
            "streamlit is not installed; the app's building blocks "
            "(process_audio_bytes, timestamps_to_vtt, transcript_html, "
            "wav_to_black_mp4) are importable without it") from e

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_id", type=str, required=True)
    args, _ = parser.parse_known_args()

    @st.cache_resource
    def _pipe():
        return build_app_pipeline(args.model_id)

    st.title("Verbatim transcription")
    st.write("🎙️ Record audio to transcribe or 📁 upload an audio file.")

    # Mic recording (ref:app.py:121-139): the component returns a dict
    # whose "bytes" field is WAV-encoded audio. Import-gated — the rest
    # of the app works without the component installed.
    audio_bytes: bytes | None = None
    try:
        from streamlit_mic_recorder import mic_recorder
        rec = mic_recorder(start_prompt="Start recording",
                           stop_prompt="Stop recording",
                           just_once=False, format="wav")
        if rec:
            audio_bytes = rec["bytes"]
    except ImportError:
        st.caption("(mic recording unavailable: `streamlit_mic_recorder` "
                   "is not installed)")

    uploaded = st.file_uploader("Or upload an audio file",
                                type=["wav", "mp3", "ogg"])
    if uploaded is not None:
        audio_bytes = uploaded.getvalue()

    if audio_bytes:
        audio = process_audio_bytes(audio_bytes)
        try:
            result = _pipe()({"raw": audio, "sampling_rate": 16000},
                             return_timestamps="word")
        except Exception as e:          # ref:app.py:161 st.error
            st.error(f"Transcription failed: {e}")
            return
        st.subheader("Transcript")
        st.markdown(transcript_html(result["chunks"]),
                    unsafe_allow_html=True)
        vtt = timestamps_to_vtt(result["chunks"])
        st.download_button("Download .vtt subtitles", vtt,
                           file_name="subtitles.vtt")
        with tempfile.TemporaryDirectory() as td:
            from scipy.io import wavfile
            wav_path = os.path.join(td, "sample.wav")
            wavfile.write(wav_path, 16000,
                          (audio * 32767).astype(np.int16))
            mp4 = wav_to_black_mp4(wav_path, os.path.join(td, "out.mp4"))
            if mp4:
                st.video(mp4, subtitles={"words": vtt})


if __name__ == "__main__":
    main()
