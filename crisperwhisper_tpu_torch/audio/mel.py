"""Whisper log-mel spectrogram frontend on ``torch.stft``.

Port of crisperwhisper_tpu/audio/mel.py. Parity contract: hf
feature_extraction_whisper.py:138-167 — hann(400) window, hop 160,
centered reflect-padded STFT, final frame dropped, power spectrum, slaney
mel filterbank, log10 with a 1e-10 floor, dynamic-range clip at max - 8,
affine (x + 4) / 4.

The DFT is cuFFT/pocketfft in true float32 (the reference runs its
matmul DFT at Precision.HIGHEST); the mel projection is an f32 matmul,
which PyTorch keeps out of TF32 unless a caller turns
``torch.backends.cuda.matmul.allow_tf32`` on.

``pad_or_trim`` and ``zero_mean_unit_var_norm`` are the reference's host
numpy functions, copied statement for statement.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FeatureConfig


def hertz_to_mel_slaney(freq):
    """Slaney-style mel scale (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    # the 0 Hz bin takes the linear branch; keep log() off it so no
    # divide-by-zero RuntimeWarning leaks into logs
    safe = np.where(freq >= min_log_hertz, freq, min_log_hertz)
    return np.where(freq >= min_log_hertz,
                    min_log_mel + np.log(safe / min_log_hertz) * logstep,
                    mels)


def mel_to_hertz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(mels >= min_log_mel,
                    1000.0 * np.exp(logstep * (mels - min_log_mel)),
                    freq)


@functools.lru_cache(maxsize=8)
def mel_filter_bank(num_frequency_bins: int = 201, num_mel_filters: int = 80,
                    min_frequency: float = 0.0, max_frequency: float = 8000.0,
                    sampling_rate: int = 16000) -> np.ndarray:
    """Triangular slaney-normalized slaney-scale mel bank, [n_freq, n_mels]
    (hf audio_utils.py:440 mel_filter_bank(norm="slaney",
    mel_scale="slaney"))."""
    mel_min = hertz_to_mel_slaney(min_frequency)
    mel_max = hertz_to_mel_slaney(max_frequency)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = mel_to_hertz_slaney(mel_freqs)

    fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)

    filter_diff = np.diff(filter_freqs)
    slopes = np.expand_dims(filter_freqs, 0) - np.expand_dims(fft_freqs, 1)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))

    # slaney area normalization
    enorm = 2.0 / (filter_freqs[2: num_mel_filters + 2] -
                   filter_freqs[:num_mel_filters])
    fb = fb * np.expand_dims(enorm, 0)
    return fb.astype(np.float32)


def log_mel_spectrogram(waveform: torch.Tensor,
                        cfg: FeatureConfig = FeatureConfig(),
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[..., n_samples] f32 (exactly one window) -> [..., n_mels, frames]
    log-mel features on the waveform's device."""
    if waveform.shape[-1] != cfg.n_samples:
        raise ValueError(
            f"expected {cfg.n_samples} samples ({cfg.chunk_length} s), got "
            f"{waveform.shape[-1]}; pad/trim upstream")
    lead = waveform.shape[:-1]
    x = waveform.reshape(-1, cfg.n_samples).float()
    window = torch.hann_window(cfg.n_fft, periodic=True, dtype=torch.float32,
                               device=x.device)
    spec = torch.stft(x, cfg.n_fft, hop_length=cfg.hop_length,
                      window=window, center=True, pad_mode="reflect",
                      return_complex=True)            # [N, n_freq, frames+1]
    spec = spec[..., :-1]
    power = spec.real.square() + spec.imag.square()
    n_bins = cfg.n_fft // 2 + 1
    fb = torch.from_numpy(mel_filter_bank(n_bins, cfg.feature_size, 0.0,
                                          8000.0, cfg.sampling_rate)
                          ).to(x.device)
    mel = torch.matmul(fb.T, power)                   # [N, n_mels, frames]
    log_spec = torch.log10(mel.clamp_min(1e-10))
    max_val = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.reshape(*lead, *log_spec.shape[-2:]).to(dtype)


def pad_or_trim(waveform: np.ndarray, n_samples: int) -> np.ndarray:
    """Host-side pad/trim of raw audio to the static window length."""
    t = waveform.shape[-1]
    if t >= n_samples:
        return waveform[..., :n_samples]
    pad = [(0, 0)] * (waveform.ndim - 1) + [(0, n_samples - t)]
    return np.pad(waveform, pad)


def extract_features(waveform: torch.Tensor,
                     cfg: FeatureConfig = FeatureConfig(),
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched frontend entry point: [B, n_samples] -> [B, n_mels, frames]."""
    return log_mel_spectrogram(waveform, cfg, dtype)


def zero_mean_unit_var_norm(waveform: np.ndarray,
                            length: int | None = None,
                            padding_value: float = 0.0) -> np.ndarray:
    """Optional per-utterance normalization over the true (unpadded)
    region (hf feature_extraction_whisper.py:169-190 `do_normalize`)."""
    n = length if length is not None else waveform.shape[-1]
    true = waveform[..., :n]
    mean = true.mean(axis=-1, keepdims=True)
    var = true.var(axis=-1, keepdims=True)
    out = (waveform - mean) / np.sqrt(var + 1e-7)
    if length is not None and length < waveform.shape[-1]:
        out[..., length:] = padding_value
    return out
