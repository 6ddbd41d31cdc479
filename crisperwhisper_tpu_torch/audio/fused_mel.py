"""Fused log-mel frontend: the hand-written CUDA kernel and its plain twin.

Port of crisperwhisper_tpu/audio/pallas_mel.py (``pallas_log_mel``).
``fused_log_mel`` maps [B, n_samples] windows to [B, n_mels, n_frames]
features, the result of ``audio.mel.extract_features``, by another route:
the windowed 400-point real DFT as a product with a cos/sin basis, then
the power, the mel projection and log10, in one launch of
``csrc/log_mel.cu`` for CUDA tensors. CPU tensors take ``log_mel_plain``,
the same algebra in PyTorch (reflect padding and ``unfold`` for the
frames, f32 ``torch.matmul`` against the same basis and bank). The max-8
clip and the affine step run outside the kernel, as in the reference.

The basis is the reference's ``_padded_basis`` (window * cos, window *
-sin, built in float64 and stored f32) without the TPU's 512-lane padding:
[n_fft, 2, n_bins]. No pipeline of the port calls it (nor does the
reference's): ``extract_features`` keeps ``torch.stft``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..config import FeatureConfig
from .mel import mel_filter_bank


def _basis_np(n_fft: int) -> np.ndarray:
    """[n_fft, 2, n_fft // 2 + 1] windowed DFT basis: window * cos and
    window * -sin of every tap and bin (the reference's _padded_basis,
    unpadded)."""
    n_bins = n_fft // 2 + 1
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    ang = 2.0 * np.pi * np.outer(np.arange(n_fft, dtype=np.float64),
                                 np.arange(n_bins, dtype=np.float64)) / n_fft
    basis = np.stack([np.cos(ang) * window[:, None],
                      -np.sin(ang) * window[:, None]], axis=1)
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _tables(cfg: FeatureConfig, device: torch.device
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(basis [n_fft, 2, n_bins], mel bank [n_bins, n_mels]), f32, once
    per config and device."""
    n_bins = cfg.n_fft // 2 + 1
    fb = mel_filter_bank(n_bins, cfg.feature_size, 0.0, 8000.0,
                         cfg.sampling_rate)
    return (torch.from_numpy(_basis_np(cfg.n_fft)).to(device),
            torch.from_numpy(fb).to(device))


def _check(waveform: torch.Tensor, cfg: FeatureConfig) -> None:
    if waveform.dim() != 2 or waveform.shape[-1] != cfg.n_samples:
        raise ValueError(f"expected [B, {cfg.n_samples}] samples "
                         f"({cfg.chunk_length} s windows), got "
                         f"{tuple(waveform.shape)}; pad/trim to the static "
                         "window first")


def _clip_affine(log_spec: torch.Tensor) -> torch.Tensor:
    """The dynamic-range clip at each window's max - 8, then (x + 4) / 4
    (feature_extraction_whisper.py:155-157)."""
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0


def fused_log_mel(waveform: torch.Tensor,
                  cfg: FeatureConfig = FeatureConfig()) -> torch.Tensor:
    """[B, n_samples] -> [B, n_mels, n_frames] f32 log-mel features: one
    launch of the kernel for a CUDA tensor (the plain twin for a CPU
    tensor), then the clip and the affine step. Raises unless every window
    holds exactly ``cfg.n_samples`` samples."""
    if waveform.device.type == "cpu":
        return log_mel_plain(waveform, cfg)
    _check(waveform, cfg)
    if waveform.device.type != "cuda":
        raise ValueError(f"fused_log_mel: unsupported device "
                         f"{waveform.device}")
    if waveform.dtype != torch.float32 or not waveform.is_contiguous():
        raise ValueError("fused_log_mel: the waveform must be a contiguous "
                         f"float32 tensor on the card, got {waveform.dtype}")
    b = waveform.shape[0]
    n_frames = cfg.n_samples // cfg.hop_length
    basis, fb = _tables(cfg, waveform.device)
    out = torch.empty((b, cfg.feature_size, n_frames), dtype=torch.float32,
                      device=waveform.device)
    stream = torch.cuda.current_stream(waveform.device).cuda_stream
    with torch.cuda.device(waveform.device):
        err = _build.kernels().lib.cw_log_mel(
            waveform.data_ptr(), basis.data_ptr(), fb.data_ptr(),
            out.data_ptr(), b, cfg.n_samples, n_frames, cfg.n_fft,
            cfg.hop_length, basis.shape[-1], cfg.feature_size, stream)
    _build.check(err, "fused_log_mel")
    fused_log_mel.launches += 1
    return _clip_affine(out)


fused_log_mel.launches = 0


def log_mel_plain(waveform: torch.Tensor,
                  cfg: FeatureConfig = FeatureConfig()) -> torch.Tensor:
    """The kernel's plain twin, whatever the device: frames by reflect
    padding and ``unfold``, f32 products against the same basis and bank,
    then the clip and the affine step as in ``fused_log_mel``."""
    _check(waveform, cfg)
    x = waveform.float()
    pad = cfg.n_fft // 2
    n_frames = cfg.n_samples // cfg.hop_length
    padded = torch.nn.functional.pad(x[:, None], (pad, pad),
                                     mode="reflect")[:, 0]
    frames = padded.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :n_frames]
    basis, fb = _tables(cfg, x.device)
    n_bins = basis.shape[-1]
    spec = torch.matmul(frames, basis.reshape(cfg.n_fft, 2 * n_bins))
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    mel = torch.matmul(power, fb)                    # [B, n_frames, n_mels]
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10)).transpose(1, 2)
    return _clip_affine(log_spec)
