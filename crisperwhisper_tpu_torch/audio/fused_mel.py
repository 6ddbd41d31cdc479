"""Fused log-mel frontend: the hand-written CUDA kernel and its plain twin.

Port of crisperwhisper_tpu/audio/pallas_mel.py (``pallas_log_mel``).
``fused_log_mel`` maps [B, n_samples] windows to [B, n_mels, n_frames]
features, the result of ``audio.mel.extract_features``, by another route:
for CUDA tensors, two launches of ``csrc/log_mel.cu``: the windowed
400-point real DFT as a 200-point complex FFT of the even/odd-packed
frame (radix 5, 5, 8) with its post-twiddle, the power, a mel sum over
each band's range of nonzero bank weights, log10 and each window's
maximum; then the max-8 clip and the affine step in place. CPU tensors
take ``log_mel_plain``, the same function in PyTorch (reflect padding and
``unfold`` for the frames, f32 ``torch.matmul`` against the dense
windowed DFT basis and bank, the clip and the affine step).

The host tables (each built once per config and device, in float64 and
stored f32): the plain twin's basis, the reference's ``_padded_basis``
(window * cos, window * -sin) without the TPU's 512-lane padding:
[n_fft, 2, n_bins]; the kernel's FFT table (``_fft_table_np``) and the
bank's per-band nonzero ranges (``mel_bands_np``). No pipeline of the port
calls the kernel (nor does the reference's): ``extract_features`` keeps
``torch.stft``.
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


# mirrors of csrc/log_mel.cu's constants (a CPU test parses the source)
N_FFT = 400                 # the only size the kernel's FFT plan takes
RADICES = (5, 5, 8)         # Stockham stages of the 200-point FFT
TABLE_OFFSETS = {"win": 0, "tw2": 400, "tw3": 450, "post": 850,
                 "const": 1252}
TABLE_FLOATS = 1260


def _stage_twiddles(radix: int, span: int) -> np.ndarray:
    """[span, radix] exp(-2 pi i t r / (span radix)), float64: the
    twiddle of input r of a Stockham butterfly j with j mod span = t."""
    t = np.arange(span, dtype=np.float64)[:, None]
    r = np.arange(radix, dtype=np.float64)[None, :]
    return np.exp(-2j * np.pi * t * r / (span * radix))


def _fft_table_np(n_fft: int = N_FFT) -> np.ndarray:
    """The kernel's FFT table, [TABLE_FLOATS] f32 built in float64: the
    periodic Hann window as pairs (w[2m], w[2m+1]); the twiddles of stage
    2 (radix 5 over spans of 5: [5, 5] complex) and stage 3 (radix 8 over
    spans of 25: [25, 8]); the post-twiddle exp(-2 pi i k / n_fft) of the
    n_fft / 2 + 1 bins; cos 2pi/5, cos 4pi/5, sin 2pi/5, sin 4pi/5 and
    sqrt(1/2) for the radix-5 and radix-8 butterflies. Complex values are
    stored (re, im)."""
    if n_fft != N_FFT:
        raise ValueError(f"the log-mel kernel's FFT plan takes n_fft = "
                         f"{N_FFT} only, got {n_fft}")
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    post = np.exp(-2j * np.pi * np.arange(n_fft // 2 + 1) / n_fft)
    consts = np.array([np.cos(2 * np.pi / 5), np.cos(4 * np.pi / 5),
                       np.sin(2 * np.pi / 5), np.sin(4 * np.pi / 5),
                       np.sqrt(0.5)])

    def pairs(z):
        return np.stack([z.real, z.imag], axis=-1).ravel()
    parts = {"win": window, "tw2": pairs(_stage_twiddles(5, 5)),
             "tw3": pairs(_stage_twiddles(8, 25)), "post": pairs(post),
             "const": consts}
    table = np.zeros(TABLE_FLOATS, np.float64)
    for name, x in parts.items():
        table[TABLE_OFFSETS[name]:TABLE_OFFSETS[name] + x.size] = x
    return table.astype(np.float32)


def mel_bands_np(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(bands [3, n_mels] int32: lo, hi and the offset of band m's first
    weight; weights f32): the range [lo, hi) of each band's nonzero
    weights in the dense bank fb [n_bins, n_mels], and those ranges'
    weights packed band after band (an empty band has lo = hi = 0)."""
    n_mels = fb.shape[1]
    bands = np.zeros((3, n_mels), np.int32)
    weights = []
    off = 0
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        if nz.size:
            lo, hi = int(nz[0]), int(nz[-1]) + 1
            bands[:, m] = lo, hi, off
            weights.append(fb[lo:hi, m])
            off += hi - lo
        else:
            bands[2, m] = off
    packed = np.concatenate(weights) if weights else np.zeros(1)
    return bands, packed.astype(np.float32)


def _bank(cfg: FeatureConfig) -> np.ndarray:
    return mel_filter_bank(cfg.n_fft // 2 + 1, cfg.feature_size, 0.0, 8000.0,
                           cfg.sampling_rate)


@functools.lru_cache(maxsize=16)
def _tables(cfg: FeatureConfig, device: torch.device
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(basis [n_fft, 2, n_bins], mel bank [n_bins, n_mels]), f32, once
    per config and device: the plain twin's tables."""
    return (torch.from_numpy(_basis_np(cfg.n_fft)).to(device),
            torch.from_numpy(_bank(cfg)).to(device))


@functools.lru_cache(maxsize=16)
def _kernel_tables(cfg: FeatureConfig, device: torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(FFT table, bands, packed weights) on ``device``, once per config
    and device: the kernel's tables."""
    bands, weights = mel_bands_np(_bank(cfg))
    return tuple(torch.from_numpy(x).to(device) for x in (
        _fft_table_np(cfg.n_fft), bands, weights))


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
                  cfg: FeatureConfig = FeatureConfig(),
                  dtype: torch.dtype = torch.float32,
                  stamps: torch.Tensor | None = None) -> torch.Tensor:
    """[B, n_samples] -> [B, n_mels, n_frames] log-mel features in
    ``dtype`` (computed in f32, as the reference casts its input and
    rounds only the result): the kernel's two launches for a CUDA tensor
    (the plain twin for a CPU tensor). A waveform on the card that is not
    contiguous f32 is cast and copied first, which costs one pass over it;
    the kernel reads samples one f32 at a time, so any f32 storage offset
    serves. Raises unless every window holds exactly ``cfg.n_samples``
    samples, and on the card unless n_fft is 400, the hop even and n_mels
    x n_frames a multiple of 4.
    ``stamps`` (int64 [3] on the card, holding -1, 0, 0) gets the
    %globaltimer of the first FFT block's start, the last FFT block's end
    and the last clip block's end (``testing.log_mel_phases``)."""
    if waveform.device.type == "cpu":
        return log_mel_plain(waveform, cfg).to(dtype)
    _check(waveform, cfg)
    if waveform.device.type != "cuda":
        raise ValueError(f"fused_log_mel: unsupported device "
                         f"{waveform.device}")
    waveform = waveform.float().contiguous()
    n_frames = cfg.n_samples // cfg.hop_length
    if cfg.n_fft != N_FFT or cfg.hop_length % 2 or (
            cfg.feature_size * n_frames % 4):
        raise ValueError(f"fused_log_mel: the kernel takes n_fft = {N_FFT}, "
                         "an even hop and n_mels x n_frames a multiple of 4, "
                         f"got {cfg.n_fft}, {cfg.hop_length} and "
                         f"{cfg.feature_size} x {n_frames}")
    if stamps is not None and (stamps.device != waveform.device
                               or stamps.dtype != torch.int64
                               or stamps.shape != (3,)
                               or not stamps.is_contiguous()):
        raise ValueError("fused_log_mel: stamps must be a contiguous int64 "
                         f"[3] tensor on {waveform.device}")
    b = waveform.shape[0]
    table, bands, weights = _kernel_tables(cfg, waveform.device)
    out = torch.empty((b, cfg.feature_size, n_frames), dtype=torch.float32,
                      device=waveform.device)
    peak = torch.empty((b,), dtype=torch.int32, device=waveform.device)
    _build.launcher("cw_log_mel")(
        waveform.get_device(), waveform.data_ptr(), table.data_ptr(),
        bands.data_ptr(), weights.data_ptr(), out.data_ptr(),
        peak.data_ptr(), None if stamps is None else stamps.data_ptr(), b,
        cfg.n_samples, n_frames, cfg.n_fft, cfg.hop_length, cfg.feature_size)
    fused_log_mel.launches += 1
    return out.to(dtype)


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
