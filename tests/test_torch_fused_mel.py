"""The port's fused log-mel frontend (the CPU path of
crisperwhisper_tpu_torch.audio.fused_mel, the kernel's plain twin) against
the JAX Pallas kernel run interpreted and against the port's
``extract_features`` (torch.stft), on the TINY 5 s window at 80 and 128
mels.

The windows, made from a seed with numpy: a tone in noise, an all-zero
window (every feature must be exactly the stft path's -1.5) and a clip
cut short by zero padding. Band: 2e-4, the reference kernel's against the
rfft frontend (tests/test_pallas_kernels.py:85).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crisperwhisper_tpu_torch.audio import fused_mel
from crisperwhisper_tpu_torch.audio.mel import extract_features
from crisperwhisper_tpu_torch.config import FeatureConfig
from crisperwhisper_tpu_torch.testing import MEL_BAND, SR
from torch_port_fixtures import one_torch_thread  # noqa: F401


def _windows(n: int) -> np.ndarray:
    rng = np.random.default_rng(3)
    t = np.arange(n) / SR
    audio = np.zeros((3, n), np.float32)
    audio[0] = 0.3 * np.sin(2 * np.pi * 440 * t) \
        + 0.05 * rng.standard_normal(n)
    cut = int(1.7 * SR)                    # 1.7 s of sound, then zeros
    audio[2, :cut] = 0.2 * np.sin(2 * np.pi * 300 * t[:cut]) \
        + 0.1 * rng.standard_normal(cut)
    return audio


@pytest.mark.parametrize("n_mels", [80, 128])
def test_fused_log_mel_matches_jax_kernel_and_stft(n_mels):
    from crisperwhisper_tpu.audio.pallas_mel import pallas_log_mel
    from crisperwhisper_tpu.config import FeatureConfig as JaxFeatureConfig
    cfg = FeatureConfig(feature_size=n_mels, chunk_length=5)
    audio = _windows(cfg.n_samples)
    ref = np.asarray(pallas_log_mel(
        jnp.asarray(audio), JaxFeatureConfig(feature_size=n_mels,
                                             chunk_length=5),
        block_frames=100, interpret=True))
    got = fused_mel.fused_log_mel(torch.from_numpy(audio), cfg).numpy()
    assert got.shape == (3, n_mels, cfg.nb_max_frames) == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=MEL_BAND)
    stft = extract_features(torch.from_numpy(audio), cfg).numpy()
    np.testing.assert_allclose(got, stft, rtol=0, atol=MEL_BAND)
    assert (got[1] == -1.5).all() and (stft[1] == -1.5).all()
    plain = fused_mel.log_mel_plain(torch.from_numpy(audio), cfg)
    assert plain.dtype == torch.float32
    assert torch.equal(plain, torch.from_numpy(got))


def test_fused_log_mel_refuses_other_lengths():
    cfg = FeatureConfig(chunk_length=5)
    for shape in ((1, cfg.n_samples - 1), (cfg.n_samples,)):
        with pytest.raises(ValueError, match="pad/trim"):
            fused_mel.fused_log_mel(torch.zeros(shape), cfg)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mel.fused_log_mel(torch.zeros((1, cfg.n_samples),
                                            device="meta"), cfg)


def test_basis_is_the_reference_basis_unpadded():
    from crisperwhisper_tpu.audio.pallas_mel import _padded_basis
    ref = _padded_basis(400)
    got = fused_mel._basis_np(400)
    assert got.shape == (400, 2, 201)
    np.testing.assert_array_equal(got[:, 0], ref[:400, :201])
    np.testing.assert_array_equal(got[:, 1], ref[:400, 256:457])

