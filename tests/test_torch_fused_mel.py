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



# --- the kernel's host tables (csrc/log_mel.cu reads them on the card)


def _fft_plan_model(frames: np.ndarray) -> np.ndarray:
    """The kernel's FFT plan in numpy f32, from its own table: frames
    [F, 400] -> spectrum [F, 201]. Packing z[m] = w[2m] x[2m] + i w[2m+1]
    x[2m+1]; Stockham stages of fused_mel.RADICES (butterfly j takes in[j
    + r N/R], twiddles input r by the table's entry (j mod Ns, r), writes
    out[(j / Ns) Ns R + j mod Ns + r Ns]); then the post-twiddle."""
    tab = fused_mel._fft_table_np(400)
    off = fused_mel.TABLE_OFFSETS
    c1, c2, s1, s2, h = (np.float32(v) for v in
                         tab[off["const"]:off["const"] + 5])

    def cplx(name, n):
        x = tab[off[name]:off[name] + 2 * n].reshape(n, 2)
        return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)

    def dft5(a):
        t1, t2, t3, t4 = a[1] + a[4], a[2] + a[3], a[1] - a[4], a[2] - a[3]
        b1, b2 = a[0] + c1 * t1 + c2 * t2, a[0] + c2 * t1 + c1 * t2
        d1, d2 = s1 * t3 + s2 * t4, s2 * t3 - s1 * t4
        return [a[0] + t1 + t2, b1 - 1j * d1, b2 - 1j * d2, b2 + 1j * d2,
                b1 + 1j * d1]

    def dft4(x):
        a, b, c, d = x[0] + x[2], x[0] - x[2], x[1] + x[3], x[1] - x[3]
        return [a + c, b - 1j * d, a - c, b + 1j * d]

    def dft8(a):
        e, o = dft4(a[0::2]), dft4(a[1::2])
        o = [o[0], o[1] * h * (1 - 1j), o[2] * -1j, o[3] * -h * (1 + 1j)]
        return [e[k] + o[k] for k in range(4)] + \
            [e[k] - o[k] for k in range(4)]

    twiddles = {1: None, 5: cplx("tw2", 25).reshape(5, 5),
                25: cplx("tw3", 200).reshape(25, 8)}
    win = tab[off["win"]:off["win"] + 400]
    x = frames.astype(np.float32) * win
    z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)
    span = 1
    for radix in fused_mel.RADICES:
        nb = 200 // radix
        j = np.arange(nb)
        t = j % span
        a = [z[:, j + r * nb] for r in range(radix)]
        if twiddles[span] is not None:
            a = [a[r] * twiddles[span][t, r] for r in range(radix)]
        y = dft5(a) if radix == 5 else dft8(a)
        out = np.empty_like(z)
        for r in range(radix):
            out[:, (j // span) * span * radix + t + r * span] = y[r]
        z, span = out, span * radix
    k = np.arange(201)
    a, c = z[:, k % 200], np.conj(z[:, (200 - k) % 200])
    return 0.5 * (a + c) + cplx("post", 201) * (-0.5j) * (a - c)


def test_fft_plan_matches_rfft_of_windowed_frames():
    """The kernel's plan (packing, table, radix order, post-twiddle), run
    in f32, against np.fft.rfft of the same windowed frames in float64:
    within 1e-6 of each frame's largest bin."""
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((64, 400)).astype(np.float32)
    frames[1] = 0.0
    frames[2] = 0.0
    frames[2, 123] = 1.0                                     # one click
    frames[3] = np.sin(2 * np.pi * 37.25 * np.arange(400) / 400)
    window = 0.5 * (1 - np.cos(2 * np.pi * np.arange(400) / 400))
    ref = np.fft.rfft(frames.astype(np.float64) * window)
    got = _fft_plan_model(frames)
    scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-30)
    assert (np.abs(got - ref) <= 1e-6 * scale).all()
    assert not got[1].any()


def test_fft_table_holds_the_float64_values_rounded_once():
    tab = fused_mel._fft_table_np(400)
    off = fused_mel.TABLE_OFFSETS
    assert tab.dtype == np.float32 and tab.shape == (fused_mel.TABLE_FLOATS,)
    window = 0.5 * (1 - np.cos(2 * np.pi * np.arange(400) / 400))
    np.testing.assert_array_equal(tab[:400], window.astype(np.float32))
    post = tab[off["post"]:off["post"] + 402].reshape(201, 2)
    k = np.arange(201)
    np.testing.assert_array_equal(
        post[:, 1], (-np.sin(2 * np.pi * k / 400)).astype(np.float32))
    assert not tab[off["const"] + 5:].any()
    with pytest.raises(ValueError, match="n_fft = 400"):
        fused_mel._fft_table_np(512)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_bands_cover_every_nonzero_of_the_bank(n_mels):
    """Each band's [lo, hi) holds all its nonzero weights, every weight
    outside it is zero, and the packed weights are the bank's own."""
    fb = fused_mel._bank(FeatureConfig(feature_size=n_mels))
    bands, weights = fused_mel.mel_bands_np(fb)
    assert bands.shape == (3, n_mels) and bands.dtype == np.int32
    rebuilt = np.zeros_like(fb)
    for m in range(n_mels):
        lo, hi, off = bands[:, m]
        assert 0 <= lo < hi <= fb.shape[0]
        assert fb[lo, m] != 0 and fb[hi - 1, m] != 0
        rebuilt[lo:hi, m] = weights[off:off + hi - lo]
    np.testing.assert_array_equal(rebuilt, fb)
    assert weights.size == bands[1].astype(int).sum() - bands[0].sum()
    assert weights.size < 3 * fb.shape[0]       # sparse: a bin, two bands


def test_mel_bands_of_an_empty_band():
    fb = np.zeros((201, 3), np.float32)
    fb[10:14, 0] = 1.0
    fb[40, 2] = 0.5
    bands, weights = fused_mel.mel_bands_np(fb)
    np.testing.assert_array_equal(bands, [[10, 0, 40], [14, 0, 41],
                                          [0, 4, 4]])
    np.testing.assert_array_equal(weights, [1, 1, 1, 1, 0.5])


def test_sparse_mel_sum_equals_the_dense_loop():
    """Summing k ascending over each band's range gives, bit for bit, the
    dense loop over all bins (a zero weight adds exactly 0)."""
    cfg = FeatureConfig(feature_size=128)
    fb = fused_mel._bank(cfg)
    bands, weights = fused_mel.mel_bands_np(fb)
    power = np.random.default_rng(1).exponential(
        size=(4, 201)).astype(np.float32) * np.float32(1e3)
    for p in power:
        for m in range(0, 128, 9):
            dense = np.float32(0)
            for k in range(201):
                dense = np.float32(dense + p[k] * fb[k, m])
            lo, hi, off = bands[:, m]
            sparse = np.float32(0)
            for k in range(lo, hi):
                sparse = np.float32(sparse + p[k] * weights[off + k - lo])
            assert sparse == dense


def test_table_constants_match_the_kernel_source():
    import re
    from pathlib import Path
    src = (Path(fused_mel.__file__).parent.parent / "csrc"
           / "log_mel.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))
    assert const("kNfft") == fused_mel.N_FFT
    assert const("kTable") == fused_mel.TABLE_FLOATS
    for name, key in (("kWin", "win"), ("kTw2", "tw2"), ("kTw3", "tw3"),
                      ("kPost", "post"), ("kConst", "const")):
        assert const(name) == fused_mel.TABLE_OFFSETS[key]
    assert "radix 5, 5 and 8" in src and fused_mel.RADICES == (5, 5, 8)
