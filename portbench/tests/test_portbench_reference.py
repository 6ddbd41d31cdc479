"""The plain reference against the port's plain path at a small width on
the CPU (f32). The test imports the port; the reference never does."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import align, model

from conftest import SMALL

REF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reference")


@pytest.fixture(scope="module")
def small():
    from crisperwhisper_tpu_torch.config import WhisperArch
    arch = WhisperArch.from_hf_config(SMALL)
    return arch, weights.make(arch, 3, "cpu", torch.float32)


def test_reference_imports_nothing_of_the_port():
    for name in os.listdir(REF_DIR):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF_DIR, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert not any(m.split(".")[0].startswith("crisperwhisper")
                           or m.split(".")[0] in ("jax", "jaxlib")
                           for m in mods), (name, mods)


def test_log_mel_matches_the_port(small):
    from crisperwhisper_tpu_torch.audio.mel import extract_features
    from crisperwhisper_tpu_torch.config import FeatureConfig
    rng = np.random.default_rng(0)
    wave = torch.from_numpy(rng.standard_normal((2, 480000))
                            .astype(np.float32) * 0.1)
    wave[1, 200000:] = 0
    got = model.log_mel(wave, 80)
    want = extract_features(wave, FeatureConfig(feature_size=80))
    assert got.shape == want.shape == (2, 80, 3000)
    assert float((got - want).abs().max()) < 1e-4


def test_encoder_and_decoder_match_the_port(small):
    from crisperwhisper_tpu_torch.models.whisper import (decoder_forward,
                                                         encode)
    arch, params = small
    feats = torch.randn(2, 80, 3000, generator=torch.Generator()
                        .manual_seed(1))
    ref = model.Reference(params, arch, "f32")
    enc = ref.encode(feats)
    port_enc = encode(params, arch, feats)
    assert float((enc - port_enc).abs().max()) < 1e-4
    ids = torch.randint(0, 50257, (2, 20), generator=torch.Generator()
                        .manual_seed(2))
    logits, probs = ref.decode(enc, ids, SMALL["alignment_heads"])
    want = decoder_forward(params, arch, ids, port_enc)
    assert float((logits - want).abs().max()) < 1e-4
    assert probs.shape == (2, 3, 20, 1500)
    assert torch.allclose(probs.sum(-1), torch.ones(2, 3, 20), atol=1e-5)


def test_serving_mode_quantizes_as_the_port(small):
    from crisperwhisper_tpu_torch.models.quantize import (dequantize_dense,
                                                          quantize_decoder_weights)
    from crisperwhisper_tpu_torch.models.whisper import _quantize
    arch, params = small
    w = params["decoder"]["layers"][0]["mlp"]["fc1"]["w"]
    q = quantize_decoder_weights(params)["decoder"]["layers"][0]["mlp"]["fc1"]
    assert torch.equal(model.quant_dequant(w.float(), 127.0),
                       dequantize_dense(q))
    x = torch.randn(3, 4, 7, 64)
    for qmax in (127.0, 7.0):
        vals, scale = _quantize(x, qmax)
        assert torch.equal(model.quant_dequant(x, qmax),
                           vals.float() * scale.float()[..., None])


def test_token_times_match_the_ports_alignment():
    from crisperwhisper_tpu_torch.ops.alignment import (dtw_jump_times,
                                                        median_filter,
                                                        znorm_tokens)
    rng = np.random.default_rng(4)
    probs = rng.random((3, 11, 300)).astype(np.float32)
    n_tok, n_frames = 10, 280
    w = torch.from_numpy(probs[:, :n_tok, :n_frames])
    cost = -median_filter(znorm_tokens(w), 7).mean(0)
    want = dtw_jump_times(cost[None], torch.tensor([n_tok]),
                          torch.tensor([n_frames]))[0].numpy()
    got = align.token_times(probs, n_tok, n_frames, 7, 12)
    np.testing.assert_allclose(got[:n_tok], want * 0.02)
    assert got[10] == got[11] == got[9]


@pytest.mark.parametrize("seed", range(6))
def test_stitch_matches_the_ports_stitcher(seed, tmp_path):
    """Overlapping windows of random text tokens (byte symbols, bytes of
    split UTF-8 characters, punctuation and words) and rising times: the
    reference's text and words equal the port's decode_asr and
    adjust_pauses, times and all."""
    from crisperwhisper_tpu_torch.pipeline.pauses import adjust_pauses
    from crisperwhisper_tpu_torch.tokenizer.stitcher import decode_asr
    from crisperwhisper_tpu_torch.tokenizer.whisper_tokenizer import (
        WhisperTokenizer)
    from portbench import ckpt, generator
    from portbench.reference import stitch

    tok = WhisperTokenizer.from_dir(ckpt.write(
        str(tmp_path), dict(SMALL), SMALL["alignment_heads"]),
        language="en")
    rng = np.random.default_rng(seed)
    byte_id = {b: i for i, b in enumerate(
        ckpt.bytes_to_unicode().keys())}
    alphabet = ([byte_id[b] for b in b".,!?\"'(-: "]
                + [byte_id[0xC3], byte_id[0xA9]] + list(range(300, 312)))
    n = generator.samples_for_windows(4) - int(rng.integers(0, 9000))
    bounds = generator.chunk_bounds(n)
    base = rng.choice(alphabet, 1000)
    windows, outputs = [], []
    for k, (start, length) in enumerate(bounds):
        at = start // 3200              # five tokens a second
        m = int(rng.integers(20, 60))
        toks = base[at:at + m].copy()
        toks[rng.random(m) < 0.1] = rng.choice(alphabet)
        times = np.sort(np.clip(
            (at + np.arange(m)) * 0.2 - start / 16000
            + rng.uniform(-0.05, 0.05, m), 0, length / 16000)).astype(
            np.float32)
        left = 0 if start == 0 else generator.STRIDE
        right = 0 if k == len(bounds) - 1 else generator.STRIDE
        stride = (length / 16000, left / 16000, right / 16000)
        windows.append((toks, times, stride))
        outputs.append({"tokens": toks[None], "token_timestamps":
                        times[None], "stride": stride})
    text, opt = decode_asr(tok, outputs, return_timestamps="word",
                           return_language=False, time_precision=0.02)
    want = adjust_pauses({"text": text, **opt}, 0.12)
    got = stitch.transcribe(windows, 0.12, ckpt.text_pieces())
    assert got["text"] == want["text"] and got["chunks"] == want["chunks"]
    assert len(got["chunks"]) > 10


@pytest.mark.parametrize("seed", range(6))
def test_text_stitch_matches_the_ports_stitcher(seed, tmp_path):
    """Overlapping windows of random text tokens with no times: the
    reference's tokens-only merge equals the port's
    find_longest_common_sequence, and its text the port's decode_asr in
    text mode."""
    from crisperwhisper_tpu_torch.tokenizer.stitcher import (
        decode_asr, find_longest_common_sequence)
    from crisperwhisper_tpu_torch.tokenizer.whisper_tokenizer import (
        WhisperTokenizer)
    from portbench import ckpt, generator
    from portbench.reference import stitch

    tok = WhisperTokenizer.from_dir(ckpt.write(
        str(tmp_path), dict(SMALL), SMALL["alignment_heads"]),
        language="en")
    rng = np.random.default_rng(100 + seed)
    byte_id = {b: i for i, b in enumerate(
        ckpt.bytes_to_unicode().keys())}
    alphabet = ([byte_id[b] for b in b".,!?\"'(-: "]
                + [byte_id[0xC3], byte_id[0xA9]] + list(range(300, 312)))
    n = generator.samples_for_windows(4) - int(rng.integers(0, 9000))
    base = rng.choice(alphabet, 1000)
    bounds = generator.chunk_bounds(n)
    runs, outputs = [], []
    for k, (start, length) in enumerate(bounds):
        at = start // 3200              # five tokens a second
        m = int(rng.integers(20, 60))
        toks = base[at:at + m].copy()
        toks[rng.random(m) < 0.1] = rng.choice(alphabet)
        left = 0 if start == 0 else generator.STRIDE
        right = 0 if k == len(bounds) - 1 else generator.STRIDE
        runs.append(toks)
        outputs.append({"tokens": toks[None], "stride": (
            length / 16000, left / 16000, right / 16000)})
    pieces = ckpt.text_pieces()
    merged, times = stitch.merge_runs([list(r) for r in runs])
    assert merged == find_longest_common_sequence([list(r) for r in runs])
    assert times is None and len(merged) < sum(len(r) for r in runs)
    text, opt = decode_asr(tok, outputs, return_timestamps=False,
                           return_language=False, time_precision=0.02)
    assert opt == {}
    assert stitch.transcribe_text(runs, pieces) == {"text": text}
    assert stitch.transcribe_text([], pieces) == {"text": ""}
