"""work.py against operations and bytes counted by hand."""

from __future__ import annotations

import json
import os

import pytest

from portbench import work

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arch(name):
    from crisperwhisper_tpu_torch.config import WhisperArch
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return WhisperArch.from_hf_config(json.load(f))


@pytest.mark.parametrize("name,layers", [("crisperwhisper-large-v3", 32),
                                         ("whisper-large-v3-turbo", 4)])
def test_window_flops_by_hand(name, layers):
    a = _arch(name)
    assert a.decoder_layers == layers and a.d_model == 1280
    d, t, v = 1280, 1500, 51866
    enc = (2 * 3 * 128 * d * 3000 + 2 * 3 * d * d * t
           + 32 * (2 * (4 * d * d + 2 * d * 5120) * t + 4 * t * t * d))
    assert work.encoder_flops(a) == enc
    assert work.cross_kv_flops(a) == layers * 4 * d * d * t
    tok = layers * (2 * (6 * d * d + 2 * d * 5120) + 4 * d * (10 + t)) \
        + 2 * d * v
    assert work.decoder_token_flops(a, 9) == tok
    total = work.window_flops(a, 4, 96)
    assert total == pytest.approx(
        enc + layers * 4 * d * d * t + sum(
            work.decoder_token_flops(a, p) for p in range(99)), rel=1e-12)
    # the issue's reckoning: about 2.75 TFLOP at large-v3, 2.35 at turbo
    assert total / 1e12 == pytest.approx(2.75 if layers == 32 else 2.35,
                                         abs=0.05)


def test_kernel_bounds_by_hand():
    # kernel 1 at [4, 20, 1500, 64] bf16: PERF.md's table says 0.0466 ms
    b, ops = work.encoder_attention_work(4, 20, 1500, 64)
    assert b == 4 * 4 * 20 * 1500 * 64 * 2
    assert ops == 4 * 4 * 20 * 1500 * 64 * 1500
    s, by = work.bound_s(b, ops, "bf16")
    assert by == "operations" and s * 1e3 == pytest.approx(0.0466, abs=1e-4)
    # kernel 5, b1, ring 128 at position 60: the table's 0.2416 ms (bytes)
    a = _arch("crisperwhisper-large-v3")
    nb, ops = work.step_work(a, 1, 61, 15)
    d, f = 1280, 5120
    weights = 32 * (6 * d * d + 2 * d * f)
    cross = 2 * 32 * 20 * 1500 * (32 + 2)
    ring = 2 * 32 * 20 * (61 * 66 + 66)
    io = 2 * d * 4 + 15 * 1500 * 4
    assert nb == weights + 32 * (20 * d + 2 * f) * 4 + cross + ring + io
    assert ops == 2 * weights + 4 * 32 * d * (61 + 1500)
    s, by = work.bound_s(nb, ops, "f32")
    assert by == "bytes" and s * 1e3 == pytest.approx(0.2416, abs=2e-3)
