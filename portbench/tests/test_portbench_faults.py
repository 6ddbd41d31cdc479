"""The check bites: the control, judged in the program's place at a small
size, and a run with the timed path broken underneath (each fault a
serving cell can have: a token, a word or a token time altered where it
is produced, a step that returns its state unchanged, half the batch
left out) come out not correct. The exchange between chips has no fault
to plant: every cell runs on one card and the path takes no collective."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness

from conftest import SMALL_LIMIT, SMALL_TS_LIMIT


def _run(root, bench, cell=0, seed=5, control=None):
    return harness.run_cell(bench, bench["workloads"][cell], seed, 0.5,
                            False, time.perf_counter(), device="cpu",
                            root=root, control=control)


@pytest.mark.parametrize("cell,mode", [(0, "fp8"), (1, "serving-int4")])
def test_control_fails_the_limit(small_root, cell, mode):
    root, bench = small_root
    res, _, readings = _run(root, bench, cell, control=mode)
    assert readings["logit_gap"] <= SMALL_LIMIT
    assert readings["ts"]["p50"] <= SMALL_TS_LIMIT
    assert readings["stitch_mismatch"] == 0
    assert not res["correct"]
    assert readings["control"]["logit_gap"] > 3 * SMALL_LIMIT


def test_token_altered_where_produced(small_root, monkeypatch):
    from crisperwhisper_tpu_torch.decoding import longform
    real = longform.greedy_decode

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        p = args[5].shape[1]
        res.sequences[0, p] = (res.sequences[0, p] + 1) % 50257
        return res

    root, bench = small_root
    monkeypatch.setattr(longform, "greedy_decode", altered)
    res, _, _ = _run(root, bench)
    assert not res["correct"]
    assert res["checks"]["logit_gap"]["value"] > SMALL_LIMIT


@pytest.mark.parametrize("cell", [0, 1])
def test_step_returns_its_state_unchanged(small_root, monkeypatch, cell):
    from crisperwhisper_tpu_torch.models import whisper
    monkeypatch.setattr(whisper, "_write_block", lambda *a, **k: None)
    root, bench = small_root
    res, _, _ = _run(root, bench, cell)
    assert not res["correct"]
    assert res["checks"]["logit_gap"]["value"] > SMALL_LIMIT


def test_half_the_batch_left_out(small_root, monkeypatch):
    from crisperwhisper_tpu_torch.decoding import longform
    real = longform.encode

    def half(params, arch, feats):
        out = real(params, arch, feats)
        keep = out.shape[0] // 2
        return torch.cat([out[:keep], torch.zeros_like(out[keep:])])

    root, bench = small_root
    monkeypatch.setattr(longform, "encode", half)
    res, _, _ = _run(root, bench)
    assert not res["correct"]


def test_word_altered_where_produced(small_root, monkeypatch):
    from crisperwhisper_tpu_torch.pipeline import asr
    real = asr.adjust_pauses

    def altered(result, threshold):
        out = real(result, threshold)
        s, e = out["chunks"][-1]["timestamp"]
        out["chunks"][-1]["timestamp"] = (s, e + 0.02)
        return out

    root, bench = small_root
    monkeypatch.setattr(asr, "adjust_pauses", altered)
    res, _, _ = _run(root, bench)
    assert not res["correct"]
    assert res["checks"]["stitch_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", [0, 1])
def test_token_times_altered_where_produced(small_root, monkeypatch, cell):
    """The alignment tail reads each token's row as the next one's: its
    times go to the stitcher as if sound, so the stitch agrees and the
    times do not."""
    from crisperwhisper_tpu_torch.decoding import longform
    real = longform.attention_to_jump_times

    def rows_shifted(weights, *args, **kwargs):
        return real(torch.roll(weights, 1, dims=2), *args, **kwargs)

    root, bench = small_root
    monkeypatch.setattr(longform, "attention_to_jump_times", rows_shifted)
    res, _, _ = _run(root, bench, cell)
    assert not res["correct"]
    assert res["checks"]["ts_err_s"]["value"] > SMALL_TS_LIMIT
    assert res["checks"]["stitch_mismatch"]["value"] == 0
