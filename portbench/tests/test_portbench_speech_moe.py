"""The speech-LM architecture file (archs/grin_qwen2_vl.py) through the
harness on the CPU: a tiny configuration of its ``model_type``, a
text-only bulk mix, served by the port's load_pipeline and held against
reference/speech_moe.py, correct true."""

from __future__ import annotations

import json
import os
import time

import pytest

from portbench import harness

TINY = {"name": "tiny-moe", "source": "test", "model_type": "grin_qwen2_vl",
        "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "rope_theta": 1000000,
        "rms_norm_eps": 1e-6, "vocab_size": 152064,
        "mlp_dynamic_expert_num": 4, "mlp_dynamic_null_expert_num": 1,
        "dynamic_intermediate_size": 96, "mlp_dynamic_top_p": 0.7,
        "mlp_dynamic_top_k": 2, "mlp_fixed_expert_num": 2,
        "shared_intermediate_size": 32, "max_position_embeddings": 32768,
        "whisper_hidden_size": 32, "whisper_query_tokens_size": 200,
        "audio_config": {"num_mel_bins": 80, "encoder_layers": 2,
                         "encoder_attention_heads": 2,
                         "encoder_ffn_dim": 64},
        "serve_dtype": "float32", "reduced": [], "assumed": []}
LIMIT = 1e-3           # f32 program against the f32 reference on the CPU
# the share of routing decisions the f32 program makes otherwise than the
# f32 reference: none but where a tie splits on summation order
FLIP_LIMIT = 0.01


def _write(root, kind, name, obj):
    with open(os.path.join(root, kind, name + ".json"), "w") as f:
        json.dump(obj, f)


@pytest.fixture
def moe_cell(small_root):
    """(root, bench, cell): the tiny configuration under a text-only bulk
    mix of 6 windows at batch 4, 8 new tokens each, reporting what the
    benchmark's speech-LM cell reports."""
    root, bench = small_root
    _write(root, "configs", "tiny-moe", TINY)
    mix = harness.load(harness.HERE, "traffic", "bulk-text-b64")
    mix["pipeline"]["batch_size"] = 4
    mix["lengths"] = {"rule": "log_uniform_windows", "min_s": 40,
                      "max_s": 90, "windows": 6}
    mix["new_tokens"] = {"per_audio_s": None, "max": 8}
    mix["check_windows"] = 6
    _write(root, "traffic", "tiny-text", mix)
    _write(root, "limits", "tiny.moe", {"logit_gap": LIMIT,
                                        "route_flip_share": FLIP_LIMIT})
    cell = {"name": "tiny.moe", "config": "tiny-moe", "traffic": "tiny-text",
            "chips": 1}
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("rtfx", "mfu.bulk", "decode_step_ms.bulk",
                         "stitch_ms_per_window.bulk", "expert_roofline.omni",
                         "expert_ms_per_step.omni"):
            m.setdefault("workloads", []).append("tiny.moe")
    return root, bench, cell


@pytest.mark.parametrize("traced", [False, True])
def test_speech_lm_cell_runs_correct(moe_cell, traced):
    root, bench, cell = moe_cell
    res, lines, readings = harness.run_cell(
        bench, cell, 2 ** 31 + 41, 0.5, traced, time.perf_counter(),
        device="cpu", root=root)
    assert res["correct"], (res["checks"], lines)
    assert list(res["checks"]) == ["failed", "short_windows",
                                   "stitch_mismatch", "logit_gap",
                                   "route_flip_share"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert readings["tokens"] > 0 and "ts" not in readings
    want = ({"mfu.bulk", "decode_step_ms.bulk", "stitch_ms_per_window.bulk"}
            if traced else {"rtfx", "setup_s"})
    assert want <= set(res["metrics"])
    # no device trace on the CPU: the expert kernel's readers read nothing
    assert "expert_roofline.omni" not in res["metrics"]
    json.dumps(res)


def test_the_control_misses_the_limit(moe_cell):
    """The fp8 control, judged in the program's place, is not correct."""
    root, bench, cell = moe_cell
    res, _, readings = harness.run_cell(
        bench, cell, 2 ** 31 + 43, 0.0, False, time.perf_counter(),
        device="cpu", root=root, n_calls=1, control="fp8")
    assert readings["logit_gap"] <= LIMIT
    assert readings["route_flip_share"] <= FLIP_LIMIT
    assert readings["control"]["logit_gap"] > LIMIT
    assert not res["correct"]


def test_the_ports_prompt_is_the_architecture_files(tmp_path):
    """The port's window prompt, tokenized from the checkpoint the
    architecture file writes, is ``prompt_ids``: each of the prompt's
    words one id, about 220 positions."""
    from crisperwhisper_tpu_torch.models import speech_moe
    from crisperwhisper_tpu_torch.tokenizer.whisper_tokenizer import (
        WhisperTokenizer)
    cfg = harness.load(harness.HERE, "configs", "uni-moe-2.0-omni")
    model = harness.architecture(harness.HERE, cfg)
    ck = model.checkpoint(str(tmp_path / "ckpt"), cfg)
    tokens = speech_moe.speech_tokens(WhisperTokenizer.from_dir(ck),
                                      model.arch(cfg))
    want = model.prompt_ids({})
    assert list(tokens.prompt) == want and len(want) == 215
    pieces = model.text_pieces()
    assert b"".join(pieces[i] for i in want if i < len(pieces)) == (
        b"user\nTranscribe the audio verbatim.\nassistant\n")


def test_the_architecture_counts_routed_expert_work():
    """work_speech_moe: the expert kernel's bytes and operations from the
    routed rows, and the roofline's bound from per-layer counts."""
    from portbench import work_speech_moe as work
    arch = harness.architecture(harness.HERE, TINY).arch(
        {**TINY, "hidden_size": 3584, "dynamic_intermediate_size": 18944})
    b, ops = work.expert_work(arch, 20, 4)
    assert ops == 2 * 3 * 3584 * 18944 * 20
    assert b > 4 * 3 * 3584 * 18944 * 2
    # a layer of 20 rows over 4 experts in one launch, and the null expert
    row = [5, 5, 5, 5, 3, 12, 4, 1, 1, 1, 1]
    assert work.routing_bound_s(arch, [row]) == \
        work.bound_s(b, ops, "bf16")[0]
