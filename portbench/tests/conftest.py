"""Shared fixtures of the benchmark's own tests: a throwaway cell at a
small width (f32, full 30 s windows, the published vocabulary size) in a
directory of its own, found from new files alone."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
sys.path.insert(0, ROOT)

SMALL = {"name": "small", "source": "test", "model_type": "whisper",
         "d_model": 64,
         "encoder_layers": 2, "decoder_layers": 2,
         "encoder_attention_heads": 4, "decoder_attention_heads": 4,
         "encoder_ffn_dim": 128, "decoder_ffn_dim": 128,
         "max_source_positions": 1500, "max_target_positions": 448,
         "num_mel_bins": 80, "vocab_size": 51866,
         "activation_function": "gelu", "median_filter_width": 7,
         "serve_dtype": "float32",
         "alignment_heads": [[0, 1], [1, 3], [0, 2]],
         "reduced": [], "assumed": []}
SMALL_LIMIT = 1e-3     # f32 program against the f32 reference on the CPU
SMALL_TS_LIMIT = 0.01  # s, half a frame: the same token times up to rounding


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _write(path: str, obj) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f)


@pytest.fixture
def small_root(tmp_path):
    """(root, bench): a benchmark directory holding the small config, a
    bulk mix of 6 windows at batch 4 and a clip mix of 3 clips, their
    limits, every metric reader and every architecture file; ``bench``
    lists the two cells."""
    root = str(tmp_path)
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(root, d))
    for d in ("metrics", "archs"):
        shutil.copytree(os.path.join(PORTBENCH, d), os.path.join(root, d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    _write(os.path.join(root, "configs", "small.json"), SMALL)
    with open(os.path.join(PORTBENCH, "traffic", "bulk-b64.json")) as f:
        bulk = json.load(f)
    bulk["pipeline"]["batch_size"] = 4
    bulk["lengths"] = {"rule": "log_uniform_windows", "min_s": 40,
                       "max_s": 90, "windows": 6}
    bulk["new_tokens"] = {"per_audio_s": None, "max": 24}
    bulk["check_windows"] = 6
    _write(os.path.join(root, "traffic", "small-bulk.json"), bulk)
    with open(os.path.join(PORTBENCH, "traffic", "clip-b1.json")) as f:
        clip = json.load(f)
    clip["lengths"] = {"rule": "grid", "min_s": 2, "max_s": 6, "step_s": 2}
    clip["new_tokens"] = {"per_audio_s": 1.0, "max": 8}
    _write(os.path.join(root, "traffic", "small-clip.json"), clip)
    cells = [{"name": "small.bulk", "config": "small",
              "traffic": "small-bulk", "chips": 1},
             {"name": "small.clip", "config": "small",
              "traffic": "small-clip", "chips": 1}]
    for c in cells:
        _write(os.path.join(root, "limits", c["name"] + ".json"),
               {"logit_gap": SMALL_LIMIT, "ts_err_s": SMALL_TS_LIMIT})
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] = cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["small.bulk"]
                              if any("bulk" in w for w in m["workloads"])
                              else ["small.clip"])
    return root, bench
