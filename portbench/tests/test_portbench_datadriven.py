"""A configuration, a mix, a limit and a per-layer metric that exist only
as new files are picked up by name, with no edit to the harness; and the
small cells run end to end on the CPU with correct true."""

from __future__ import annotations

import json
import os
import time

import pytest

from portbench import harness

from conftest import SMALL_LIMIT


def test_new_files_alone_make_a_cell(small_root):
    root, bench = small_root
    with open(os.path.join(root, "metrics", "windows_served.bulk.py"),
              "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.windows))\n")
    bench["per_layer"].append({
        "name": "windows_served.bulk", "unit": "windows", "better": "higher",
        "source": "program_counter", "layer": "pipeline and stitch",
        "moves": "rtfx", "workloads": ["small.bulk"]})
    cell = bench["workloads"][0]
    res, lines, readings = harness.run_cell(
        bench, cell, 2 ** 31 + 3, 0.5, True, time.perf_counter(),
        device="cpu", root=root)
    assert res["correct"], (res["checks"], lines)
    assert res["metrics"]["windows_served.bulk"]["value"] == 6.0
    assert readings["logit_gap"] <= SMALL_LIMIT
    assert list(res)[-1] == "checks"
    # on the CPU there are no CUDA events and no device trace: those
    # readers return nothing and their metrics are left out
    assert "mel_ms_per_window.bulk" not in res["metrics"]
    assert "stitch_ms_per_window.bulk" in res["metrics"]
    # a traced run serves two windows: spans alone, then the profiler
    assert res["attempted"] == 6 and res["failed"] == 0
    assert res["checks"]["stitch_mismatch"]["value"] == 0


@pytest.mark.parametrize("traced", [False, True])
def test_small_clip_cell_runs_correct(small_root, traced):
    root, bench = small_root
    cell = bench["workloads"][1]
    res, _, readings = harness.run_cell(
        bench, cell, 17, 0.5, traced, time.perf_counter(), device="cpu",
        root=root)
    assert res["correct"], res["checks"]
    want = ({"clip_latency_p50_s.clip", "decode_step_ms.clip"} if traced
            else {"clip_latency_p90_s", "setup_s"})
    assert want <= set(res["metrics"])
    json.dumps(res)


def _write(root, kind, name, obj):
    with open(os.path.join(root, kind, name + ".json"), "w") as f:
        json.dump(obj, f)


def _text_cell(root, bench, limits):
    """A bulk cell whose mix asks for no word times, limited by
    ``limits``: the small bulk mix with ``return_token_timestamps``
    false, reporting what the small bulk cell reports."""
    mix = harness.load(root, "traffic", "small-bulk")
    mix["generation"]["return_token_timestamps"] = False
    _write(root, "traffic", "small-text", mix)
    _write(root, "limits", "small.text", limits)
    cell = {"name": "small.text", "config": "small", "traffic": "small-text",
            "chips": 1}
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "small.bulk" in m.get("workloads", []):
            m["workloads"].append("small.text")
    return cell


PROBE = '''
import os

from portbench.archs import whisper as base

LOG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "calls.log")


def _record(name):
    with open(LOG, "a") as f:
        f.write(name + "\\n")


def _wrap(name):
    def call(*args, **kwargs):
        _record(name)
        return getattr(base, name)(*args, **kwargs)
    return call


arch, weights, checkpoint, prompt_ids, compare, text_pieces = (
    _wrap(n) for n in ("arch", "weights", "checkpoint", "prompt_ids",
                       "compare", "text_pieces"))


class _Work:
    def __getattr__(self, name):
        _record("work." + name)
        return getattr(base.work, name)


work = _Work()
'''


def test_an_architecture_found_by_name_from_files_alone(small_root):
    """A configuration runs through ``archs/<model_type>.py`` of the
    benchmark's directory, here a probe in the temporary root that wraps
    portbench/archs/whisper.py, and the harness calls every name of its
    contract."""
    root, bench = small_root
    assert harness.load(root, "configs", "small")["model_type"] == "whisper"
    with open(os.path.join(root, "archs", "whisper.py"), "w") as f:
        f.write(PROBE)
    res, lines, _ = harness.run_cell(
        bench, bench["workloads"][0], 2 ** 31 + 11, 0.5, True,
        time.perf_counter(), device="cpu", root=root)
    assert res["correct"], (res["checks"], lines)
    with open(os.path.join(root, "archs", "calls.log")) as f:
        calls = set(f.read().split())
    assert calls >= {"arch", "weights", "checkpoint", "prompt_ids",
                     "compare", "text_pieces", "work.window_flops"}
    assert "mfu.bulk" in res["metrics"]


@pytest.mark.parametrize("traced", [False, True])
def test_a_text_only_cell_runs_correct(small_root, traced):
    root, bench = small_root
    cell = _text_cell(root, bench, {"logit_gap": SMALL_LIMIT})
    res, lines, readings = harness.run_cell(
        bench, cell, 23, 0.5, traced, time.perf_counter(), device="cpu",
        root=root)
    assert res["correct"], (res["checks"], lines)
    assert list(res["checks"]) == ["failed", "short_windows",
                                   "stitch_mismatch", "logit_gap"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["stitch_mismatch"]["value"] == 0
    assert "ts" not in readings and readings["tokens"] > 0
    # no alignment tail runs without word times
    assert "align_tail_ms_per_window.bulk" not in res["metrics"]
    want = ({"stitch_ms_per_window.bulk", "mfu.bulk"} if traced
            else {"rtfx", "setup_s"})
    assert want <= set(res["metrics"])
    json.dumps(res)


def test_a_limit_with_no_reading_fails(small_root):
    """Limits that name what the run cannot read (token times of a mix
    without them, a number no reading has) are compared as null and
    make the run not correct, though every number read keeps its
    limit."""
    root, bench = small_root
    cell = _text_cell(root, bench, {"logit_gap": SMALL_LIMIT,
                                    "ts_err_s": 0.03, "no_such_reading": 1})
    res, _, _ = harness.run_cell(
        bench, cell, 29, 0.5, False, time.perf_counter(), device="cpu",
        root=root)
    checks = res["checks"]
    assert not res["correct"]
    assert checks["ts_err_s"]["value"] is None
    assert checks["no_such_reading"]["value"] is None
    assert checks["logit_gap"]["value"] <= SMALL_LIMIT
    assert checks["failed"]["value"] == checks["stitch_mismatch"]["value"] \
        == checks["short_windows"]["value"] == 0
    assert '"ts_err_s": {"value": null' in json.dumps(res)


def test_text_altered_where_produced_in_a_text_only_cell(small_root,
                                                         monkeypatch):
    """Without word times the stitch check holds the text: a character
    added where the pipeline stitches a recording is caught."""
    from crisperwhisper_tpu_torch.pipeline import asr
    real = asr.decode_asr

    def altered(*args, **kwargs):
        text, opt = real(*args, **kwargs)
        return text + "x", opt

    root, bench = small_root
    cell = _text_cell(root, bench, {"logit_gap": SMALL_LIMIT})
    monkeypatch.setattr(asr, "decode_asr", altered)
    res, _, _ = harness.run_cell(
        bench, cell, 31, 0.5, False, time.perf_counter(), device="cpu",
        root=root)
    assert not res["correct"]
    assert res["checks"]["stitch_mismatch"]["value"] > 0


@pytest.mark.parametrize("gate", harness.GATES)
def test_a_limits_file_cannot_name_a_gate(small_root, gate):
    """``failed``, ``short_windows`` and ``stitch_mismatch`` keep the
    limit 0: a limits file that names one is refused before any work."""
    root, bench = small_root
    cell = bench["workloads"][0]
    limits = harness.load(root, "limits", cell["name"])
    _write(root, "limits", cell["name"], {**limits, gate: 5})
    with pytest.raises(ValueError, match=gate):
        harness.run_cell(bench, cell, 37, 0.5, False, time.perf_counter(),
                         device="cpu", root=root)
