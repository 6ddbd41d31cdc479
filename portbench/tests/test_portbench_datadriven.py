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
