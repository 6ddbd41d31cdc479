"""On the card, at each cell's own size: three seeds of the program and
of its control (the reference at the next precision below the cell's,
judged in the program's place): the program within the cell's limits,
and the run with the control's numbers compared not correct."""

from __future__ import annotations

import json
import os
import time

import pytest

from portbench import control, generator, harness

from conftest import ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_control_fails_at_the_cells_size(cuda_card, cell):
    bench = _bench()
    workload = {w["name"]: w for w in bench["workloads"]}[cell]
    mix = harness.load(harness.HERE, "traffic", workload["traffic"])
    limits = harness.load(harness.HERE, "limits", cell)
    n_calls = (1 if mix["per_call"] == "all"
               else len(generator.lengths(mix["lengths"])))
    for seed in (9001, 9002, 9003):
        res, _, r = harness.run_cell(
            bench, workload, seed, 0.0, False, time.perf_counter(),
            device=cuda_card, n_calls=n_calls,
            control=control.control_mode(mix))
        assert r["logit_gap"] <= limits["logit_gap"], r
        if "ts_err_s" in limits:
            assert r["ts"]["p50"] <= limits["ts_err_s"], r
        assert r["stitch_mismatch"] == 0, r
        assert not res["correct"], r
