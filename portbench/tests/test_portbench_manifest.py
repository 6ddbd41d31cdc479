"""BENCHMARK.json against the contract's forms, and every name it gives
found as a file under portbench/."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import PORTBENCH, ROOT
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w)
                                               for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    n = len(bench["workloads"])
    assert 1 <= n <= 24 and 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    # the check's budget with the full 24 cells
    assert 24 * 180 + (2 + 14 * 24) * (bench["run_seconds"] + 60) \
        + 1200 <= 43200


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) \
        == len(cells)
    assert {w["config"] for w in bench["workloads"]} == set(names)
    metrics = []
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        metrics.append(m)
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert m["workloads"]
        metrics.append(m)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_every_cell_reports_what_it_must(bench):
    from portbench import harness
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(
            bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = harness.cell_metrics(bench, w["name"], "per_layer")
        assert per and all(m["moves"] in e2e for m in per)


def test_every_name_is_a_file(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"].startswith(
            c["source"])
        assert cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        for kind, name in (("traffic", w["traffic"]),
                           ("limits", w["name"])):
            assert os.path.exists(os.path.join(PORTBENCH, kind,
                                               name + ".json"))
        with open(os.path.join(PORTBENCH, "limits", w["name"] + ".json")) as f:
            limits = json.load(f)
        assert "logit_gap" in limits
        assert not set(limits) & set(harness.GATES)
        assert all(v > 0 for v in limits.values())
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(PORTBENCH, "metrics",
                                           m["name"] + ".py"))


def test_every_architecture_is_a_file_and_word_times_are_held(bench):
    """Each configuration's published ``model_type`` names a file under
    archs/ holding the contract's names, and every cell whose mix asks
    for word times holds them to a limit."""
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            mod = harness.architecture(PORTBENCH, json.load(f))
        assert all(hasattr(mod, n) for n in harness.ARCH_NAMES)
    for w in bench["workloads"]:
        mix = harness.load(PORTBENCH, "traffic", w["traffic"])
        limits = harness.load(PORTBENCH, "limits", w["name"])
        if mix["generation"]["return_token_timestamps"]:
            assert "ts_err_s" in limits, w["name"]
