"""The readers of the launches inside the program's decode-loop spans
(program_spans.py, metrics/*_launches_per_step.*.py) on a synthetic trace
summary and synthetic program records."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from crisperwhisper_tpu_torch.utils import tracing
from portbench import harness, trace

from conftest import PORTBENCH

READERS = {"step_launches_per_step.bulk": "cw.decode.step",
           "step_launches_per_step.clip": "cw.decode.step",
           "select_launches_per_step.bulk": "cw.decode.select",
           "select_launches_per_step.clip": "cw.decode.select"}


def _summary(launches: list) -> trace.Summary:
    return trace.Summary(spans=[("pb.call", 1_000, 2_000)],
                         launches=sorted(launches))


def _rec(name: str, a: int, b: int) -> tracing.Record:
    return tracing.Record(name, a, b, None, 0, {})


@pytest.mark.parametrize("metric", sorted(READERS))
def test_launches_are_counted_inside_the_records_edges_included(metric):
    name = READERS[metric]
    other = ("cw.decode.select" if name == "cw.decode.step"
             else "cw.decode.step")
    # launches on both edges of the first record count, one a nanosecond
    # outside does not; the second record holds one; the other name's
    # record and a record outside the window's pb.* spans are not read
    ctx = SimpleNamespace(trace=_summary(
        [1_099, 1_100, 1_150, 1_200, 1_201, 1_300, 1_500, 2_100]))
    with tracing.recording() as recs:
        recs += [_rec(name, 1_100, 1_200), _rec(other, 1_250, 1_600),
                 _rec(name, 1_290, 1_310), _rec(name, 2_050, 2_200)]
        assert harness._read_metric(PORTBENCH, metric, ctx) == 2.0
        ctx.trace.spans.append(("pb.call", 2_000, 3_000))
        assert harness._read_metric(PORTBENCH, metric, ctx) == \
            pytest.approx(5 / 3)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_to_read_gives_none(metric):
    name = READERS[metric]
    with tracing.recording() as recs:
        ctx = SimpleNamespace(trace=_summary([1_100, 1_200]))
        assert harness._read_metric(PORTBENCH, metric, ctx) is None
        recs.append(_rec(name, 1_050, 1_250))
        assert harness._read_metric(PORTBENCH, metric, ctx) == 2.0
        for empty in (None, _summary([]),
                      trace.Summary(launches=[1_100, 1_200])):
            ctx = SimpleNamespace(trace=empty)
            assert harness._read_metric(PORTBENCH, metric, ctx) is None


def test_a_program_without_records_gives_none(monkeypatch):
    """The parent of the spans' program has no ``tracing.records``."""
    monkeypatch.delattr(tracing, "records")
    ctx = SimpleNamespace(trace=_summary([1_100, 1_200]))
    for metric in READERS:
        assert harness._read_metric(PORTBENCH, metric, ctx) is None
