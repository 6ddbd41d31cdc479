"""The port's span API (utils/tracing.py): off without a profiler or a
recording scope, on the profiler's clock when on, and the ``cw.*`` spans
the decode loop and a pipeline call leave."""

import numpy as np
import pytest
import torch

from torch_port_fixtures import (CHUNK_S, SR, one_torch_thread,  # noqa: F401
                                 tone_audio, write_tiny_configs)

from crisperwhisper_tpu_torch.testing import TINY
from crisperwhisper_tpu_torch.utils import tracing

LAYER_SPANS = {"cw.call", "cw.mel", "cw.generate", "cw.stitch", "cw.seek",
               "cw.encode", "cw.decode", "cw.align_tail", "cw.readback",
               "cw.segments", "cw.decode.cache", "cw.decode.prefill",
               "cw.decode.step", "cw.decode.select", "cw.decode.sync"}


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    """The TINY pipeline on the CPU with random weights, 12 new tokens."""
    from dataclasses import replace
    from crisperwhisper_tpu_torch.config import PipelineOptions, WhisperArch
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.models.whisper import init_params
    ckpt = write_tiny_configs(str(tmp_path_factory.mktemp("ckpt")))
    params = init_params(WhisperArch.from_hf_config(TINY),
                         torch.Generator().manual_seed(0))
    p = load_pipeline(ckpt, params=params, dtype=torch.float32, device="cpu",
                      pipe_opts=PipelineOptions(chunk_length_s=CHUNK_S,
                                                batch_size=4,
                                                return_timestamps="word"))
    p.gen_opts = replace(p.gen_opts, temperatures=(0.0,),
                         max_new_tokens=12)
    return p


def _fail(*a, **k):
    raise AssertionError("a span that is off opened a profiler range")


def test_a_span_that_is_off_calls_nothing_and_records_nothing(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    with tracing.recording() as recs:
        pass
    monkeypatch.setattr(torch.profiler, "record_function", _fail)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", _fail)
    with tracing.trace_span("cw.test", rows=3) as span:
        span.count(steps=2)
        torch.ones(4).sum()
    assert recs == [] and tracing.records() is recs
    assert tracing.trace_span("a") is tracing.trace_span("b", rows=1)


def _kineto(prof) -> list:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_spans_under_the_profiler_nest_and_share_its_clock():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # a profile's first range pays a one-time set-up of about 1 ms
        # inside it
        with tracing.trace_span("cw.t.first"):
            pass
        n = len(tracing.records())
        with tracing.trace_span("cw.t.outer", rows=2) as outer:
            torch.ones(64).sum()
            with tracing.trace_span("cw.t.inner"):
                torch.zeros(64).mul(2.0)
            outer.count(steps=1)
        with tracing.trace_span("cw.t.next"):
            pass
        for i in range(20):
            with tracing.trace_span(f"cw.t.{i}"):
                pass
    recs = tracing.records()[n:]
    assert [r.name for r in recs[:3]] == ["cw.t.outer", "cw.t.inner",
                                          "cw.t.next"]
    outer, inner, nxt = recs[:3]
    assert outer.parent is None and inner.parent == n
    assert nxt.parent is None and nxt.call != outer.call
    assert inner.call == outer.call
    assert outer.counts == {"rows": 2, "steps": 1} and inner.counts == {}
    assert inner.start_ns >= outer.start_ns and inner.end_ns <= outer.end_ns
    events = _kineto(prof)
    gaps = []
    for rec in recs:
        (ev,) = [e for e in events if e[0] == rec.name]
        # each record lies inside its profiler range
        assert ev[1] <= rec.start_ns <= rec.end_ns <= ev[2]
        gaps += [rec.start_ns - ev[1], ev[2] - rec.end_ns]
    # and within 50 us of its edges (a median: a collection pause or a
    # descheduled thread can stretch any one range by milliseconds)
    assert np.median(gaps) < 50_000
    for op, rec in (("aten::sum", outer), ("aten::mul", inner)):
        evs = [e for e in events if e[0] == op]
        assert evs and all(rec.start_ns <= a <= b <= rec.end_ns
                           for _, a, b in evs)


def test_the_buffer_drops_and_counts_past_its_capacity(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    with tracing.recording() as recs:
        with tracing.trace_span("cw.t.a"):
            for _ in range(4):
                with tracing.trace_span("cw.t.b"):
                    pass
    assert [r.name for r in recs] == ["cw.t.a", "cw.t.b", "cw.t.b"]
    assert tracing.dropped() == 2
    with tracing.recording() as recs:
        pass
    assert recs == [] and tracing.dropped() == 0


def test_greedy_decode_leaves_three_spans_an_iteration(pipe):
    from crisperwhisper_tpu_torch.decoding.greedy import greedy_decode
    from crisperwhisper_tpu_torch.models.whisper import encode
    mel = np.random.default_rng(0).standard_normal(
        (2, 80, 2 * pipe.arch.max_source_positions)).astype(np.float32)
    enc = encode(pipe.params, pipe.arch, torch.from_numpy(mel))
    sp = pipe.specials
    prompt = torch.tensor([[sp.sot, sp.transcribe]] * 2)
    with tracing.recording() as recs:
        res = greedy_decode(pipe.params, pipe.arch, sp, pipe.gen_opts, enc,
                            prompt, max_new_tokens=9)
    names = [r.name for r in recs]
    # every row's count of generated tokens ends with the loop
    assert res.steps == int(res.num_generated.max()) > 0
    for name in ("cw.decode.step", "cw.decode.select", "cw.decode.sync"):
        assert names.count(name) == res.steps, name
    # on the CPU every step runs eagerly, and no graph is captured
    assert all(r.counts == {"graph": 0} for r in recs
               if r.name == "cw.decode.step")
    assert "cw.decode.capture" not in names
    assert names[:2] == ["cw.decode.cache", "cw.decode.prefill"]
    assert names[2:5] == ["cw.decode.step", "cw.decode.select",
                          "cw.decode.sync"]


def test_a_pipeline_call_leaves_every_layer_span_under_one_call(pipe):
    audio = tone_audio(7.0, 0)
    with tracing.recording() as recs:
        # a text prompt makes the decoder prompt longer than one token,
        # so the prefill runs
        out = pipe({"raw": audio, "sampling_rate": SR},
                   return_timestamps="word", prompt="ab")
    assert isinstance(out["text"], str)
    assert LAYER_SPANS <= {r.name for r in recs}
    assert recs[0].name == "cw.call" and recs[0].parent is None
    assert recs[0].counts["recordings"] == 1
    assert recs[0].counts["audio_s"] == pytest.approx(7.0)
    assert {r.call for r in recs} == {recs[0].call}
    assert all(r.parent is not None for r in recs[1:])
    assert all(r.start_ns <= r.end_ns for r in recs)
    for i, r in enumerate(recs):
        if r.name == "cw.decode":
            steps = [c for c in recs if c.parent == i
                     and c.name == "cw.decode.step"]
            assert r.counts["steps"] == len(steps) > 0
            assert r.counts["rows"] == 2
    gen = [r for r in recs if r.name == "cw.generate"]
    assert [(r.counts["rows"], r.counts["chunks"]) for r in gen] == [(2, 2)]
