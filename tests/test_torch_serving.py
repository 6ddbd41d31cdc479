"""PyTorch port: serving (StreamingBatcher, LiveSession, ASRPipeline.warmup),
tracing (trace_span, RTFMeter), the app's headless pieces, the CLI entry
point and the evaluation copies, against the JAX package on the TINY
checkpoint (f32, one temperature; the JAX decode reads its full ring,
quantum 0). Every port result is held against the JAX package's
``pipe(clip)`` of a 7 s clip: text equal, word timestamps within TS_BAND.
Also the port's batched ``generate`` against per-row decoding, and the
kernel library's first build from two threads."""

import io
import os
import subprocess
import sys
import threading
from collections import defaultdict
from dataclasses import asdict, replace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)
from torch_port_fixtures import (CHUNK_S, TS_BAND, tone_audio,
                                 write_tiny_checkpoint)

SR = 16000
ADJUST = 0.12


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The checkpoint, the 7 s clip, the JAX package's results for it
    (plain and pause-adjusted) and the port's pipelines at batch sizes
    1, 4 and 16 on the CPU."""
    from crisperwhisper_tpu.config import PipelineOptions as JaxOptions
    from crisperwhisper_tpu.hub import load_pipeline as jax_load
    from crisperwhisper_tpu_torch.config import PipelineOptions
    from crisperwhisper_tpu_torch.hub import load_pipeline
    ckpt = write_tiny_checkpoint(str(tmp_path_factory.mktemp("ckpt")))
    clip = tone_audio(7.0, 0)
    jp = jax_load(ckpt, dtype=jnp.float32, pipe_opts=JaxOptions(
        chunk_length_s=CHUNK_S, batch_size=4, return_timestamps="word"))
    jp.gen_opts = replace(jp.gen_opts, temperatures=(0.0,),
                          staged_ring_quantum=0)
    req = {"raw": clip, "sampling_rate": SR}
    ref = jp(dict(req), return_timestamps="word")
    ref_adjusted = jp(dict(req), return_timestamps="word",
                      adjust_pauses_threshold=ADJUST)
    pipes = {}
    for bs in (1, 4, 16):
        p = load_pipeline(ckpt, dtype=torch.float32, device="cpu",
                          pipe_opts=PipelineOptions(
                              chunk_length_s=CHUNK_S, batch_size=bs,
                              return_timestamps="word"))
        p.gen_opts = replace(p.gen_opts, temperatures=(0.0,))
        pipes[bs] = p
    return {"ckpt": ckpt, "clip": clip, "ref": ref,
            "ref_adjusted": ref_adjusted, "pipes": pipes}


def _request(tiny):
    return {"raw": tiny["clip"], "sampling_rate": SR}


def _words(result):
    return [(c["text"], c["timestamp"]) for c in result["chunks"]]


def _matches(got: dict, ref: dict) -> None:
    """Text equal, the same words, each timestamp within TS_BAND."""
    assert got["text"] == ref["text"]
    assert [c["text"] for c in got["chunks"]] == \
        [c["text"] for c in ref["chunks"]]
    assert len(got["chunks"]) > 0
    for g, r in zip(got["chunks"], ref["chunks"]):
        np.testing.assert_allclose(g["timestamp"], r["timestamp"],
                                   atol=TS_BAND)


def test_port_pipeline_matches_jax_on_the_clip(tiny):
    """The baseline of this file: the port's pipe(clip) at each batch
    size against the JAX package's, plain and pause-adjusted."""
    for bs, pipe in tiny["pipes"].items():
        _matches(pipe(_request(tiny), return_timestamps="word"), tiny["ref"])
    _matches(tiny["pipes"][4](_request(tiny), return_timestamps="word",
                              adjust_pauses_threshold=ADJUST),
             tiny["ref_adjusted"])


def test_streaming_batcher_multi_stream(tiny):
    """Four streams through one batcher (their 12 windows in one device
    batch): each result is the JAX package's."""
    from crisperwhisper_tpu_torch.serving import StreamingBatcher
    batcher = StreamingBatcher(tiny["pipes"][16])
    try:
        handles = [batcher.submit(_request(tiny)) for _ in range(4)]
        results = [h.result(timeout=300) for h in handles]
    finally:
        batcher.shutdown()
    for r in results:
        _matches(r, tiny["ref"])


def test_streaming_batcher_live_partials(tiny):
    """At batch_size=1 the stream spans one device batch a window: a
    client sees partials before the result, ordered, prefix-stable except
    the open last word; the final result is the JAX package's."""
    from crisperwhisper_tpu_torch.serving import StreamingBatcher
    partials: list[dict] = []
    batcher = StreamingBatcher(tiny["pipes"][1], max_batch_delay_s=0.01)
    try:
        h = batcher.submit(_request(tiny), on_partial=partials.append)
        final = h.result(timeout=300)
    finally:
        batcher.shutdown()
    _matches(final, tiny["ref"])
    assert partials and all(p["is_partial"] for p in partials)
    ns = [p["n_chunks_done"] for p in partials]
    assert ns == sorted(ns) and any(n < p["n_chunks"]
                                    for n, p in zip(ns, partials))
    final_words = _words(final)
    for p in partials:
        words = _words(p)[:-1]
        assert words == final_words[:len(words)], (words, final_words)
    assert h.partial() is not None and h.partial()["is_partial"]


def test_pipeline_warmup_sizes_and_output_unchanged(tiny):
    """warmup() runs the power-of-2 batch sizes up to batch_size (4:
    [1, 2, 4]) and leaves the pipeline's output as it was."""
    pipe = tiny["pipes"][4]
    before = pipe(_request(tiny), return_timestamps="word")
    assert pipe.warmup() == [1, 2, 4]
    after = pipe(_request(tiny), return_timestamps="word")
    assert after == before
    _matches(after, tiny["ref"])


def test_streaming_batcher_partials_multi_stream(tiny):
    """Three streams with callbacks share the finalizer thread: each gets
    ordered partials without repeats, and the JAX package's result."""
    from crisperwhisper_tpu_torch.serving import StreamingBatcher
    partials = defaultdict(list)
    lock = threading.Lock()
    batcher = StreamingBatcher(tiny["pipes"][4], max_batch_delay_s=0.01)
    try:
        def cb(i):
            def on_partial(p):
                with lock:
                    partials[i].append(p["n_chunks_done"])
            return on_partial
        handles = [batcher.submit(_request(tiny), on_partial=cb(i))
                   for i in range(3)]
        results = [h.result(timeout=300) for h in handles]
    finally:
        batcher.shutdown()
    for r in results:
        _matches(r, tiny["ref"])
    for i in range(3):
        assert partials[i] == sorted(partials[i])
        assert len(set(partials[i])) == len(partials[i])


def test_live_session_matches_offline_pipeline(tiny):
    """Fed in ragged blocks, finish() equals the port's own
    pipe(whole, adjust_pauses_threshold=0.12) exactly, and the JAX
    package's within the band; partials arrive while feeding, ordered and
    prefix-stable (against the unadjusted stitch) except the open last
    word; feeding after finish() raises."""
    from crisperwhisper_tpu_torch.serving import LiveSession
    pipe, audio = tiny["pipes"][4], tiny["clip"]
    own = pipe(_request(tiny), return_timestamps="word",
               adjust_pauses_threshold=ADJUST)
    partials = []
    sess = LiveSession(pipe, adjust_pauses_threshold=ADJUST,
                       on_partial=partials.append)
    rng = np.random.default_rng(5)
    i = 0
    while i < len(audio):
        n = int(rng.integers(1000, 40000))
        sess.feed(audio[i:i + n])
        i += n
    final = sess.finish()
    assert final == own
    _matches(final, tiny["ref_adjusted"])
    assert partials and all(p["is_partial"] for p in partials)
    ns = [p["n_chunks_done"] for p in partials]
    assert ns == sorted(ns)
    raw_words = _words(pipe(_request(tiny), return_timestamps="word"))
    for p in partials:
        words = _words(p)[:-1]
        assert words == raw_words[:len(words)], (words, raw_words)
    with pytest.raises(RuntimeError):
        sess.feed(audio[:100])


def test_empty_stream(tiny):
    """An empty live session and an empty submitted stream finish with
    empty results, as the reference's do."""
    from crisperwhisper_tpu_torch.serving import LiveSession, StreamingBatcher
    assert LiveSession(tiny["pipes"][1]).finish() == {"text": "",
                                                      "chunks": []}
    batcher = StreamingBatcher(tiny["pipes"][1])
    try:
        empty = {"raw": np.zeros(0, np.float32), "sampling_rate": SR}
        assert batcher.submit(empty).result(timeout=10) == {"text": "",
                                                            "chunks": []}
    finally:
        batcher.shutdown()


def test_serving_slice_checks_hold_on_the_cpu(tiny):
    """testing.serving_slice, which the card test and chip_smoke.py run
    on the card, on the CPU: its checks hold, the batcher's streams and
    the session give partials, and its pipeline is the JAX package's on
    the 7 s prefix."""
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.config import WhisperArch
    from crisperwhisper_tpu_torch.models.whisper import init_params
    params = init_params(WhisperArch(**testing.TINY),
                         torch.Generator().manual_seed(0))
    out = testing.serving_slice(testing.write_tiny_configs(
        os.path.join(os.path.dirname(tiny["ckpt"]), "tiny_configs")),
        params, "cpu", tone_audio(12.0, 0))
    assert testing.serving_gap(out) <= TS_BAND
    assert sum(map(len, out["stream_partials"])) >= 3
    assert len(out["live_partials"]) == 3
    out["live"] = dict(out["live"], text=out["live"]["text"] + " ")
    with pytest.raises(AssertionError, match="finish"):
        testing.serving_gap(out)


def test_batcher_worker_runs_on_one_torch_thread(tiny):
    """The worker thread, new to PyTorch, inherits the process's intra-op
    thread count (one, in these tests) and runs every device batch."""
    from crisperwhisper_tpu_torch.serving import StreamingBatcher
    pipe, seen = tiny["pipes"][4], []
    real = pipe._run_chunks

    def spy(*args, **kwargs):
        seen.append((threading.current_thread(), torch.get_num_threads(),
                     torch.is_inference_mode_enabled()))
        return real(*args, **kwargs)
    pipe._run_chunks = spy
    batcher = StreamingBatcher(pipe)
    try:
        _matches(batcher.submit(_request(tiny)).result(timeout=300),
                 tiny["ref"])
    finally:
        batcher.shutdown()
        del pipe._run_chunks
    assert seen and all(t is batcher._worker and n == 1 and not inf
                        for t, n, inf in seen)


def test_streaming_batcher_fails_the_stream_on_a_worker_error(tiny):
    """An exception in the worker's device batch reaches the caller
    through result()."""
    from crisperwhisper_tpu_torch.serving import StreamingBatcher
    pipe = tiny["pipes"][4]

    def broken(*args, **kwargs):
        raise RuntimeError("device batch failed")
    pipe._run_chunks = broken
    batcher = StreamingBatcher(pipe)
    try:
        with pytest.raises(RuntimeError, match="device batch failed"):
            batcher.submit(_request(tiny)).result(timeout=60)
    finally:
        batcher.shutdown()
        del pipe._run_chunks


def test_batched_heterogeneous_generate_equals_per_row():
    """Twin of tests/test_batch_shrink.py: rows of 1, 1.5 and 2.5 windows
    decoded together equal each row decoded alone (eot beyond the shorter
    one), with the same number of segments."""
    import jax
    from crisperwhisper_tpu.models import init_params
    from crisperwhisper_tpu_torch.config import GenerationOptions
    from crisperwhisper_tpu_torch.decoding.longform import generate
    from crisperwhisper_tpu_torch.models.loader import params_from_jax
    from helpers import TINY_SPECIALS, rand_mel, tiny_arch
    arch = tiny_arch()
    params = params_from_jax(jax.device_get(
        init_params(arch, jax.random.PRNGKey(0))), arch)
    opts = GenerationOptions(max_initial_timestamp_index=50,
                             max_new_tokens=24, temperatures=(0.0,),
                             compression_ratio_threshold=None,
                             logprob_threshold=None,
                             no_speech_threshold=None)
    mel = torch.from_numpy(rand_mel(batch=3, seed=31, frames=1250))
    lens = np.array([500, 800, 1250])
    batched = generate(params, arch, TINY_SPECIALS, opts, mel,
                       num_frames=lens, max_frames=lens)
    for i in range(3):
        solo = generate(params, arch, TINY_SPECIALS, opts, mel[i:i + 1],
                        num_frames=lens[i:i + 1], max_frames=lens[i:i + 1])
        bi, si = batched.sequences[i], solo.sequences[0]
        n = min(len(bi), len(si))
        np.testing.assert_array_equal(bi[:n], si[:n])
        assert (bi[n:] == TINY_SPECIALS.eot).all()
        assert (si[n:] == TINY_SPECIALS.eot).all()
        assert len(batched.segments[i]) == len(solo.segments[0]) > 0


def test_trace_span_is_a_profiler_event(tmp_path):
    """trace_span names an event in torch.profiler's CPU timeline, and
    start_profiler / stop_profiler write a Chrome trace that holds it."""
    import json
    from crisperwhisper_tpu_torch.utils import tracing
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.trace_span("cw_test_span"):
            torch.ones(4).sum()
    assert "cw_test_span" in {e.name for e in prof.events()}
    tracing.start_profiler(str(tmp_path / "trace"))
    with tracing.trace_span("cw_test_span_2"):
        torch.ones(4).sum()
    tracing.stop_profiler()
    (path,) = (tmp_path / "trace").iterdir()
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "cw_test_span_2" in names


def test_rtf_meter_summary_matches_jax():
    """The port's RTFMeter fed the same audio and wall seconds gives the
    JAX meter's summary: keys, values and rounding."""
    from crisperwhisper_tpu.utils.tracing import RTFMeter as JaxMeter
    from crisperwhisper_tpu.utils.tracing import StageStats as JaxStats
    from crisperwhisper_tpu_torch.utils.tracing import RTFMeter, StageStats
    feeds = [(7.123456, "pipeline", 0.0123456), (30.0, "pipeline", 1.98765),
             (12.5, "encode", 0.4444449), (0.0, "pipeline", 0.0005)]
    summaries = []
    for meter, stats in ((RTFMeter(), StageStats), (JaxMeter(), JaxStats)):
        for audio_s, stage, dt in feeds:
            meter.audio_seconds += audio_s
            meter.wall_seconds += dt
            meter.stages.setdefault(stage, stats()).add(dt)
        summaries.append(meter.summary())
    assert summaries[0] == summaries[1]
    assert set(summaries[0]) == {"audio_seconds", "wall_seconds", "rtfx",
                                 "stages"}
    meter = RTFMeter()
    with meter.measure(3.0, "pipeline"):
        pass
    assert meter.audio_seconds == 3.0 and meter.rtfx > 0
    assert meter.stages["pipeline"].calls == 1


def test_pipeline_meter_counts_a_call(tiny):
    """pipe.meter is an RTFMeter: one call adds its audio seconds and a
    positive RTFx under the "pipeline" stage."""
    from crisperwhisper_tpu_torch.utils.tracing import RTFMeter
    pipe = tiny["pipes"][16]
    pipe.meter = RTFMeter()
    pipe(_request(tiny), return_timestamps="word")
    assert pipe.meter.rtfx > 0
    assert pipe.meter.audio_seconds == pytest.approx(7.0)
    assert pipe.meter.summary()["stages"]["pipeline"]["calls"] == 1


def test_vtt_rendering_matches_jax():
    from crisperwhisper_tpu.app import timestamps_to_vtt as jax_vtt
    from crisperwhisper_tpu_torch.app import timestamps_to_vtt, transcript_html
    from crisperwhisper_tpu.app import transcript_html as jax_html
    chunks = [{"text": " hello", "timestamp": (0.0, 0.5)},
              {"text": " world", "timestamp": (0.6, 1.25)},
              {"text": " open", "timestamp": (3725.5, None)}]
    vtt = timestamps_to_vtt(chunks)
    assert vtt == jax_vtt(chunks)
    assert vtt.startswith("WEBVTT")
    assert "00:00:00.600 --> 00:00:01.250" in vtt
    assert transcript_html(chunks[:2]) == jax_html(chunks[:2])


def _wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    from scipy.io import wavfile
    buf = io.BytesIO()
    wavfile.write(buf, sr, (audio * 32767).astype(np.int16))
    return buf.getvalue()


def test_process_audio_bytes_roundtrip_matches_jax():
    from crisperwhisper_tpu.app import process_audio_bytes as jax_process
    from crisperwhisper_tpu_torch.app import process_audio_bytes
    rng = np.random.default_rng(0)
    data = _wav_bytes((rng.standard_normal(8000) * 0.3).astype(np.float32),
                      8000)
    out = process_audio_bytes(data, target_sr=16000)
    assert out.shape[0] == 16000
    assert abs(float(np.std(out)) - 1 / 8) < 0.02
    np.testing.assert_array_equal(out, jax_process(data, target_sr=16000))


def test_process_audio_bytes_mic_contract_matches_jax():
    """44.1 kHz stereo int16 WAV bytes (the mic recorder's payload) in,
    normalized 16 kHz mono f32 out, equal to the JAX package's."""
    from crisperwhisper_tpu.app import process_audio_bytes as jax_process
    from crisperwhisper_tpu_torch.app import process_audio_bytes
    sr = 44100
    t = np.arange(sr // 2) / sr
    tone = (0.2 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    data = _wav_bytes(np.stack([tone, tone * 0.5], axis=1), sr)
    out = process_audio_bytes(data, target_sr=16000)
    assert out.dtype == np.float32 and out.ndim == 1
    assert abs(out.shape[0] - 8000) <= 2
    np.testing.assert_array_equal(out, jax_process(data, target_sr=16000))


def test_build_app_pipeline_runs_on_the_card_by_default(tiny, monkeypatch):
    """The app's pipeline is load_pipeline's default device, the card:
    without one it raises and names device="cpu"."""
    from crisperwhisper_tpu_torch.app import build_app_pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_app_pipeline(tiny["ckpt"])


def _number_cases():
    from test_number_normalizer import CASES
    return CASES


@pytest.mark.parametrize("case", _number_cases())
def test_number_normalizer_copy_matches_jax(case):
    from crisperwhisper_tpu.tokenizer.number_normalizer import \
        EnglishNumberNormalizer as Jax
    from crisperwhisper_tpu_torch.tokenizer.number_normalizer import \
        EnglishNumberNormalizer
    assert EnglishNumberNormalizer()(case) == Jax()(case)


def test_text_normalizers_copy_matches_jax():
    from crisperwhisper_tpu.tokenizer import normalizers as J
    from crisperwhisper_tpu_torch.tokenizer import normalizers as T
    spelling = {"colour": "color", "humour": "humor"}
    for text in ("Hello, World!", "um [UH] so... (noise) THE cat",
                 "  a  b\tc ", "naïve café — no?",
                 "Um, I [UH] won't do that.", "the colour hmm is nice",
                 "he's gone and they're mm here",
                 "It's twenty-two, okay?", "humour, colour and valour."):
        assert T.BasicTextNormalizer()(text) == J.BasicTextNormalizer()(text)
        assert T.EnglishTextNormalizer(spelling)(text) == \
            J.EnglishTextNormalizer(spelling)(text)
    with pytest.raises(ValueError, match="normalizer.json"):
        T.EnglishTextNormalizer()("the colour of humour")


def test_evaluation_copy_matches_jax():
    """The WER and segmentation scores of tests/test_evaluation.py's
    inputs, through both packages."""
    from crisperwhisper_tpu.tokenizer.normalizers import \
        EnglishTextNormalizer as JaxNorm
    from crisperwhisper_tpu.utils import evaluation as J
    from crisperwhisper_tpu_torch.tokenizer.normalizers import \
        EnglishTextNormalizer
    from crisperwhisper_tpu_torch.utils import evaluation as T
    pairs = [("a b c", "a b c"), ("a b c", "a x c"), ("a b c", "a b"),
             ("a b", "a b c"), ("a b c", "a c"), ("a b c", "a b x c"),
             ("", "x y"), ("the quick brown fox jumps",
                           "the quack brown jumps over")]
    for r, h in pairs:
        assert T.wer([r], [h]) == J.wer([r], [h])
        assert asdict(T.word_error_rate(r, h)) == \
            asdict(J.word_error_rate(r, h))
    assert T.wer(["the [UH] cat"], ["the um cat"],
                 normalizer=EnglishTextNormalizer({})) == \
        J.wer(["the [UH] cat"], ["the um cat"], normalizer=JaxNorm({})) == 0
    assert T.word_error_rate("It's twenty-two, okay?", "it is 22 okay",
                             normalizer=EnglishTextNormalizer({})).wer == 0
    ref = [{"text": " hello", "timestamp": (0.0, 0.5)},
           {"text": " world", "timestamp": (0.6, 1.0)}]
    hyp = [{"text": " hello", "timestamp": (0.2, 0.7)},
           {"text": " world", "timestamp": (0.6, 1.01)}]
    assert asdict(T.word_segmentation_score(ref, hyp, collar=0.05)) == \
        asdict(J.word_segmentation_score(ref, hyp, collar=0.05))
    assert T.align_matched_words(["a", "b", "c", "d"], ["a", "x", "c"]) == \
        J.align_matched_words(["a", "b", "c", "d"], ["a", "x", "c"])
    words = [[("a", 0.0, 1.0), ("b", 2.0, 3.0)],
             [("a", 0.04, 1.04), ("b", 2.2, 3.2)],
             [("a", 0.0, 1.0), ("zz", 1.0, 2.0)]]
    for hw in words:
        assert asdict(T.segmentation_scores(words[0], hw, collar=0.05)) \
            == asdict(J.segmentation_scores(words[0], hw, collar=0.05))
    assert T.chunks_to_words(ref) == J.chunks_to_words(ref)


def test_module_entry_point_help():
    """python -m crisperwhisper_tpu_torch is the port's CLI."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "crisperwhisper_tpu_torch",
                           "--help"], capture_output=True, text=True,
                          cwd=repo, timeout=120,
                          env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout


def test_kernel_library_builds_once_from_two_threads(monkeypatch):
    """Two threads that make their first launch together (a live session
    and a batcher's worker) run one build: the first build and the first
    launcher lookup are under one lock."""
    import time
    from pathlib import Path
    from unittest import mock
    from crisperwhisper_tpu_torch import _build
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return Path("/nonexistent/libcw_kernels_stub.so"), 0.2, ""
    monkeypatch.setattr(_build, "_build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: mock.MagicMock())
    monkeypatch.setattr(_build, "_cuda_api", lambda: (lambda: 0,
                                                      lambda i: 0))
    _build._load.cache_clear()
    _build.kernels.cache_clear()
    _build.launcher.cache_clear()
    try:
        got = []
        start = threading.Barrier(2)

        def first_launch():
            start.wait()
            got.append((_build.kernels(), _build.launcher("cw_probe_add")))
        threads = [threading.Thread(target=first_launch) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert len(builds) == 1 and len(got) == 2
        assert got[0][0] is got[1][0]
    finally:
        _build._load.cache_clear()
        _build.kernels.cache_clear()
        _build.launcher.cache_clear()
