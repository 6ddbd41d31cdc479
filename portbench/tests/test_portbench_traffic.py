"""The generator: seed-independent lengths, seed-drawn audio and order,
two full batches a bulk call, the clip grid and its token counts, and
the pipeline's own chunking."""

from __future__ import annotations

import json
import os

import numpy as np

from portbench import generator

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def test_chunk_bounds_match_the_pipelines_chunking():
    from crisperwhisper_tpu_torch.pipeline.asr import chunk_iter
    for n in (1, 80000, 80001, 479999, 480000, 480001, 800000, 800001,
              generator.samples_for_windows(64), 19_200_000):
        got = [length for _, length in generator.chunk_bounds(n)]
        want = [c.stride[0] for c in chunk_iter(
            np.zeros(n, np.float32), 0, 480000, 80000, 80000)]
        assert got == want, n


def test_bulk_call_fills_exactly_two_batches_on_every_seed():
    mix = _mix("bulk-b64")
    first = None
    for seed in (0, 7, 2 ** 31 + 11):
        t = generator.Traffic(mix, seed, mix["pipeline"]["batch_size"])
        calls = [t.next_call() for _ in range(3)]
        for c in calls:
            assert len(t.windows(c)) == 2 * mix["pipeline"]["batch_size"]
            assert sorted(c.recordings) == list(range(len(t.lengths)))
            assert c.max_new == 96
        assert all(60 * 16000 <= n <= 1200 * 16000 for n in t.lengths[:-1])
        if first is None:
            first = t
        else:                                    # same sizes, new order
            assert t.lengths == first.lengths
            assert not all(np.array_equal(a, b) for a, b in
                           zip(t.audio, first.audio))
    assert abs(sum(first.lengths) / 16000 - 2574.506625) < 1e-9


def test_traffic_is_deterministic_by_seed():
    mix = _mix("bulk-b64")
    a = generator.Traffic(mix, 123, 64)
    b = generator.Traffic(mix, 123, 64)
    assert [a.next_call().recordings for _ in range(4)] == \
        [b.next_call().recordings for _ in range(4)]
    assert all(np.array_equal(x, y) for x, y in zip(a.audio, b.audio))


def test_clip_grid_and_token_counts():
    mix = _mix("clip-b1")
    t = generator.Traffic(mix, 5, 1)
    assert [n / 16000 for n in t.lengths] == list(range(2, 31))
    calls = [t.next_call() for _ in range(58)]   # two passes
    for i in (0, 29):
        assert sorted(r for c in calls[i:i + 29] for r in c.recordings) \
            == list(range(29))
    for c in calls:
        (r,) = c.recordings
        secs = t.lengths[r] / 16000
        assert c.max_new == min(96, int(np.ceil(3.2 * secs)))
        assert len(t.windows(c)) == 1
    assert [k for _, k in t.warmup()] == sorted(
        {min(96, int(np.ceil(3.2 * s))) for s in range(2, 31)})
    assert generator.new_tokens(mix["new_tokens"], 2 * 16000) == 7


def test_bulk_warmup_is_one_full_batch():
    mix = _mix("bulk-b64")
    t = generator.Traffic(mix, 1, 64)
    (audios, k), = t.warmup()
    assert len(generator.chunk_bounds(len(audios[0]))) == 64 and k == 96
