"""PyTorch port: speculative decoding (decoding/assisted.py) against the
JAX package's assisted_decode at f32, the exactness contract (assisted
equals greedy), and the speculative pipeline and CLI against the JAX
package's on the TINY checkpoint."""

import json
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from helpers import TINY_SPECIALS, rand_mel, tiny_arch
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)
from torch_port_fixtures import CHUNK_S, SR, TS_BAND, tone_audio, write_wav

MAX_NEW = 20
_SEL = ((0, 1), (1, 2))


def test_ngram_propose_matches_jax():
    """Random token buffers over a small vocabulary (many repeats), each
    n-gram size, rows with no match and rows shorter than n + 1: the same
    drafts as the JAX function, exactly."""
    from crisperwhisper_tpu.decoding.assisted import ngram_propose
    from crisperwhisper_tpu_torch.decoding.assisted import \
        ngram_propose as tprop
    jprop = jax.jit(ngram_propose, static_argnums=(2,),
                    static_argnames=("ngram_sizes", "fill"))
    rng = np.random.default_rng(0)
    fill, tt, s = 77, 24, 3
    toks = rng.integers(0, 5, (40, tt)).astype(np.int32)
    toks[-2] = np.arange(tt)                          # no repetition at all
    lengths = rng.integers(1, tt - s + 1, (40,)).astype(np.int32)
    lengths[:3] = [1, 2, 3]                           # below n + 1
    for sizes in ((3, 2), (4, 3, 2)):
        want = np.asarray(jprop(jnp.asarray(toks), jnp.asarray(lengths), s,
                                ngram_sizes=sizes, fill=fill))
        got = tprop(torch.from_numpy(toks), torch.from_numpy(lengths), s,
                    ngram_sizes=sizes, fill=fill).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(sizes))
        assert (got[-2] == fill).all() and (got[0] == fill).all()


# Random TINY weights decode the same tokens whatever the audio; these
# weights (PRNGKey(3)) fall into repeated tokens that prompt lookup
# accepts, and the three forced second tokens of the batch-3 prompt send
# its rows down different paths, so they accept different counts.
_PROMPTS = {1: [[TINY_SPECIALS.sot]],
            3: [[TINY_SPECIALS.sot, tok] for tok in (903, 901, 5)]}


@pytest.fixture(scope="module")
def tiny():
    """TINY f32 weights in both packages, encoder states of 1 and 3 rows
    (computed once, by the port, and handed to both), and the port's
    greedy result of each batch."""
    from crisperwhisper_tpu.config import GenerationOptions
    from crisperwhisper_tpu.models import alignment_selector, init_params
    from crisperwhisper_tpu_torch.decoding.greedy import greedy_decode
    from crisperwhisper_tpu_torch.models.loader import params_from_jax
    from crisperwhisper_tpu_torch.models.whisper import encode
    arch = tiny_arch()
    jp = jax.device_get(init_params(arch, jax.random.PRNGKey(3)))
    tp = params_from_jax(jp, arch)
    opts = GenerationOptions(max_initial_timestamp_index=50)
    sel = alignment_selector(arch, _SEL)
    encs, greedy = {}, {}
    for b in (1, 3):
        encs[b] = encode(tp, arch, torch.from_numpy(
            rand_mel(batch=b, seed=5))).numpy()
        greedy[b] = greedy_decode(
            tp, arch, TINY_SPECIALS, opts, torch.from_numpy(encs[b]),
            torch.tensor(_PROMPTS[b]), max_new_tokens=MAX_NEW,
            align_sel=sel)
    return dict(arch=arch, jp=jp, tp=tp, opts=opts, sel=sel, encs=encs,
                greedy=greedy)


def _assert_same(got, ref, t_total):
    """Equal sequences and counts; logprob sums within 1e-5 of their
    magnitude, no-speech within 1e-6, alignment rows within 2e-5."""
    np.testing.assert_array_equal(np.asarray(got.sequences)[:, :t_total],
                                  np.asarray(ref.sequences)[:, :t_total])
    np.testing.assert_array_equal(np.asarray(got.num_generated),
                                  np.asarray(ref.num_generated))
    np.testing.assert_allclose(np.asarray(got.sum_logprobs),
                               np.asarray(ref.sum_logprobs), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.no_speech_probs),
                               np.asarray(ref.no_speech_probs), atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.align_probs),
                               np.asarray(ref.align_probs), atol=2e-5)


@pytest.mark.parametrize("draft,batch", [
    ("lookup", 1), ("lookup", 3), ("self:1", 1), ("script", 1),
    ("script-corrupted", 1)])
def test_assisted_matches_jax_and_greedy(tiny, monkeypatch, draft, batch):
    """Prompt lookup at batch 1 and at batch 3 (rows at different
    positions), a one-layer self-draft, and a scripted draft accepted in
    full or corrupted at every third slot: the JAX assisted_decode's
    result, and the port's own greedy_decode's."""
    from crisperwhisper_tpu.decoding import assisted_decode_jit
    from crisperwhisper_tpu.decoding.assisted import \
        make_self_draft as jself
    from crisperwhisper_tpu_torch.decoding import assisted as A
    arch, jp, tp, sel = tiny["arch"], tiny["jp"], tiny["tp"], tiny["sel"]
    enc, greedy = tiny["encs"][batch], tiny["greedy"][batch]
    opts = tiny["opts"]
    prompt = np.asarray(_PROMPTS[batch], np.int32)
    t_total = prompt.shape[1] + MAX_NEW
    spec = 4 if draft.startswith("script") else 3
    jdraft = jdarch = tdraft = tdarch = script = None
    if draft == "self:1":
        jdraft, jdarch = jself(jp, arch, 1)
        tdraft, tdarch = A.make_self_draft(tp, arch, 1)
    elif draft.startswith("script"):
        script = greedy.sequences.numpy().astype(np.int32)
        if draft == "script-corrupted":
            script[:, ::3] = (script[:, ::3] + 11) % arch.vocab_size
    want = jax.device_get(assisted_decode_jit(
        jp, arch, jdraft, jdarch, TINY_SPECIALS, opts, jnp.asarray(enc),
        jnp.asarray(enc) if jdraft is not None else None,
        jnp.asarray(prompt), MAX_NEW, spec_len=spec,
        align_sel=jnp.asarray(sel),
        draft_script=None if script is None else jnp.asarray(script)))
    starts = []
    multi = A.decode_step_multi

    def spy(params, arch_, block, position, *a, **kw):
        starts.append(np.asarray(position).reshape(-1).tolist())
        return multi(params, arch_, block, position, *a, **kw)
    monkeypatch.setattr(A, "decode_step_multi", spy)
    tenc = torch.from_numpy(enc)
    got = A.assisted_decode(
        tp, arch, tdraft, tdarch, TINY_SPECIALS, opts, tenc,
        tenc if tdraft is not None else None, torch.from_numpy(prompt),
        max_new_tokens=MAX_NEW, spec_len=spec, align_sel=sel,
        draft_script=None if script is None else torch.from_numpy(script))
    _assert_same(got, want, t_total)
    _assert_same(got, greedy, t_total)
    if batch > 1:       # the rows accepted differently: ragged positions
        assert any(len(set(p)) > 1 for p in starts), starts
    if draft != "script-corrupted":       # some candidates were accepted
        assert len(starts) < MAX_NEW, starts
    if draft == "script":                 # full acceptance: few blocks
        assert len(starts) <= -(-MAX_NEW // spec) + 1, starts


# ---------------------------------------------------------------------------
# The speculative pipeline and CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The TINY checkpoint directory with the PRNGKey(3) weights of
    ``tiny`` (written by the JAX package) and a 7 s WAV (two windows, the
    second cropped)."""
    from crisperwhisper_tpu.models import init_params
    from crisperwhisper_tpu.models.loader import save_hf_checkpoint
    from crisperwhisper_tpu_torch.testing import write_tiny_configs
    path = str(tmp_path_factory.mktemp("ckpt"))
    save_hf_checkpoint(path, jax.device_get(init_params(
        tiny_arch(), jax.random.PRNGKey(3))), tiny_arch())
    write_tiny_configs(path)
    wav = write_wav(str(tmp_path_factory.mktemp("audio") / "clip.wav"),
                    tone_audio(7.0, 0))
    return path, wav


@pytest.mark.parametrize("assistant", ["prompt_lookup", "self:1"])
def test_pipeline_with_assistant_equals_plain(ckpt, monkeypatch, assistant):
    """load_pipeline(assistant=...) at f32 on a 7 s clip (a full and a
    cropped window) gives the plain pipeline's text, words and word
    timestamps, and the windows went the speculative path."""
    from crisperwhisper_tpu_torch.config import PipelineOptions
    from crisperwhisper_tpu_torch.decoding import assisted
    from crisperwhisper_tpu_torch.hub import load_pipeline
    calls = []
    real = assisted.assisted_decode

    def spy(*a, **kw):
        calls.append(a[2] is not None)          # a draft model?
        return real(*a, **kw)
    monkeypatch.setattr(assisted, "assisted_decode", spy)
    path, wav = ckpt
    po = PipelineOptions(chunk_length_s=CHUNK_S, batch_size=16,
                         return_timestamps="word")
    results = []
    for a in (assistant, None):
        tp = load_pipeline(path, dtype=torch.float32, device="cpu",
                           pipe_opts=po, assistant=a)
        results.append(tp(wav, return_timestamps="word",
                          adjust_pauses_threshold=0.12))
    got, plain = results
    assert got == plain and len(got["chunks"]) > 0
    assert calls and set(calls) == {assistant != "prompt_lookup"}


@pytest.mark.parametrize("assistant", ["prompt_lookup", "self:1"])
def test_cli_assistant_matches_jax_cli(ckpt, capsys, monkeypatch, assistant):
    """The port's CLI with --assistant (on the CPU) prints the JSON of the
    JAX package's CLI with the same flags, both loading f32 weights: the
    same text and words, word timestamps within one DTW frame."""
    import functools
    from crisperwhisper_tpu import hub as jhub
    from crisperwhisper_tpu.cli import main as jax_main
    from crisperwhisper_tpu_torch import hub
    from crisperwhisper_tpu_torch.cli import main
    monkeypatch.setattr(jhub, "load_pipeline", functools.partial(
        jhub.load_pipeline, dtype=jnp.float32))
    monkeypatch.setattr(hub, "load_pipeline", functools.partial(
        hub.load_pipeline, dtype=torch.float32))
    path, wav = ckpt
    flags = ["--f", wav, "--model", path, "--chunk-length-s", str(CHUNK_S),
             "--json", "--adjust-pauses", "0.12", "--assistant", assistant]
    outs = []
    for fn, extra in ((jax_main, []), (main, ["--device", "cpu"])):
        rc = fn(flags + extra)
        out = capsys.readouterr().out.strip().splitlines()[-1]
        assert rc == 0, out
        outs.append(json.loads(out))
    ref, got = outs
    assert got["text"] == ref["text"] and len(got["chunks"]) > 0
    assert [c["text"] for c in got["chunks"]] == \
        [c["text"] for c in ref["chunks"]]
    for g, r in zip(got["chunks"], ref["chunks"]):
        np.testing.assert_allclose(g["timestamp"], r["timestamp"],
                                   atol=TS_BAND)


def test_assistant_max_batch_gate_matches_jax(ckpt, monkeypatch):
    """PipelineOptions.assistant_max_batch=1: the port hands generate() the
    assistant for the same batches as the reference (none to the 2-row
    group of a 9 s clip, the 1-row batch of a 4 s clip; without a limit
    every batch speculates, test_pipeline_with_assistant_equals_plain),
    and the transcripts agree."""
    from crisperwhisper_tpu.config import PipelineOptions as JPO
    from crisperwhisper_tpu.hub import load_pipeline as jax_load
    from crisperwhisper_tpu.pipeline import asr as jasr
    from crisperwhisper_tpu_torch.config import PipelineOptions
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.pipeline import asr as tasr
    path, _ = ckpt
    seen = {"jax": [], "torch": []}
    for side, mod in (("jax", jasr), ("torch", tasr)):
        real = mod.generate

        def spy(*a, _real=real, _side=side, **kw):
            seen[_side].append(kw.get("assistant"))
            return _real(*a, **kw)
        monkeypatch.setattr(mod, "generate", spy)
    kw = dict(chunk_length_s=CHUNK_S, batch_size=2, return_timestamps="word")
    pipes = {"jax": jax_load(path, dtype=jnp.float32, pipe_opts=JPO(**kw),
                             assistant="prompt_lookup"),
             "torch": load_pipeline(path, dtype=torch.float32, device="cpu",
                                    pipe_opts=PipelineOptions(**kw),
                                    assistant="prompt_lookup")}
    audio = tone_audio(9.0, 3)
    texts = {"jax": [], "torch": []}
    for side, pipe in pipes.items():
        pipe.gen_opts = replace(pipe.gen_opts, temperatures=(0.0,),
                                max_new_tokens=8)
        pipe.pipe_opts = replace(pipe.pipe_opts, assistant_max_batch=1)
        for clip in (audio, audio[:4 * SR]):
            texts[side].append(pipe({"raw": clip, "sampling_rate": SR},
                                    return_timestamps="word")["text"])
    assert seen["torch"] == seen["jax"]
    assert None in seen["torch"] and "prompt_lookup" in seen["torch"]
    assert texts["torch"] == texts["jax"]
