"""PyTorch port: the prompting paths (condition_on_prev_tokens, prompt_ids)
and beam search through the seek loop and the pipeline, against the JAX
package on the TINY model at f32.

Decode loops: greedy, speculative and beam decoding with a conditioned
prompt's key mask and position offsets give the reference's tokens.
Long-form ``generate``: the beam fallback cases of
tests/test_beam_fallback_e2e.py, conditioning in the static and dynamic
modes, prompt_ids in both condition types and unconditioned, and the two
ValueErrors of the reference (longform.py:303-312): equal segments and
sequences, token timestamps within one DTW frame (0.02 s)."""

from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from helpers import TINY_SPECIALS, rand_mel, tiny_arch
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)
from torch_port_fixtures import (SR, TS_BAND, port_config, tiny_state_dict,
                                 tone_audio, write_tiny_checkpoint)

ALIGN = ((0, 1), (1, 3))
FRAMES = 1250                       # 12.5 s: three 5 s windows
# plain-vocabulary prompt ids led by <|startofprev|>, the shape
# tokenizer.get_prompt_ids gives (tests/test_prompt_ids.py)
PROMPT = (TINY_SPECIALS.sot_prev, 17, 42, 203, 5)


@pytest.fixture(scope="module")
def tiny():
    from crisperwhisper_tpu.config import GenerationOptions
    from crisperwhisper_tpu.models import params_from_state_dict
    from crisperwhisper_tpu_torch.models.loader import params_from_jax
    arch = tiny_arch()
    jp = jax.device_get(params_from_state_dict(tiny_state_dict(), arch,
                                               dtype=jnp.float32))
    opts = GenerationOptions(
        alignment_heads=ALIGN, median_filter_width=7,
        max_initial_timestamp_index=50, compression_ratio_threshold=None,
        logprob_threshold=None, no_speech_threshold=None,
        temperatures=(0.0,), max_new_tokens=24)
    return {"arch": arch, "jax": jp, "torch": params_from_jax(jp, arch),
            "opts": opts}


def _conditioned_prompt():
    """Two rows of a left-padded conditioned prompt: (prompt, mask,
    offsets); row 0 has three eot pads."""
    sp = TINY_SPECIALS
    prompt = np.array([[sp.eot, sp.eot, sp.eot, sp.sot_prev, 11, sp.sot,
                        sp.transcribe],
                       [sp.sot_prev, 21, 22, 23, 24, sp.sot,
                        sp.transcribe]], np.int32)
    mask = prompt != sp.eot
    return prompt, mask, (~mask).sum(1).astype(np.int32)


@pytest.mark.parametrize("loop", ["greedy", "assisted", "beam"])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_decode_loops_with_conditioned_prompt_match_jax(tiny, loop, mode):
    """A left-padded conditioned prompt with its mask (and, in the dynamic
    mode, its pad-count offsets) through each decode loop: the
    reference's tokens and counts, alignment rows within 2e-5. The
    speculative loop is held to the reference's greedy decode (its
    exactness contract)."""
    from crisperwhisper_tpu.decoding.beam import beam_decode_jit
    from crisperwhisper_tpu.decoding.greedy import greedy_decode_jit
    from crisperwhisper_tpu.models import alignment_selector, encode as jenc
    from crisperwhisper_tpu_torch.decoding.assisted import assisted_decode
    from crisperwhisper_tpu_torch.decoding.beam import beam_decode
    from crisperwhisper_tpu_torch.decoding.greedy import greedy_decode
    from crisperwhisper_tpu_torch.models.whisper import encode
    arch, opts = tiny["arch"], tiny["opts"]
    mel = rand_mel(batch=2, seed=12)
    je = jenc(tiny["jax"], arch, jnp.asarray(mel))
    te = encode(tiny["torch"], arch, torch.from_numpy(mel))
    prompt, mask, offset = _conditioned_prompt()
    offset = offset if mode == "dynamic" else None
    sel = alignment_selector(arch, ALIGN)
    jkw = dict(align_sel=jnp.asarray(sel), prompt_mask=jnp.asarray(mask),
               sot_position=5,
               pos_offset=None if offset is None else jnp.asarray(offset))
    tkw = dict(max_new_tokens=20, align_sel=sel, prompt_mask=mask,
               sot_position=5, pos_offset=offset)
    spec, topts = port_config(TINY_SPECIALS), port_config(opts)
    if loop == "beam":
        ref = beam_decode_jit(tiny["jax"], arch, TINY_SPECIALS, opts, je,
                              jnp.asarray(prompt), 20, 3, **jkw)
        got = beam_decode(tiny["torch"], arch, spec, topts, te,
                          torch.from_numpy(prompt), num_beams=3, **tkw)
        np.testing.assert_allclose(got.sequences_scores.numpy(),
                                   np.asarray(ref.sequences_scores),
                                   atol=1e-5, rtol=0)
    else:
        ref = greedy_decode_jit(tiny["jax"], arch, TINY_SPECIALS, opts, je,
                                jnp.asarray(prompt), 20, **jkw)
        if loop == "greedy":
            got = greedy_decode(tiny["torch"], arch, spec, topts, te,
                                torch.from_numpy(prompt), **tkw)
        else:
            got = assisted_decode(tiny["torch"], arch, None, None, spec,
                                  topts, te, None, torch.from_numpy(prompt),
                                  spec_len=3, **tkw)
    ref = jax.device_get(ref)
    np.testing.assert_array_equal(got.sequences.numpy(), ref.sequences)
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  ref.num_generated)
    np.testing.assert_allclose(got.no_speech_probs.numpy(),
                               ref.no_speech_probs, atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(got.align_probs.numpy(), ref.align_probs,
                               atol=2e-5, rtol=1e-4)


def _generate_both(tiny, change, batch, seed, frames=FRAMES, assistant=None):
    """The JAX and the port's long-form generate on the same mel, with
    ``change`` applied to the options on both sides."""
    from crisperwhisper_tpu.decoding import generate as jgen
    from crisperwhisper_tpu_torch.decoding.longform import generate
    opts = replace(tiny["opts"], **change)
    mel = rand_mel(batch=batch, seed=seed, frames=frames)
    n = np.full((batch,), frames)
    ref = jgen(tiny["jax"], tiny["arch"], TINY_SPECIALS, opts,
               jnp.asarray(mel), num_frames=n, max_frames=n,
               assistant=assistant)
    got = generate(tiny["torch"], tiny["arch"], port_config(TINY_SPECIALS),
                   port_config(opts), torch.from_numpy(mel), num_frames=n,
                   max_frames=n, assistant=assistant)
    return ref, got


def _assert_same_output(ref, got):
    np.testing.assert_array_equal(got.sequences, ref.sequences)
    assert len(got.segments) == len(ref.segments)
    for rs, gs in zip(ref.segments, got.segments):
        assert len(gs) == len(rs)
        for r, g in zip(rs, gs):
            np.testing.assert_array_equal(np.asarray(g["tokens"]),
                                          np.asarray(r["tokens"]))
            np.testing.assert_allclose([g["start"], g["end"]],
                                       [r["start"], r["end"]], atol=TS_BAND)
    if ref.token_timestamps is None:
        assert got.token_timestamps is None
    else:
        np.testing.assert_allclose(got.token_timestamps,
                                   ref.token_timestamps, atol=TS_BAND)


@pytest.mark.parametrize("case,change,batch,seed", [
    # tests/test_beam_fallback_e2e.py:62-150: the logprob gate fails every
    # window, the ladder is exhausted and the failing beam result is kept
    ("last temperature", dict(logprob_threshold=1e9, num_beams=4), 2, 61),
    # two zero temperatures: a deterministic retry, kept as the last try
    ("retry ladder", dict(logprob_threshold=1e9, num_beams=4,
                          temperatures=(0.0, 0.0)), 2, 62),
    # both gates trip: every window skipped, empty output
    ("skip on silence", dict(logprob_threshold=1e9, no_speech_threshold=-1.0,
                             num_beams=4), 1, 63),
    ("conditioned static", dict(condition_on_prev_tokens=True,
                                max_new_tokens=30), 2, 41),
    ("conditioned dynamic", dict(condition_on_prev_tokens=True,
                                 condition_mode="dynamic",
                                 max_new_tokens=30), 2, 41),
    ("conditioned beams", dict(condition_on_prev_tokens=True,
                               condition_mode="dynamic", num_beams=3), 2, 44),
    ("prompt first-segment", dict(prompt_ids=PROMPT,
                                  condition_on_prev_tokens=True,
                                  condition_mode="dynamic"), 2, 33),
    ("prompt all-segments", dict(prompt_ids=PROMPT,
                                 prompt_condition_type="all-segments",
                                 condition_on_prev_tokens=True,
                                 condition_mode="dynamic"), 2, 35),
    ("prompt unconditioned", dict(prompt_ids=PROMPT), 2, 31)])
def test_generate_matches_jax(tiny, case, change, batch, seed):
    ref, got = _generate_both(tiny, change, batch, seed)
    _assert_same_output(ref, got)
    if case == "skip on silence":
        assert got.sequences.shape[1] == 0 and got.segments == [[]]
    else:
        assert all(len(s) > 0 for s in got.segments)


def test_generate_conditioned_with_assistant_matches_jax(tiny):
    """Prompt lookup under dynamic conditioning (the conditioned windows
    reach the speculative loop with their mask and offsets): the
    reference's output."""
    ref, got = _generate_both(tiny, dict(condition_on_prev_tokens=True,
                                         condition_mode="dynamic"), 2, 41,
                              assistant="prompt_lookup")
    _assert_same_output(ref, got)


@pytest.mark.parametrize("change,match", [
    (dict(prompt_ids=PROMPT, prompt_condition_type="all-segments"),
     "condition_on_prev_tokens"),
    (dict(prompt_condition_type="every-segment"), "does not exist")])
def test_generate_rejects_what_the_reference_rejects(tiny, change, match):
    from crisperwhisper_tpu.decoding import generate as jgen
    from crisperwhisper_tpu_torch.decoding.longform import generate
    opts = replace(tiny["opts"], **change)
    mel = rand_mel(batch=1, seed=1)
    with pytest.raises(ValueError, match=match):
        jgen(tiny["jax"], tiny["arch"], TINY_SPECIALS, opts,
             jnp.asarray(mel))
    with pytest.raises(ValueError, match=match):
        generate(tiny["torch"], tiny["arch"], port_config(TINY_SPECIALS),
                 port_config(opts), torch.from_numpy(mel))


def test_pipeline_prompt_matches_jax(tmp_path):
    """pipe(audio, prompt=text) with condition_on_prev_tokens on the 12 s
    clip: the text becomes prompt ids through the tokenizer's
    get_prompt_ids on both sides, and the result equals the reference's
    (text and words equal, word timestamps within one DTW frame)."""
    from crisperwhisper_tpu.config import PipelineOptions
    from crisperwhisper_tpu.hub import load_pipeline as jax_load
    from crisperwhisper_tpu_torch.hub import load_pipeline
    ckpt = write_tiny_checkpoint(str(tmp_path / "ckpt"))
    po = PipelineOptions(chunk_length_s=5, batch_size=16,
                         return_timestamps="word")
    jp = jax_load(ckpt, dtype=jnp.float32, pipe_opts=po)
    tp = load_pipeline(ckpt, dtype=torch.float32, device="cpu", pipe_opts=po)
    change = dict(temperatures=(0.0,), condition_on_prev_tokens=True)
    jp.gen_opts = replace(jp.gen_opts, staged_ring_quantum=0, **change)
    tp.gen_opts = replace(tp.gen_opts, **change)
    audio = {"raw": tone_audio(12.0, 6), "sampling_rate": SR}
    ref = jp(dict(audio), return_timestamps="word", prompt="hello world")
    got = tp(dict(audio), return_timestamps="word", prompt="hello world")
    assert got["text"] == ref["text"]
    assert [c["text"] for c in got["chunks"]] == \
        [c["text"] for c in ref["chunks"]]
    for g, r in zip(got["chunks"], ref["chunks"]):
        np.testing.assert_allclose(g["timestamp"], r["timestamp"],
                                   atol=TS_BAND)
    assert tp.tokenizer.get_prompt_ids("hello world").tolist() == \
        jp.tokenizer.get_prompt_ids("hello world").tolist()
