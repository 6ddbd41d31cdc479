"""PyTorch port: beam search (decoding/beam.py), the decoder step's beam
grouping, key mask and position offset (models/whisper.py), and the
whole-step kernel's beams mode (ops/decode_step.py) against the JAX
package on the TINY model at f32.

Bands: decoder logits within 2e-4 and alignment rows within 2e-5
(tests/test_model.py); beam scores within 1e-5; the beams mode's plain
version against the JAX kernel in interpret mode within 1e-5 of the
largest logit, ring columns at most one int8 step apart."""

from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from helpers import TINY_SPECIALS, rand_mel, tiny_arch
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)
from torch_port_fixtures import (cache_from_jax, port_config,
                                 quantized_tiny, tiny_state_dict)

HEADS = ((0, 1), (1, 3), (0, 2))
MAX_NEW = 24
EOT = TINY_SPECIALS.eot


def _eot_biased(jp, arch, alpha):
    """JAX params whose eot logit rises by ``alpha``: the TINY model's eot
    embedding row is zero (HF's padding row), so give it a random row and
    push the final LayerNorm's shift along it. alpha 0.6 ends the beams
    after 8-9 tokens."""
    dec = dict(jp["decoder"])
    e = (np.random.default_rng(5).standard_normal(arch.d_model)
         * 0.05).astype(np.float32)
    emb = np.array(dec["tok_emb"])
    emb[EOT] = e
    dec["tok_emb"] = emb
    dec["ln"] = {**dec["ln"],
                 "bias": np.asarray(dec["ln"]["bias"]) + alpha * e / (e @ e)}
    return {**jp, "decoder": dec}


@pytest.fixture(scope="module")
def tiny():
    """TINY f32 weights in both packages, plain and with eot pushed up."""
    from crisperwhisper_tpu.models import params_from_state_dict
    from crisperwhisper_tpu_torch.models.loader import params_from_jax
    arch = tiny_arch()
    jp = jax.device_get(params_from_state_dict(tiny_state_dict(), arch,
                                               dtype=jnp.float32))
    je = _eot_biased(jp, arch, 0.6)
    return {"arch": arch, "plain": (jp, params_from_jax(jp, arch)),
            "eos": (je, params_from_jax(je, arch))}


def _encode(arch, pair, mel):
    from crisperwhisper_tpu.models import encode as jencode
    from crisperwhisper_tpu_torch.models.whisper import encode
    jp, tp = pair
    return (jencode(jp, arch, jnp.asarray(mel)),
            encode(tp, arch, torch.from_numpy(mel)))


def test_decode_step_beam_groups_matches_jax(tiny):
    """init_cache(self_batch=6) over 2 items and decode_step(beam_groups=3)
    chained over four steps with beam reorders between them: one cross
    cache per item, one ring per beam, logits within 2e-4, alignment rows
    within 2e-5."""
    from crisperwhisper_tpu.models import (alignment_selector, decode_step
                                           as jstep, init_cache as jcache)
    from crisperwhisper_tpu_torch.models.whisper import (decode_step,
                                                         init_cache)
    arch = tiny["arch"]
    jp, tp = tiny["plain"]
    jenc, tenc = _encode(arch, tiny["plain"], rand_mel(batch=2, seed=3))
    jc = jcache(jp, arch, jenc, cache_len=8, self_batch=6)
    tc = init_cache(tp, arch, tenc, cache_len=8, self_batch=6)
    assert tuple(tc.self_k.shape) == (2, 6, 4, 8, 16)
    assert tuple(tc.cross_k.shape) == (2, 2, 4, 250, 16)
    sel = alignment_selector(arch, HEADS)
    rng = np.random.default_rng(0)
    toks = np.array([TINY_SPECIALS.sot] * 6, np.int32)
    for t in range(4):
        jl, jc, ja = jstep(jp, arch, jnp.asarray(toks), jnp.int32(t), jc,
                           align_sel=jnp.asarray(sel), beam_groups=3)
        tl, tc, ta = decode_step(tp, arch, torch.from_numpy(toks).long(), t,
                                 tc, align_sel=sel, beam_groups=3)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-5,
                                   rtol=1e-4)
        src = rng.integers(0, 3, 6) + np.repeat([0, 3], 3)
        jc = jc._replace(self_k=jc.self_k[:, src], self_v=jc.self_v[:, src])
        tc = replace(tc, self_k=tc.self_k[:, src], self_v=tc.self_v[:, src])
        toks = np.asarray(jl).argmax(-1).astype(np.int32)[src]


@pytest.mark.parametrize("step", ["decode_step", "decode_step_multi"])
def test_key_mask_and_pos_offset_match_jax(tiny, step):
    """A left-padded prompt (2 pads in row 0, none in row 1) prefilled
    with its key mask and pad-count offsets, then three one-token steps
    (``decode_step``) or a three-token block (``decode_step_multi``) with
    the same mask and offsets: the logits of every real query within 2e-4,
    alignment rows within 2e-5."""
    from crisperwhisper_tpu.models import (alignment_selector,
                                           decode_step as jstep,
                                           decode_step_multi as jmulti,
                                           init_cache as jcache)
    from crisperwhisper_tpu_torch.models.whisper import (decode_step,
                                                         decode_step_multi,
                                                         init_cache)
    arch = tiny["arch"]
    jp, tp = tiny["plain"]
    jenc, tenc = _encode(arch, tiny["plain"], rand_mel(batch=2, seed=4))
    ids = np.array([[EOT, EOT, TINY_SPECIALS.sot_prev, 11, 22,
                     TINY_SPECIALS.sot, 33, 44, 55],
                    [TINY_SPECIALS.sot_prev, 66, 77, 88, 99,
                     TINY_SPECIALS.sot, 111, 122, 133]], np.int32)
    mask = np.ones((2, 12), bool)
    mask[0, :2] = False
    offset = np.array([2, 0], np.int32)
    sel = alignment_selector(arch, HEADS)
    jc = jcache(jp, arch, jenc, cache_len=12)
    tc = init_cache(tp, arch, tenc, cache_len=12)
    jkw = dict(key_mask=jnp.asarray(mask), pos_offset=jnp.asarray(offset),
               align_sel=jnp.asarray(sel))
    tkw = dict(key_mask=torch.from_numpy(mask),
               pos_offset=torch.from_numpy(offset), align_sel=sel)
    jl, jc, _ = jmulti(jp, arch, jnp.asarray(ids[:, :6]), jnp.int32(0), jc,
                       **jkw)
    tl, tc, _ = decode_step_multi(tp, arch, torch.from_numpy(ids[:, :6]), 0,
                                  tc, **tkw)
    real = mask[:, :6]                 # pad queries attend to nothing
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                               atol=2e-4, rtol=1e-4)
    if step == "decode_step":
        for t in range(6, 9):
            jl, jc, ja = jstep(jp, arch, jnp.asarray(ids[:, t]),
                               jnp.int32(t), jc, **jkw)
            tl, tc, ta = decode_step(tp, arch, torch.from_numpy(ids[:, t]),
                                     t, tc, **tkw)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=2e-4, rtol=1e-4)
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja),
                                       atol=2e-5, rtol=1e-4)
    else:
        jl, jc, ja = jmulti(jp, arch, jnp.asarray(ids[:, 6:]), jnp.int32(6),
                            jc, **jkw)
        tl, tc, ta = decode_step_multi(tp, arch, torch.from_numpy(ids[:, 6:]),
                                       6, tc, **tkw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-5,
                                   rtol=1e-4)


def test_top_k_stable_matches_jax_top_k_on_ties():
    """Ties come out in index order, as jax.lax.top_k gives them."""
    from crisperwhisper_tpu_torch.decoding.beam import top_k_stable
    rng = np.random.default_rng(1)
    x = rng.integers(-3, 3, (4, 400)).astype(np.float32)
    x[1, 7:300] = -np.inf
    x[2, :] = -1e9
    jv, ji = jax.lax.top_k(jnp.asarray(x), 8)
    tv, ti = top_k_stable(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _ties_mask(vocab):
    """Suppress every token but eot and three text tokens: a beam has four
    finite candidates, so the top 2·NB take candidates of the beams that
    start at -1e9, which tie in f32 (-1e9 + logprob rounds to -1e9)."""
    mask = np.ones((vocab,), bool)
    mask[[EOT, 5, 17, 230]] = False
    return mask


@pytest.mark.parametrize("weights,nb,ts,quant,ties", [
    ("plain", 3, True, None, False),      # stops on length
    ("plain", 4, False, "int8", False),
    ("eos", 3, True, None, False),        # stops on EOS, pool evictions
    ("eos", 4, False, "int8", False),
    ("plain", 4, False, None, True)])     # tied top-k candidates
def test_beam_decode_matches_jax(tiny, weights, nb, ts, quant, ties):
    """beam_decode against beam_decode_jit on two items: sequences and
    token counts equal, sequences_scores within 1e-5, alignment rows
    within 2e-5, no-speech probabilities equal to f32 rounding."""
    from crisperwhisper_tpu.config import GenerationOptions
    from crisperwhisper_tpu.decoding.beam import beam_decode_jit
    from crisperwhisper_tpu.models import alignment_selector
    from crisperwhisper_tpu_torch.decoding.beam import beam_decode
    arch = tiny["arch"]
    jp, tp = tiny[weights]
    jenc, tenc = _encode(arch, tiny[weights], rand_mel(batch=2, seed=7))
    opts = GenerationOptions(max_initial_timestamp_index=50)
    prompt = np.array([[TINY_SPECIALS.sot, TINY_SPECIALS.transcribe]
                       + ([] if ts else [TINY_SPECIALS.no_timestamps])] * 2,
                      np.int32)
    sel = alignment_selector(arch, HEADS)
    supp = _ties_mask(arch.vocab_size) if ties else None
    ref = jax.device_get(beam_decode_jit(
        jp, arch, TINY_SPECIALS, opts, jenc, jnp.asarray(prompt), MAX_NEW,
        nb, align_sel=jnp.asarray(sel), return_timestamps=ts,
        suppress_mask=None if supp is None else jnp.asarray(supp),
        cross_cache_dtype=jnp.int8 if quant else None,
        self_cache_dtype=jnp.int8 if quant else None))
    got = beam_decode(
        tp, arch, port_config(TINY_SPECIALS), port_config(opts), tenc,
        torch.from_numpy(prompt), max_new_tokens=MAX_NEW, num_beams=nb,
        align_sel=sel, return_timestamps=ts,
        suppress_mask=None if supp is None else torch.from_numpy(supp),
        cross_cache_dtype=quant, self_cache_dtype=quant)
    np.testing.assert_array_equal(got.sequences.numpy(), ref.sequences)
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  ref.num_generated)
    stopped_on_eos = weights == "eos"
    assert ((got.num_generated.numpy() < MAX_NEW).all() == stopped_on_eos)
    np.testing.assert_allclose(got.sequences_scores.numpy(),
                               ref.sequences_scores, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.align_probs.numpy(), ref.align_probs,
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got.no_speech_probs.numpy(),
                               ref.no_speech_probs, atol=1e-6, rtol=1e-4)


# ---------------------------------------------------------------------------
# The whole-step kernel's beams mode
# ---------------------------------------------------------------------------


def _beam_caches(arch, jq, nb, cross=jnp.int8, items=1, ring=32):
    """Equal JAX and port beam caches: ``items`` cross caches, nb rings."""
    from crisperwhisper_tpu.models import encode, init_cache
    enc = encode(jq, arch, jnp.asarray(rand_mel(items, 11)))
    jc = init_cache(jq, arch, enc, cross_dtype=cross, cache_len=ring,
                    self_dtype=jnp.int8, self_batch=nb)
    return jc, cache_from_jax(jc)


def test_beams_plain_matches_jax_kernel():
    """decode_step_b1_beams at NB = 3 (int4 cross cache of batch 1) on the
    JAX kernel in interpret mode and on the port's plain version, chained
    over five steps with beam reorders of rings and scales between them:
    every row's argmax equal, logits within 1e-5 of the largest, alignment
    rows within 1e-5, fresh ring columns at most one int8 step apart and
    the older slots equal."""
    from crisperwhisper_tpu.models import alignment_selector
    from crisperwhisper_tpu.ops import pallas_decode_b1 as J
    from crisperwhisper_tpu_torch.ops import decode_step as T
    nb = 3
    arch, jq, _, tq = quantized_tiny()
    jc, pc = _beam_caches(arch, jq, nb, jnp.int4)
    sel = alignment_selector(arch, ((0, 1), (1, 2)))
    rng = np.random.default_rng(0)
    toks = np.asarray([5, 9, 13], np.int32)
    for i in range(5):
        la, jc, aa = J.decode_step_b1_beams(jq, arch, jnp.asarray(toks),
                                            jnp.int32(i), jc,
                                            align_sel=jnp.asarray(sel),
                                            interpret=True)
        lb, pc, ab = T.decode_step_b1_beams(tq, arch, torch.from_numpy(toks),
                                            i, pc, align_sel=sel)
        la, lb = np.asarray(la), lb.numpy()
        assert la.shape == lb.shape == (nb, arch.vocab_size)
        assert (la.argmax(-1) == lb.argmax(-1)).all(), i
        np.testing.assert_allclose(lb, la, atol=1e-5 * np.abs(la).max())
        np.testing.assert_allclose(ab.numpy(), np.asarray(aa), atol=1e-5)
        ref = cache_from_jax(jc)
        for name in ("self_k", "self_v"):
            a, b = getattr(pc, name).int(), getattr(ref, name).int()
            assert (a[:, :, :, i] - b[:, :, :, i]).abs().max() <= 1
            assert torch.equal(a[:, :, :, :i], b[:, :, :, :i])
        src = rng.integers(0, nb, nb)
        jc = jc._replace(self_k=jc.self_k[:, src], self_v=jc.self_v[:, src],
                         self_k_scale=jc.self_k_scale[:, src],
                         self_v_scale=jc.self_v_scale[:, src])
        pc = cache_from_jax(jc)     # each step starts from equal rings
        toks = la.argmax(-1).astype(np.int32)[src]
    assert T.whole_step.mode_launches["beams"] == 0    # CPU: the plain one


def test_beams_plain_equals_rows_with_repeated_cross_cache():
    """The beams mode is the rows mode with a shared cross cache: on the
    cross cache repeated per row, the rows mode gives the same hid,
    alignment rows and rings, bit for bit."""
    from crisperwhisper_tpu_torch import testing
    from crisperwhisper_tpu_torch.ops import decode_step as T
    arch, _, _, tq = quantized_tiny()
    pc = testing.random_step_cache(arch, 4, "int4", 32, 9,
                                   torch.Generator().manual_seed(2),
                                   shared_cross=True)
    x0 = torch.randn((4, arch.d_model),
                     generator=torch.Generator().manual_seed(3))
    heads = ((0, 1), (1, 3))
    a, b = testing.clone_cache(pc), testing.repeat_cross(pc, 4)
    hb, ab = T.whole_step(tq, arch, x0, 9, a, heads, beams=True)
    hr, ar = T.whole_step(tq, arch, x0, 9, b, heads)
    assert torch.equal(hb, hr) and torch.equal(ab, ar)
    for name in ("self_k", "self_v", "self_k_scale", "self_v_scale"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert testing.tie_column_error(tq, arch, x0, 9, pc, beams=True) == 0


def test_beams_gate_matches_reference():
    """supported_beams against the reference's gate on its cases
    (tests/test_b1_kernel.py:352-382), plus the kernel's shape limits."""
    from crisperwhisper_tpu.models import encode, init_cache
    from crisperwhisper_tpu.ops import pallas_decode_b1 as J
    from crisperwhisper_tpu_torch.ops import decode_step as T
    nb = 3
    arch, jq, _, tq = quantized_tiny()
    jc, pc = _beam_caches(arch, jq, nb)
    enc = encode(jq, arch, jnp.asarray(rand_mel(1, 11)))
    jbf = init_cache(jq, arch, enc, cache_len=32, self_batch=nb)
    jtwo = _beam_caches(arch, jq, nb, items=2)[0]
    cases = {"ok": {}, "one row": dict(tokens=1), "9 rows": dict(tokens=9),
             "rings != R": dict(tokens=2),
             "vector position": dict(position="vector"),
             "key mask": dict(key_mask=True), "bf16 rings": dict(cache=jbf),
             "two items": dict(cache=jtwo)}
    for name, c in cases.items():
        n = c.get("tokens", nb)
        jcache = c.get("cache", jc)
        pcache = pc if jcache is jc else cache_from_jax(jcache)
        vec = c.get("position") == "vector"
        mask = c.get("key_mask", False)
        ref = J.supported_beams(
            jq, arch, jcache, jnp.ones((nb, 32), bool) if mask else None,
            jnp.zeros((nb,), jnp.int32) if vec else jnp.int32(0),
            jnp.zeros((n,), jnp.int32))
        got = T.supported_beams(
            tq, arch, pcache,
            torch.ones((nb, 32), dtype=torch.bool) if mask else None,
            torch.zeros((nb,), dtype=torch.int32) if vec else 0,
            torch.zeros((n,), dtype=torch.long))
        assert bool(got) == bool(ref) == (name == "ok"), name
    wide = replace(arch, d_model=512, decoder_attention_heads=4)  # Dh 128
    assert not T.supported_beams(tq, wide, pc, None, 0,
                                 torch.zeros((nb,)))


def test_beam_decode_with_beams_kernel_flag(monkeypatch):
    """beam_decode with b1_decode_kernel at batch 1 and an int8 ring takes
    the beams mode every step, with token agreement >= 0.9 against the
    same search without the flag (tests/test_b1_kernel.py:310-349); with a
    float ring the gate fails and the flag changes nothing, bit for
    bit."""
    from crisperwhisper_tpu.config import GenerationOptions
    from crisperwhisper_tpu.models import alignment_selector
    from crisperwhisper_tpu_torch.decoding.beam import beam_decode
    from crisperwhisper_tpu_torch.models.whisper import encode
    from crisperwhisper_tpu_torch.ops import decode_step as T
    arch, _, _, tq = quantized_tiny()
    calls = []
    real = T.decode_step_b1_beams
    monkeypatch.setattr(T, "decode_step_b1_beams",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    enc = encode(tq, arch, torch.from_numpy(rand_mel(batch=1, seed=7)))
    prompt = torch.tensor([[TINY_SPECIALS.sot, TINY_SPECIALS.no_timestamps]])
    base = port_config(GenerationOptions(max_initial_timestamp_index=50))
    kw = dict(max_new_tokens=16, num_beams=4,
              align_sel=alignment_selector(arch, ((0, 1), (1, 2))),
              return_timestamps=False)
    spec = port_config(TINY_SPECIALS)
    on = replace(base, b1_decode_kernel=True)
    q = dict(cross_cache_dtype="int8", self_cache_dtype="int8")
    ref = beam_decode(tq, arch, spec, base, enc, prompt, **kw, **q)
    assert not calls
    got = beam_decode(tq, arch, spec, on, enc, prompt, **kw, **q)
    assert calls
    r, g = ref.sequences[0].numpy(), got.sequences[0].numpy()
    n = min(int(ref.num_generated[0]), int(got.num_generated[0]))
    assert float((r[:n] == g[:n]).mean()) >= 0.9
    np.testing.assert_allclose(got.sequences_scores.numpy(),
                               ref.sequences_scores.numpy(), atol=0.1)
    calls.clear()
    ref = beam_decode(tq, arch, spec, base, enc, prompt, **kw)
    got = beam_decode(tq, arch, spec, on, enc, prompt, **kw)
    assert not calls
    assert torch.equal(got.sequences, ref.sequences)
    assert torch.equal(got.align_probs, ref.align_probs)
