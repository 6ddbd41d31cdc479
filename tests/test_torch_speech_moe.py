"""Uni-MoE-2.0-Omni's speech-to-text path in the port
(models/speech_moe.py, ops/moe.py) against the plain reference
(tests/plain_speech_moe.py) at a tiny geometry on the CPU: hidden 64, 2
layers, 4 query over 2 key heads, 4 routed experts 96 wide and a null
one, 2 shared experts 32 wide, vocabulary 512, a 2-layer Whisper tower
of width 32; seeded f32 weights."""

from __future__ import annotations

import json
import math
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import plain_speech_moe as plain
from torch_port_fixtures import one_torch_thread  # noqa: F401

from crisperwhisper_tpu_torch.config import PipelineOptions
from crisperwhisper_tpu_torch.models.speech_moe import SpeechMoEArch
from crisperwhisper_tpu_torch.models.whisper import sinusoids
from crisperwhisper_tpu_torch.models import speech_moe
from crisperwhisper_tpu_torch.ops import moe

TINY = {"model_type": "grin_qwen2_vl", "hidden_size": 64,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "rope_theta": 1000000, "rms_norm_eps": 1e-6,
        "vocab_size": 512, "mlp_dynamic_expert_num": 4,
        "mlp_dynamic_null_expert_num": 1, "dynamic_intermediate_size": 96,
        "mlp_dynamic_top_p": 0.7, "mlp_dynamic_top_k": 2,
        "mlp_fixed_expert_num": 2, "shared_intermediate_size": 32,
        "max_position_embeddings": 4096, "whisper_hidden_size": 32,
        "whisper_query_tokens_size": 20,
        "audio_config": {"num_mel_bins": 80, "encoder_layers": 2,
                         "encoder_attention_heads": 2,
                         "encoder_ffn_dim": 64}}
# Qwen2's specials, at the top of the tiny vocabulary
SPECIALS = {"<|endoftext|>": 500, "<|im_start|>": 501, "<|im_end|>": 502,
            "<|AUDIO|>": 503, "<|audio_start|>": 504, "<|audio_end|>": 505}
GATE_STD = 2.0       # router logits of about this size: every routing case
# f32 on both sides: the port's products differ from the reference's only
# in summation order (grouped expert rows, cached keys, pooled frames),
# which moved logits of size up to 4 by 3.5e-6; 1e-4 leaves room for that,
# and each planted routing fault moved them by 0.49 or more
TOL = 1e-4


def _arch() -> SpeechMoEArch:
    return SpeechMoEArch.from_hf_config(TINY)


def make_params(arch: SpeechMoEArch, seed: int) -> dict:
    """Seeded f32 weights in the port's layout: dense N(0, 1 / fan_in),
    the router GATE_STD times that, embeddings N(0, 0.02), norms and
    biases drawn around 1 and 0."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, std=None):
        std = 1.0 / math.sqrt(math.prod(shape[1:])) if std is None else std
        return torch.randn(shape, generator=g) * std

    def norm(d, bias=True):
        p = {"scale": 1.0 + n(d, std=0.02)}
        if bias:
            p["bias"] = n(d, std=0.02)
        return p

    au = arch.audio
    da, d = au.d_model, arch.hidden_size

    def lin(d_in, d_out, bias=True):
        p = {"w": n(d_out, d_in)}
        if bias:
            p["b"] = n(d_out, std=0.02)
        return p

    enc = {"conv1": {"w": n(da, au.num_mel_bins, 3), "b": n(da, std=0.02)},
           "conv2": {"w": n(da, da, 3), "b": n(da, std=0.02)},
           "pos": torch.from_numpy(sinusoids(1500, da)),
           "layers": [{"ln1": norm(da), "ln2": norm(da),
                       "attn": {"q": lin(da, da), "k": lin(da, da, False),
                                "v": lin(da, da), "o": lin(da, da)},
                       "mlp": {"fc1": lin(da, au.encoder_ffn_dim),
                               "fc2": lin(au.encoder_ffn_dim, da)}}
                      for _ in range(au.encoder_layers)],
           "ln_post": norm(da)}
    kv = arch.num_key_value_heads * arch.head_dim
    e, f = arch.num_experts, arch.expert_dim
    s = arch.shared_experts * arch.shared_dim
    layers = [{"ln1": norm(d, False), "ln2": norm(d, False),
               "attn": {"q": lin(d, d), "k": lin(d, kv), "v": lin(d, kv),
                        "o": lin(d, d, False)},
               "router": {"w": n(e + arch.null_experts, d,
                                 std=GATE_STD / math.sqrt(d))},
               "shared": {"gate": lin(d, s, False), "up": lin(d, s, False),
                          "down": lin(s, d, False)},
               "experts": {"gate": n(e, f, d, std=d ** -0.5),
                           "up": n(e, f, d, std=d ** -0.5),
                           "down": n(e, d, f, std=f ** -0.5)}}
              for _ in range(arch.num_hidden_layers)]
    return {"encoder": enc, "adapter": lin(da, d),
            "decoder": {"tok_emb": n(arch.vocab_size, d, std=0.02),
                        "layers": layers, "norm": norm(d, False),
                        "head": lin(d, arch.vocab_size, False)}}


def _ref_cfg(arch: SpeechMoEArch) -> dict:
    return {"heads": arch.num_attention_heads,
            "kv_heads": arch.num_key_value_heads,
            "audio_heads": arch.audio.encoder_attention_heads,
            "audio_tokens": arch.audio_tokens, "rope_theta": arch.rope_theta,
            "eps": arch.rms_norm_eps, "num_experts": arch.num_experts,
            "top_p": arch.top_p, "top_k": arch.top_k}


@pytest.fixture(scope="module")
def tiny():
    """(arch, params, features [2, 80, 3000], ids [2, 40], audio start,
    the reference's logits [2, 40, 512])."""
    arch = _arch()
    params = make_params(arch, 0)
    g = torch.Generator().manual_seed(1)
    feats = torch.randn((2, 80, 3000), generator=g)
    start = 5
    ids = torch.randint(0, 500, (2, 40), generator=g)
    ids[:, start:start + arch.audio_tokens] = SPECIALS["<|AUDIO|>"]
    ref = plain.forward(params, _ref_cfg(arch), feats, ids, start)
    return arch, params, feats, ids, start, ref


def _prefill_then_decode(arch, params, feats, ids, start, n_prefill=30):
    """Logits of positions n_prefill-1.. (one-token steps) after a
    prefill of the first n_prefill - 1 positions."""
    audio = speech_moe.encode(params, arch, feats)
    cache = speech_moe.init_cache(arch, ids.shape[0], ids.shape[1],
                                  torch.float32, "cpu")
    speech_moe.prefill(params, arch, ids[:, :n_prefill - 1], audio, start,
                       cache)
    return torch.stack([speech_moe.decode_step(params, arch, ids[:, t], t,
                                               cache)
                        for t in range(n_prefill - 1, ids.shape[1])], 1)


def test_prefill_then_decode_matches_the_reference(tiny):
    arch, params, feats, ids, start, ref = tiny
    got = _prefill_then_decode(arch, params, feats, ids, start)
    err = (got - ref[:, 29:]).abs().max().item()
    assert err <= TOL, err
    full = speech_moe.forward(params, arch, feats, ids, start)
    assert (full - ref).abs().max().item() <= TOL
    # the sample exercises every routing case: one and two entries kept,
    # the null expert kept
    y = torch.randn((256, 64), generator=torch.Generator().manual_seed(2))
    r = moe.route(speech_moe.rms_norm(y, params["decoder"]["layers"][0]["ln2"],
                                      1e-6),
                  params["decoder"]["layers"][0]["router"]["w"], 4, 0.7, 2)
    n_kept = r.kept.sum(-1)
    assert (n_kept == 1).any() and (n_kept == 2).any() and r.kept[:, 4].any()


# gate logits [T, 5] whose routing is known: (logits, kept entries)
ROUTES = [
    ([3.0, 0, 0, 0, 0], [0]),                        # top-1 0.83 >= 0.7
    ([math.log(4 * 0.7 / 0.3) + 1e-3, 0, 0, 0, 0], [0]),   # just above 0.7
    ([math.log(4 * 0.7 / 0.3) - 1e-3, 0, 0, 0, 0], [0, 1]),  # just below
    ([0, 0, 0, 0, 3.0], [4]),                        # the null expert alone
    ([2.0, 0, 0, 0, 1.9], [0, 4]),                   # the null expert second
    ([0.5, 0, 0, 0, 2.0], [4, 0]),                   # the null expert first
    ([1.0, 1.0, 1.0, 0, 0], [0, 1]),                 # a tie: lower index
    ([1.0, 0.9, 0.8, 0.7, 0.6], [0, 1]),             # capped at 2
]


@pytest.mark.parametrize("logits,want", ROUTES)
def test_routing_matches_the_reference(logits, want):
    y = torch.tensor([logits], dtype=torch.float32)
    r = moe.route(y, torch.eye(5), 4, 0.7, 2)
    p = torch.softmax(y, -1)[0]
    assert plain.kept_entries(p, 0.7, 2) == want
    assert sorted(torch.nonzero(r.kept[0])[:, 0].tolist()) == sorted(want)
    routed = [e for e in want if e < 4]
    got = [(int(e), float(w)) for e, w in zip(r.expert[0], r.weight[0])
           if e < 4]
    assert got == [(e, float(p[e])) for e in routed]


def test_grouped_experts_match_the_per_expert_loop():
    """The grouped path (pairs in expert order) gives the per-expert
    loop over masks, and its input holds the kept routed pairs only: no
    null-expert row and no entry that was not kept."""
    arch = _arch()
    lp = make_params(arch, 3)["decoder"]["layers"][1]
    y = torch.randn((64, 64), generator=torch.Generator().manual_seed(4))
    r = moe.route(y, lp["router"]["w"], 4, 0.7, 2)
    token, weight, offsets = moe.expert_pairs(r, 4)
    assert offsets[-1] == int(r.kept[:, :4].sum())
    for e in range(4):
        rows = token[offsets[e]:offsets[e + 1]].tolist()
        assert rows == torch.nonzero(r.kept[:, e])[:, 0].tolist()
        assert torch.equal(weight[offsets[e]:offsets[e + 1]],
                           r.probs[rows, e])
    assert r.kept[:, 4].any() and (r.kept.sum(-1) == 1).any()
    ex = lp["experts"]
    want = torch.zeros((64, 64))
    for e in range(4):
        out = plain.swiglu(y, ex["gate"][e], ex["up"][e], ex["down"][e])
        want += torch.where(r.kept[:, e:e + 1], r.probs[:, e:e + 1] * out, 0.0)
    got = moe.routed_experts(y, r, ex, 4)
    assert (got - want).abs().max().item() <= 1e-5


def _always_two(real):
    def route(y, w, e, top_p, top_k, **kw):
        return real(y, w, e, 1.5, top_k, **kw)
    return route


def _renormalised(real):
    def route(y, w, e, top_p, top_k, **kw):
        r = real(y, w, e, top_p, top_k, **kw)
        kept = torch.where(r.kept, r.probs, 0.0).sum(-1, keepdim=True)
        return moe.Routing(r.probs, r.kept, r.expert, r.weight / kept)
    return route


def _null_dropped(real):
    def route(y, w, e, top_p, top_k, kept_out=None):
        return real(y, w[:e], e, top_p, top_k)
    return route


@pytest.mark.parametrize("fault", [_always_two, _renormalised, _null_dropped])
def test_routing_faults_fail_the_tolerance(tiny, monkeypatch, fault):
    arch, params, feats, ids, start, ref = tiny
    monkeypatch.setattr(moe, "route", fault(moe.route))
    got = _prefill_then_decode(arch, params, feats, ids, start)
    assert (got - ref[:, 29:]).abs().max().item() > 100 * TOL


def test_the_routing_record_holds_every_kept_entry(tiny, monkeypatch):
    """Recording, the cache holds the kept mask of each MLP call (the
    prefill's per layer, then each step's), written by the routing
    itself, and counts them as the cw.decode record reports them."""
    arch, params, feats, ids, start, _ = tiny
    seen = []

    def spy(real):
        def route(*args, **kw):
            r = real(*args, **kw)
            seen.append(r.kept.clone())
            return r
        return route

    monkeypatch.setattr(moe, "route", spy(moe.route))
    audio = speech_moe.encode(params, arch, feats)
    cache = speech_moe.init_cache(arch, 2, ids.shape[1], torch.float32, "cpu",
                                  recording=True)
    speech_moe.prefill(params, arch, ids[:, :29], audio, start, cache)
    for t in range(29, 33):
        speech_moe.decode_step(params, arch, ids[:, t], t, cache)
    rec, n_layers = cache.routing, arch.num_hidden_layers
    assert rec.first_step == 29 and rec.steps.shape[0] == ids.shape[1] - 29
    prefill = torch.stack(seen[:n_layers])
    steps = torch.stack(seen[n_layers:]).view(4, n_layers, 2, 5)
    assert torch.equal(rec.prefill, prefill)
    assert torch.equal(rec.steps[:4], steps) and not rec.steps[4:].any()
    e = arch.num_experts
    for got, kept, axes in zip(rec.counts(e), (prefill, steps),
                               ((1,), (0, 2))):
        n_kept = kept.sum(-1)
        want = torch.cat([kept.sum(axes), (n_kept == 1).sum(axes)[:, None],
                          (n_kept == 2).sum(axes)[:, None],
                          kept[..., :e].any(axes[-1]).long().sum(
                              axes[0]) if len(axes) == 2
                          else kept[..., :e].any(1).long()], 1)
        assert torch.equal(got, want)
    assert int(rec.counts(e)[1][:, e + 1:e + 3].sum()) == 4 * 2 * n_layers


def _write_checkpoint(path: str) -> str:
    """A weightless tiny checkpoint: config, tokenizer files with Qwen2's
    specials (byte symbols, then space-led words), preprocessor."""
    from crisperwhisper_tpu_torch.tokenizer.bpe import bytes_to_unicode
    os.makedirs(path, exist_ok=True)
    vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    for i in range(len(vocab), 500):
        vocab[f"Ġw{i}"] = i
    files = {"config.json": TINY, "vocab.json": vocab,
             "added_tokens.json": SPECIALS, "generation_config.json": {},
             "preprocessor_config.json": {
                 "feature_size": 80, "sampling_rate": 16000, "n_fft": 400,
                 "hop_length": 160, "chunk_length": 30}}
    for name, obj in files.items():
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            json.dump(obj, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return path


def test_load_pipeline_serves_text(tmp_path):
    """load_pipeline on a weightless checkpoint with params=: a 70 s
    recording (3 windows) at batch 4 comes back as text, every window
    decoding the prompt of speech_moe.speech_tokens."""
    from crisperwhisper_tpu_torch.hub import load_pipeline
    from crisperwhisper_tpu_torch.pipeline import asr
    arch = _arch()
    pipe = load_pipeline(_write_checkpoint(str(tmp_path / "ckpt")),
                         device="cpu", dtype=torch.float32,
                         params=make_params(arch, 5),
                         pipe_opts=PipelineOptions(batch_size=4))
    pipe.gen_opts = replace(
        pipe.gen_opts, max_new_tokens=8, temperatures=(0.0,),
        compression_ratio_threshold=None, logprob_threshold=None,
        no_speech_threshold=None, force_unique_generate_call=True,
        suppress_tokens=tuple(range(500, 512)))
    tokens = pipe.specials
    assert tokens.prompt[0] == SPECIALS["<|im_start|>"]
    assert tokens.prompt.count(SPECIALS["<|AUDIO|>"]) == 20
    rows = []
    real = asr.generate

    def generate(*args, **kwargs):
        out = real(*args, **kwargs)
        rows.extend(out.segments)
        return out

    asr.generate = generate
    try:
        audio = np.random.default_rng(6).standard_normal(70 * 16000)
        res = pipe([{"raw": audio.astype(np.float32) * 0.1,
                     "sampling_rate": 16000}], return_timestamps=False)
    finally:
        asr.generate = real
    assert isinstance(res[0]["text"], str) and res[0]["text"]
    assert len(rows) == 4                     # 3 windows and one pad row
    assert all(len(np.concatenate([s["tokens"] for s in segs])) == 8
               for segs in rows[:3])
    with pytest.raises(ValueError):
        pipe([{"raw": audio[:16000].astype(np.float32),
               "sampling_rate": 16000}], return_timestamps="word")


def test_the_two_references_agree(tiny):
    """tests/plain_speech_moe.py and the benchmark's copy
    (portbench/reference/speech_moe.py, one layer upcast at a time)."""
    from portbench.reference import speech_moe as bench
    arch, params, feats, ids, start, ref = tiny
    got = bench.Reference(params, arch, "f32").logits(feats, ids, start)
    assert (got - ref).abs().max().item() <= TOL
