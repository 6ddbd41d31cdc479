"""Uni-MoE-2.0-Omni's speech-to-text path: a Whisper-large audio tower
and adapter feeding a 28-layer decoder-only language model whose every
MLP is a dynamic top-p mixture of experts with a null expert.

The architecture file of every configuration whose published
``model_type`` is ``grin_qwen2_vl``. The shapes come from the port's
``models/speech_moe.SpeechMoEArch``; the weights are drawn here in the
port's layout following ``weights.py``'s principles; the
checkpoint is a weightless directory with Qwen2's special tokens over
the benchmark's byte-level vocabulary; the reference check is
``reference/speech_moe.py``, teacher-forced on the served tokens and on
the routes the program's prefill and steps take on them, with those
routing decisions held against the reference's gate; the work counts are
``work_speech_moe.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os

import numpy as np
import torch

from portbench import check, ckpt, harness
from portbench import weights as _weights
from portbench import work_speech_moe as work  # noqa: F401  (ctx.work)
from portbench.reference import model as _model
from portbench.reference import speech_moe as _reference

# Qwen2's specials and Qwen2.5-Omni's audio tokens (assumed)
EOT, IM_START, IM_END = 151643, 151644, 151645
AUDIO, AUDIO_START, AUDIO_END = 151646, 151647, 151648
SPECIALS = {"<|endoftext|>": EOT, "<|im_start|>": IM_START,
            "<|im_end|>": IM_END, "<|AUDIO|>": AUDIO,
            "<|audio_start|>": AUDIO_START, "<|audio_end|>": AUDIO_END}
STD = 0.02
EMB_STD = 1.0       # the language model's token embeddings (see weights)
GATE_GAIN = 2.0     # router logits of about this size (configuration file)
AUDIO_TOKENS = 200  # whisper_query_tokens_size: the adapter's outputs
# the prompt's words as single tokens (byte-level symbols, "Ġ" a space),
# each merged left to right: every prefix of two symbols or more is a
# merge's result and a vocabulary entry, from id 256 on
PROMPT_WORDS = ("user", "Transcribe", "\u0120the", "\u0120audio",
                "\u0120verbatim", "assistant")
WORD_PIECES = tuple(w[:i] for w in PROMPT_WORDS for i in range(2, len(w) + 1))


def arch(cfg: dict):
    from crisperwhisper_tpu_torch.models.speech_moe import SpeechMoEArch
    return SpeechMoEArch.from_hf_config(cfg)


def weights(arch, seed: int, device, dtype) -> dict:
    """The tree from ``seed``: the Whisper encoder from ``weights.make``
    (its stack alone), then the adapter and language model from a second
    generator, leaf by leaf in the served type: dense N(0, 1 / fan_in)
    (queries and keys ``weights.QK_GAIN`` times that, as Whisper's), the
    router f32 at GATE_GAIN / sqrt(hidden), token embeddings N(0,
    EMB_STD), biases N(0, 0.02), RMSNorm weights f32 around 1. Token
    embeddings at Whisper's 0.02 vanish in the residual stream after the
    first layer, so a batch's rows decode few distinct tokens and route
    alike; at 1 (the size of the adapter's audio embeddings) each row's
    token stays in its stream and the rows spread over the experts."""
    audio = dataclasses.replace(arch.audio, decoder_layers=0, vocab_size=1,
                                max_target_positions=1)
    enc = _weights.make(audio, seed, device, dtype)["encoder"]
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)

    def draw(*shape, std, dt=dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dt).mul_(std)

    def lin(d_in, d_out, bias=True, gain=1.0):
        p = {"w": draw(d_out, d_in, std=gain / math.sqrt(d_in))}
        if bias:
            p["b"] = draw(d_out, std=STD)
        return p

    def norm(d):
        return {"scale": draw(d, std=STD, dt=torch.float32).add_(1.0)}

    d, f = arch.hidden_size, arch.expert_dim
    kv = arch.num_key_value_heads * arch.head_dim
    s = arch.shared_experts * arch.shared_dim
    e = arch.num_experts
    layers = []
    for _ in range(arch.num_hidden_layers):
        layers.append({
            "ln1": norm(d),
            "attn": {"q": lin(d, d, gain=_weights.QK_GAIN),
                     "k": lin(d, kv, gain=_weights.QK_GAIN), "v": lin(d, kv),
                     "o": lin(d, d, bias=False)},
            "ln2": norm(d),
            "router": {"w": draw(e + arch.null_experts, d,
                                 std=GATE_GAIN / math.sqrt(d),
                                 dt=torch.float32)},
            "shared": {"gate": lin(d, s, bias=False),
                       "up": lin(d, s, bias=False),
                       "down": lin(s, d, bias=False)},
            "experts": {"gate": draw(e, f, d, std=d ** -0.5),
                        "up": draw(e, f, d, std=d ** -0.5),
                        "down": draw(e, d, f, std=f ** -0.5)}})
    return {"encoder": enc, "adapter": lin(arch.audio.d_model, d),
            "decoder": {"tok_emb": draw(arch.vocab_size, d, std=EMB_STD),
                        "layers": layers, "norm": norm(d),
                        "head": lin(d, arch.vocab_size, bias=False)}}


def _write_json(path: str, obj) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False)


@functools.cache
def _vocabulary() -> tuple[str, ...]:
    """The text ids' symbols (< <|endoftext|>): the 256 byte symbols,
    WORD_PIECES, then " w<base36 id>" words."""
    words = list(ckpt.bytes_to_unicode().values()) + list(WORD_PIECES)
    return tuple(words + [f"\u0120w{ckpt._base36(i)}"
                          for i in range(len(words), EOT)])


def checkpoint(path: str, cfg: dict) -> str:
    """The weightless checkpoint directory: config, the byte-level
    vocabulary (``_vocabulary``) with the merges that join the prompt's
    words, Qwen2's specials as added tokens, the feature extractor's
    settings."""
    os.makedirs(path, exist_ok=True)
    _write_json(os.path.join(path, "vocab.json"),
                {w: i for i, w in enumerate(_vocabulary())})
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for piece in WORD_PIECES:
            f.write(f"{piece[:-1]} {piece[-1]}\n")
    _write_json(os.path.join(path, "added_tokens.json"), SPECIALS)
    hf = {k: v for k, v in harness.hf_config(cfg).items() if k != "not_run"}
    _write_json(os.path.join(path, "config.json"), hf)
    _write_json(os.path.join(path, "generation_config.json"),
                {"eos_token_id": IM_END, "pad_token_id": EOT})
    _write_json(os.path.join(path, "preprocessor_config.json"), {
        "feature_size": arch(cfg).num_mel_bins, "sampling_rate": 16000,
        "n_fft": 400,
        "hop_length": 160, "chunk_length": 30})
    return path


def _ids(*words: str) -> list[int]:
    """The ids of byte-level symbols and word pieces."""
    index = {w: i for i, w in enumerate(_vocabulary()[:256 + len(
        WORD_PIECES)])}
    return [index[w] for w in words]


def prompt_ids(mix: dict) -> list[int]:
    """The window prompt: <|im_start|>user\\n<|audio_start|>, AUDIO_TOKENS
    audio positions, <|audio_end|>Transcribe the audio verbatim.<|im_end|>
    \\n<|im_start|>assistant\\n, each word one id (215 positions)."""
    nl = "\u010a"
    return ([IM_START] + _ids("user", nl) + [AUDIO_START]
            + [AUDIO] * AUDIO_TOKENS + [AUDIO_END]
            + _ids("Transcribe", "\u0120the", "\u0120audio",
                   "\u0120verbatim", ".") + [IM_END] + _ids(nl)
            + [IM_START] + _ids("assistant", nl))


def _program_routes(params: dict, arch, feats: torch.Tensor,
                    ids: torch.Tensor, start: int, p: int) -> torch.Tensor:
    """The program's own routing of the teacher-forced sequences ids [B,
    T] as it serves them: the port's encoder and adapter, its prefill of
    the first p - 1 positions, then its one-token steps fed the rest, all
    recording (models/speech_moe). The entries [L, B * T, E + N] each
    layer keeps at each position; the last position, which no used
    logit reads, keeps none."""
    from crisperwhisper_tpu_torch.models import speech_moe as port
    dtype = params["decoder"]["tok_emb"].dtype
    b, t = ids.shape
    audio = port.encode(params, arch, feats.to(dtype))
    cache = port.init_cache(arch, b, t, dtype, ids.device, recording=True)
    port.prefill(params, arch, ids[:, :p - 1], audio, start, cache)
    for pos in range(p - 1, t - 1):
        port.decode_step(params, arch, ids[:, pos], pos, cache)
    rec, n_layers = cache.routing, arch.num_hidden_layers
    width = rec.prefill.shape[-1]
    routes = torch.zeros((n_layers, b, t, width), dtype=torch.bool,
                         device=ids.device)
    routes[:, :, :p - 1] = rec.prefill.view(n_layers, b, p - 1, width)
    routes[:, :, p - 1:t - 1] = rec.steps[:t - p].permute(1, 2, 0, 3)
    return routes.view(n_layers, b * t, width)


def compare(params: dict, arch, cfg: dict, windows: list, audio: list,
            prompt: list[int], mix: dict, mode: str, device,
            control: str | None) -> dict:
    """The reference's readings over ``windows`` (``check.compare``'s,
    without token times), every path on the routes the program takes
    serving them (``_program_routes``): ``logit_gap`` (the best allowed logit less the
    served token's, at its widest), ``route_flip_share`` (the share of
    the routing decisions, a token's kept entries at a layer, that the
    program makes otherwise than the f32 reference's gate), ``tokens``,
    ``distinct_tokens``, ``median_margin``; with ``control`` (``fp8``),
    the control's ``logit_gap`` (of the tokens it puts first, on the
    reference's logits) and ``route_flip_share`` (its gate's decisions
    against the f32 reference's). All windows run through the reference
    together, one layer at a time."""
    allowed = mix.get("suppress_ids_from")
    start, p = prompt.index(AUDIO), len(prompt)
    wins = [w for w in windows if len(w.tokens)]
    out = {"logit_gap": 0.0, "route_flip_share": 0.0, "tokens": 0,
           "distinct_tokens": 0, "median_margin": 0.0}
    if control:
        out["control"] = {"logit_gap": 0.0, "route_flip_share": 0.0}
    if not wins:
        return out
    longest = max(len(w.tokens) for w in wins)
    ids = torch.tensor([prompt + [int(t) for t in w.tokens]
                        + [0] * (longest - len(w.tokens)) for w in wins],
                       device=device)
    # the decisions behind a used logit: positions before each window's
    # last served token
    used = (torch.arange(ids.shape[1], device=device)[None, :]
            < torch.tensor([p - 1 + len(w.tokens) for w in wins],
                           device=device)[:, None]).reshape(-1)

    def flip_share(a: torch.Tensor, b: torch.Tensor) -> float:
        return float((a != b).any(-1)[:, used].float().mean())

    with _model.no_tf32(), torch.no_grad():
        wave = torch.from_numpy(np.stack(
            [check._window_audio(audio, w) for w in wins])).to(device)
        feats = torch.cat([_model.log_mel(wave[i:i + 4], arch.num_mel_bins)
                           for i in range(0, len(wins), 4)])
        del wave
        routes = _program_routes(params, arch, feats, ids, start, p)
        ref = _reference.Reference(params, arch, "f32")
        hid = ref.hidden(feats, ids, start, routes)
        flips = flip_share(routes, ref.own)
        ctl = _reference.Reference(params, arch, control) if control else None
        ctl_hid = ctl.hidden(feats, ids, start, routes) if ctl else None
        gap = ctl_gap = 0.0
        margins, distinct, n_tok = [], set(), 0
        for j, w in enumerate(wins):
            n = len(w.tokens)
            logits = ref.head(hid[j, p - 1:p - 1 + n])
            if allowed is not None:
                logits[:, allowed:] = float("-inf")
            top2 = logits.topk(2, dim=-1).values
            best = top2[:, 0]
            margins.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
            tok = torch.as_tensor(np.asarray(w.tokens, np.int64),
                                  device=device)
            gap = max(gap, float((best - logits.gather(
                1, tok[:, None])[:, 0]).max()))
            distinct.update(int(t) for t in w.tokens)
            n_tok += n
            if ctl is not None:
                c_logits = ctl.head(ctl_hid[j, p - 1:p - 1 + n])
                if allowed is not None:
                    c_logits[:, allowed:] = float("-inf")
                pick = c_logits.argmax(dim=-1)
                ctl_gap = max(ctl_gap, float((best - logits.gather(
                    1, pick[:, None])[:, 0]).max()))
    out.update(logit_gap=gap, route_flip_share=flips, tokens=n_tok,
               distinct_tokens=len(distinct),
               median_margin=float(np.median(np.concatenate(margins))))
    if ctl is not None:
        out["control"] = {"logit_gap": ctl_gap,
                          "route_flip_share": flip_share(ctl.own, ref.own)}
    return out


def text_pieces() -> list[bytes]:
    """The bytes of every text id (< <|endoftext|>) in ``checkpoint``'s
    vocabulary."""
    byte_of = {c: b for b, c in ckpt.bytes_to_unicode().items()}
    return [bytes(byte_of[c] for c in w) for w in _vocabulary()]
