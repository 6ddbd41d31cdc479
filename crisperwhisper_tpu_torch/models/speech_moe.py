"""Uni-MoE-2.0-Omni's speech-to-text path as plain functions over a
parameter dict: the Whisper encoder, an adapter, and a decoder-only
language model whose every MLP is a mixture of experts.

Equations (``SpeechMoEArch`` holds the sizes, read from a ``config.json``
of ``model_type`` ``grin_qwen2_vl``):

* audio: the Whisper encoder (``models/whisper.encode``, kernel 1),
  then the adapter: the 1500 frames average-pooled to ``audio_tokens``
  in the bins of ``adaptive_avg_pool1d``, and a linear with bias into
  the language model's width (span ``cw.encode.adapter``);
* prompt: the window's ids (``SpeechLMTokens.prompt``), whose
  ``audio_pad`` positions take the adapter's outputs in order;
* layer: ``h = x + o(attn(RoPE(q(n1 x)), RoPE(k(n1 x)), v(n1 x)))`` and
  ``y = h + shared(n2 h) + routed(n2 h)``, the residual stream x, h, y
  kept in f32: RMSNorms n1, n2 (f32, with weight; the branches read them
  in the serving type, the gate in f32); q, k, v with bias, o without;
  grouped-query attention (query head i reads key head
  i // (heads / kv heads)), causal, scaled by
  head_dim ** -0.5; RoPE with rotate-half pairs over positions from 0;
  ``shared`` the shared experts as one SwiGLU of their summed width;
  ``routed`` the dynamic top-p experts of ``ops/moe.py`` (its grouped
  kernel on the card);
* head: the final RMSNorm, then the untied head.

Parameter layout: ``encoder`` is the Whisper encoder's tree;
``adapter`` {w [d, d_audio], b}; ``decoder`` {tok_emb [V, d], layers,
norm {scale}, head {w [V, d]}}, each layer {ln1 {scale}, attn {q, k, v
{w, b}, o {w}}, ln2 {scale}, router {w [E + N, d] f32}, shared {gate, up
{w [S, d]}, down {w [d, S]}}, experts {gate, up [E, f, d], down [E, d,
f]}}; norms and the router in f32, the rest in the serving type.

The decode state is ``SelfCache``: self K/V only, [L, B, kv heads, T,
head_dim]. ``prefill`` runs a block of prompt positions through every
layer and computes no logits; ``decode_step`` runs one token a row and
returns its f32 logits. Recording, the cache keeps every kept routing
entry on the device (``RoutingRecord``), apart for the prefill and the
one-token steps, and counts them once a decode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from ..config import WhisperArch
from ..ops import moe
from ..utils.tracing import trace_span
from .whisper import encode as whisper_encode

Params = dict[str, Any]
MODEL_TYPE = "grin_qwen2_vl"


# The audio tower of a speech LM whose config gives only its width
# (``whisper_hidden_size``): Whisper large-v3's encoder geometry.
_LARGE_V3_ENCODER = {"num_mel_bins": 128, "encoder_layers": 32,
                     "encoder_attention_heads": 20, "encoder_ffn_dim": 5120,
                     "max_source_positions": 1500}


@dataclass(frozen=True)
class SpeechMoEArch:
    """A speech LM (``model_type`` ``grin_qwen2_vl``, Uni-MoE-2.0-Omni's
    speech-to-text path): the Whisper encoder ``audio`` and a linear
    adapter of ``audio_tokens`` pooled frames feed a decoder-only
    language model (Qwen2's layer: RMSNorm, GQA with q/k/v bias and
    RoPE, untied head) whose every MLP is a mixture of experts:
    ``num_experts`` routed SwiGLU experts and ``null_experts`` experts
    that output zero, chosen by top-p ``top_p`` capped at ``top_k``
    from an f32 gate, beside ``shared_experts`` shared SwiGLU experts
    (this module)."""

    audio: WhisperArch
    audio_tokens: int = 200
    hidden_size: int = 3584
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    vocab_size: int = 152064
    num_experts: int = 4
    null_experts: int = 1
    expert_dim: int = 18944
    top_p: float = 0.7
    top_k: int = 2
    shared_experts: int = 2
    shared_dim: int = 2368
    max_position_embeddings: int = 128000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_mel_bins(self) -> int:
        return self.audio.num_mel_bins

    @property
    def max_source_positions(self) -> int:
        return self.audio.max_source_positions

    @property
    def max_target_positions(self) -> int:
        return self.max_position_embeddings

    @classmethod
    def from_hf_config(cls, d: Mapping[str, Any]) -> "SpeechMoEArch":
        """From a parsed ``config.json`` of ``model_type``
        ``grin_qwen2_vl``. The audio tower is Whisper large-v3's encoder
        at ``whisper_hidden_size``, or the Whisper keys of
        ``audio_config`` where the file has one."""
        audio = WhisperArch.from_hf_config(
            {**_LARGE_V3_ENCODER, "d_model": d["whisper_hidden_size"],
             **d.get("audio_config", {})})
        return cls(
            audio=audio, audio_tokens=d["whisper_query_tokens_size"],
            hidden_size=d["hidden_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d["num_key_value_heads"],
            rope_theta=float(d["rope_theta"]),
            rms_norm_eps=float(d["rms_norm_eps"]),
            vocab_size=d["vocab_size"],
            num_experts=d["mlp_dynamic_expert_num"],
            null_experts=d["mlp_dynamic_null_expert_num"],
            expert_dim=d["dynamic_intermediate_size"],
            top_p=float(d["mlp_dynamic_top_p"]),
            top_k=d["mlp_dynamic_top_k"],
            shared_experts=d["mlp_fixed_expert_num"],
            shared_dim=d["shared_intermediate_size"],
            max_position_embeddings=d["max_position_embeddings"])


@dataclass(frozen=True)
class SpeechLMTokens:
    """The special ids and the window prompt of a speech LM (Qwen2's
    layout), in the place of a Whisper model's ``SpecialTokens``.
    ``prompt`` holds ``audio_pad`` once for each adapter output; a reply
    ends at ``eot`` (<|im_end|>). The vocabulary has no timestamp tokens
    (``timestamp_begin`` is its size) and no no-speech token."""

    eot: int
    audio_pad: int
    prompt: tuple[int, ...]
    timestamp_begin: int


def rms_norm(x: torch.Tensor, p: Params, eps: float,
             dtype: torch.dtype | None = None) -> torch.Tensor:
    """RMSNorm in f32 with its weight, in ``dtype`` (x's by default)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * p["scale"]).to(dtype or x.dtype)


def rope_table(n: int, head_dim: int, theta: float,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) f32 [n, head_dim] of positions 0..n-1: angles
    position * theta ** (-2i / head_dim), computed in float64, each
    repeated for the two halves (rotate-half pairs)."""
    inv = theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float64)
                    / head_dim)
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return (ang.cos().float().to(device), ang.sin().float().to(device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, Dh] at the positions of cos/sin [S, Dh], in f32."""
    xf = x.float()
    half = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def swiglu(x: torch.Tensor, p: Params) -> torch.Tensor:
    return F.linear(F.silu(F.linear(x, p["gate"]["w"]))
                    * F.linear(x, p["up"]["w"]), p["down"]["w"])


@dataclass
class RoutingRecord:
    """One decode's routing on the device, each kept entry of every
    token at every layer: ``prefill`` [L, B * S, E + N] bool (empty until
    the prefill) and ``steps`` [steps, L, B, E + N] bool, the one-token
    steps from ``first_step`` on. ``moe.route`` writes its kept mask
    straight into the layer's slice, in place of the buffer it would
    fill anyway, so recording adds no launch to a step."""
    prefill: torch.Tensor
    steps: torch.Tensor
    first_step: int = 0

    def counts(self, num_experts: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(prefill, steps) int64 [L, 2 E + N + 2]: per layer the rows
        each routed and null expert kept, the tokens that kept one and
        two entries, and the launches (the prefill, each step) in which
        each routed expert had rows."""
        p, s = self.prefill, self.steps
        p_kept, s_kept = p.sum(-1), s.sum(-1)
        return (torch.cat([p.sum(1), (p_kept == 1).sum(1)[:, None],
                           (p_kept == 2).sum(1)[:, None],
                           p[..., :num_experts].any(1).long()], 1),
                torch.cat([s.sum((0, 2)), (s_kept == 1).sum((0, 2))[:, None],
                           (s_kept == 2).sum((0, 2))[:, None],
                           s[..., :num_experts].any(2).sum(0)], 1))


def moe_mlp(y: torch.Tensor, lp: Params, arch: SpeechMoEArch,
            dtype: torch.dtype, kept: torch.Tensor | None = None
            ) -> torch.Tensor:
    """shared(y) + routed(y) in f32 for tokens y [T, d] (f32): the gate
    reads y, the experts y in ``dtype``; ``kept`` [T, E + N] receives the
    routing's kept mask."""
    r = moe.route(y, lp["router"]["w"], arch.num_experts, arch.top_p,
                  arch.top_k, kept_out=kept)
    y = y.to(dtype)
    routed = moe.routed_experts(y, r, lp["experts"], arch.num_experts)
    return routed + swiglu(y, lp["shared"]).float()


@torch.inference_mode()
def encode(params: Params, arch: SpeechMoEArch,
           input_features: torch.Tensor) -> torch.Tensor:
    """[B, n_mels, 3000] log-mel -> [B, audio_tokens, d] audio
    embeddings: the Whisper encoder, then the adapter."""
    states = whisper_encode(params, arch.audio, input_features)
    with trace_span("cw.encode.adapter", rows=states.shape[0]):
        pooled = F.adaptive_avg_pool1d(states.transpose(1, 2),
                                       arch.audio_tokens).transpose(1, 2)
        return F.linear(pooled, params["adapter"]["w"],
                        params["adapter"]["b"])


@dataclass
class SelfCache:
    """Self K/V [L, B, kv heads, T, head_dim], RoPE tables for positions
    0..T-1, and the routing record (None: not recorded)."""
    k: torch.Tensor
    v: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    routing: RoutingRecord | None = None


def init_cache(arch: SpeechMoEArch, batch: int, cache_len: int,
               dtype: torch.dtype, device, recording: bool = False
               ) -> SelfCache:
    shape = (arch.num_hidden_layers, batch, arch.num_key_value_heads,
             cache_len, arch.head_dim)
    cos, sin = rope_table(cache_len, arch.head_dim, arch.rope_theta, device)
    record = None
    if recording:
        width = arch.num_experts + arch.null_experts
        empty = torch.zeros((arch.num_hidden_layers, 0, width),
                            dtype=torch.bool, device=device)
        record = RoutingRecord(empty, empty[None])
    return SelfCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device), cos, sin,
                     record)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            position: int) -> torch.Tensor:
    """q [B, H, S, Dh] at positions position.., over k/v [B, KV, T, Dh]
    (T = position + S), causal; scores and softmax in f32."""
    b, h, s, dh = q.shape
    kv = k.shape[1]
    qg = q.reshape(b, kv, (h // kv) * s, dh).float()
    scores = torch.matmul(qg, k.float().transpose(-1, -2)) / math.sqrt(dh)
    if s > 1:
        key = torch.arange(k.shape[2], device=q.device)
        query = position + torch.arange(s, device=q.device).repeat(h // kv)
        scores = scores.masked_fill(key[None, :] > query[:, None],
                                    float("-inf"))
    out = torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)
    return out.reshape(b, h, s, dh)


def _layers(params: Params, arch: SpeechMoEArch, x: torch.Tensor,
            position: int, cache: SelfCache,
            kept: torch.Tensor | None) -> torch.Tensor:
    """Every layer over x [B, S, d] at positions position..position+S-1,
    writing the S new K/V slots of each layer into the cache and, given
    ``kept`` [L, B * S, E + N], each layer's routing into it. The
    residual stream is f32 (returned so); each branch reads it normed in
    the cache's type."""
    b, s, d = x.shape
    h, kv, dh = (arch.num_attention_heads, arch.num_key_value_heads,
                 arch.head_dim)
    end = position + s
    cos, sin = cache.cos[position:end], cache.sin[position:end]
    dtype = cache.k.dtype
    x = x.float()
    for li, lp in enumerate(params["decoder"]["layers"]):
        a = lp["attn"]
        y = rms_norm(x, lp["ln1"], arch.rms_norm_eps, dtype)
        q = F.linear(y, a["q"]["w"], a["q"]["b"]).view(b, s, h, dh)
        k = F.linear(y, a["k"]["w"], a["k"]["b"]).view(b, s, kv, dh)
        v = F.linear(y, a["v"]["w"], a["v"]["b"]).view(b, s, kv, dh)
        cache.k[li, :, :, position:end] = apply_rope(k.transpose(1, 2), cos,
                                                     sin)
        cache.v[li, :, :, position:end] = v.transpose(1, 2)
        out = _attend(apply_rope(q.transpose(1, 2), cos, sin),
                      cache.k[li, :, :, :end], cache.v[li, :, :, :end],
                      position)
        x = x + F.linear(out.transpose(1, 2).reshape(b, s, d), a["o"]["w"])
        y = rms_norm(x, lp["ln2"], arch.rms_norm_eps)
        x = x + moe_mlp(y.reshape(b * s, d), lp, arch, dtype,
                        None if kept is None else kept[li]).view(b, s, d)
    return x


def logits(params: Params, arch: SpeechMoEArch,
           x: torch.Tensor) -> torch.Tensor:
    """f32 logits of hidden states x [..., d]: final RMSNorm, the head."""
    dec = params["decoder"]
    return F.linear(rms_norm(x, dec["norm"], arch.rms_norm_eps,
                             dec["head"]["w"].dtype),
                    dec["head"]["w"]).float()


# The window prompt, a chat turn around the audio (the template and the
# audio tokens' names are assumed: Qwen2.5-Omni's names and ids).
PROMPT_HEAD = "<|im_start|>user\n<|audio_start|>"
PROMPT_TAIL = ("<|audio_end|>Transcribe the audio verbatim.<|im_end|>\n"
               "<|im_start|>assistant\n")
AUDIO_PAD = "<|AUDIO|>"
END_OF_TURN = "<|im_end|>"


def speech_tokens(tokenizer, arch: SpeechMoEArch) -> SpeechLMTokens:
    """The special ids and window prompt of a speech LM from its
    tokenizer (``tokenizer.whisper_tokenizer.WhisperTokenizer`` over
    Qwen2's files: byte-level BPE, the specials as added tokens): the
    head, ``audio_tokens`` audio positions, the tail."""
    pad = tokenizer.token_to_id(AUDIO_PAD)
    eot = tokenizer.token_to_id(END_OF_TURN)
    if pad is None or eot is None:
        raise ValueError(f"the tokenizer lacks {AUDIO_PAD} or {END_OF_TURN}")
    ids = (tokenizer.encode(PROMPT_HEAD) + [pad] * arch.audio_tokens
           + tokenizer.encode(PROMPT_TAIL))
    return SpeechLMTokens(eot=eot, audio_pad=pad, prompt=tuple(ids),
                          timestamp_begin=arch.vocab_size)


def audio_offset(tokens: SpeechLMTokens, n_audio: int) -> int:
    """The first of the prompt's ``n_audio`` consecutive audio
    positions."""
    ids = list(tokens.prompt)
    start = ids.index(tokens.audio_pad)
    if ids[start:start + n_audio] != [tokens.audio_pad] * n_audio or \
            ids.count(tokens.audio_pad) != n_audio:
        raise ValueError(f"the prompt needs one run of {n_audio} audio "
                         "positions")
    return start


def embed(params: Params, ids: torch.Tensor, audio: torch.Tensor,
          start: int) -> torch.Tensor:
    """Token embeddings of ids [B, S] with audio [B, A, d] in positions
    start..start+A-1."""
    x = params["decoder"]["tok_emb"][ids]
    x[:, start:start + audio.shape[1]] = audio.to(x.dtype)
    return x


@torch.inference_mode()
def prefill(params: Params, arch: SpeechMoEArch, ids: torch.Tensor,
            audio: torch.Tensor, start: int, cache: SelfCache) -> SelfCache:
    """Run the prompt block ids [B, S] (audio spliced at ``start``) from
    position 0, filling the first S slots of the cache (and, recording,
    the routing of its S positions and room for the steps after)."""
    b, s = ids.shape
    kept = None
    if cache.routing is not None:
        _, _, width = cache.routing.prefill.shape
        n_layers = arch.num_hidden_layers
        kept = torch.empty((n_layers, b * s, width), dtype=torch.bool,
                           device=ids.device)
        cache.routing = RoutingRecord(kept, torch.zeros(
            (cache.k.shape[3] - s, n_layers, b, width), dtype=torch.bool,
            device=ids.device), first_step=s)
    _layers(params, arch, embed(params, ids, audio, start), 0, cache, kept)
    return cache


@torch.inference_mode()
def decode_step(params: Params, arch: SpeechMoEArch, tokens: torch.Tensor,
                position: int, cache: SelfCache) -> torch.Tensor:
    """One token a row, tokens [B] at ``position``: f32 logits [B, V]."""
    x = params["decoder"]["tok_emb"][tokens][:, None]
    rec = cache.routing
    kept = None if rec is None else rec.steps[position - rec.first_step]
    x = _layers(params, arch, x, position, cache, kept)
    return logits(params, arch, x[:, 0])


def forward(params: Params, arch: SpeechMoEArch, input_features: torch.Tensor,
            ids: torch.Tensor, start: int) -> torch.Tensor:
    """Teacher-forced logits [B, S, V] f32 of ids [B, S] over the audio of
    input_features spliced at ``start``, through a fresh cache."""
    audio = encode(params, arch, input_features)
    cache = init_cache(arch, ids.shape[0], ids.shape[1], audio.dtype,
                       audio.device)
    x = _layers(params, arch, embed(params, ids, audio, start), 0, cache,
                None)
    return logits(params, arch, x)
