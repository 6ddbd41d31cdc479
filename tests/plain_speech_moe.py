"""Plain reference of Uni-MoE-2.0-Omni's speech-to-text path, in f32.

The forward pass, written from the model's description with plain
``torch`` operations: no kernel, no cache, no batching. It imports
nothing of the port and no JAX, and reads the port's parameter tree
(models/speech_moe.py's docstring gives its layout). Matrix products
run in f32 with TF32 off (``no_tf32``).

1. Audio tower: Whisper's encoder on the log-mel features: two GELU
   convolutions (the second of stride 2), sinusoidal positions, pre-LN
   layers (attention with q scaled by head_dim ** -0.5, exact GELU MLP),
   a final LayerNorm.
2. Adapter: the 1500 frames averaged over the bins of
   ``adaptive_avg_pool1d`` (bin i covers frames floor(i n / m) to
   ceil((i + 1) n / m)), then a linear with bias.
3. Language model: token embeddings with the adapter's outputs in the
   prompt's audio positions; per layer RMSNorm, q/k/v with bias, RoPE
   (rotate-half, theta ** (-2i / head_dim)), causal grouped-query
   attention (query head i reads key head i // group), o without bias;
   RMSNorm, then shared(y) + routed(y); a final RMSNorm and the untied
   head.
4. Routing, per token: p = softmax(y @ W_g) over the routed and the
   null experts, in f32; the entries in descending order (ties: lower
   index first); kept is the shortest prefix whose sum (in f32) reaches
   top_p (as an f32), at most top_k entries; each kept routed expert
   adds p_e times its SwiGLU output, with no renormalisation; a kept
   null expert adds nothing.

Departures from the published model: the adapter's pooling and linear,
the chat prompt and the audio token's id are assumed (the published
config gives ``whisper_query_tokens_size`` and a linear projector only);
windows are 30 s where the published ``whisper_audio_time`` is 20 s;
M-RoPE is the plain 1-D RoPE it reduces to when the three position ids
are equal, as they are for audio and text tokens.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _lin(x, p):
    y = x @ p["w"].float().T
    return y + p["b"].float() if "b" in p else y


def _ln(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["scale"].float(),
                        p["bias"].float(), 1e-5)


def whisper_encoder(enc: dict, feats: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """[B, n_mels, 3000] -> [B, 1500, d_audio]."""
    x = F.gelu(F.conv1d(feats.float(), enc["conv1"]["w"].float(),
                        enc["conv1"]["b"].float(), padding=1))
    x = F.gelu(F.conv1d(x, enc["conv2"]["w"].float(),
                        enc["conv2"]["b"].float(), stride=2, padding=1))
    x = x.transpose(1, 2) + enc["pos"].float()
    b, t, d = x.shape
    dh = d // heads
    for lp in enc["layers"]:
        y = _ln(x, lp["ln1"])
        a = lp["attn"]
        q, k, v = (_lin(y, a[n]).view(b, t, heads, dh).transpose(1, 2)
                   for n in ("q", "k", "v"))
        w = torch.softmax((q * dh ** -0.5) @ k.transpose(-1, -2), dim=-1)
        x = x + _lin((w @ v).transpose(1, 2).reshape(b, t, d), a["o"])
        y = _ln(x, lp["ln2"])
        x = x + _lin(F.gelu(_lin(y, lp["mlp"]["fc1"])), lp["mlp"]["fc2"])
    return _ln(x, enc["ln_post"])


def adapter(p: dict, states: torch.Tensor, n_out: int) -> torch.Tensor:
    """Average pooling of the frames into ``n_out`` bins, then a linear."""
    n = states.shape[1]
    bins = [states[:, (i * n) // n_out:-((-(i + 1) * n) // n_out)].mean(1)
            for i in range(n_out)]
    return _lin(torch.stack(bins, dim=1), p)


def rms(x, p, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * p["scale"].float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, H, T, Dh] at positions 0..T-1."""
    t, dh = x.shape[2], x.shape[3]
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64) / dh)
    ang = torch.arange(t, dtype=torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    cos = ang.cos().float().to(x.device)
    sin = ang.sin().float().to(x.device)
    half = dh // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


def kept_entries(p: torch.Tensor, top_p: float, top_k: int) -> list:
    """The kept entries of one token's probabilities p [E + N]."""
    order = sorted(range(len(p)), key=lambda e: (-float(p[e]), e))
    kept, total = [], torch.zeros((), dtype=torch.float32)
    reach = torch.tensor(top_p, dtype=torch.float32)
    for e in order[:top_k]:
        if kept and total >= reach:
            break
        kept.append(e)
        total = total + p[e].float()
    return kept


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate.float().T) * (x @ up.float().T)) @ down.float().T


def moe(y: torch.Tensor, lp: dict, cfg: dict) -> torch.Tensor:
    """shared(y) + routed(y), y [T, d] f32."""
    sh = lp["shared"]
    out = swiglu(y, sh["gate"]["w"], sh["up"]["w"], sh["down"]["w"])
    probs = torch.softmax(y @ lp["router"]["w"].float().T, dim=-1)
    ex = lp["experts"]
    for i in range(y.shape[0]):
        for e in kept_entries(probs[i], cfg["top_p"], cfg["top_k"]):
            if e < cfg["num_experts"]:
                out[i] += probs[i, e] * swiglu(y[i:i + 1], ex["gate"][e],
                                               ex["up"][e], ex["down"][e])[0]
    return out


def forward(params: dict, cfg: dict, feats: torch.Tensor, ids: torch.Tensor,
            audio_start: int) -> torch.Tensor:
    """Logits [B, T, V] f32 of ids [B, T] over the log-mel ``feats``,
    the audio spliced at ``audio_start``. ``cfg``: hidden_size, heads,
    kv_heads, audio_heads, audio_tokens, rope_theta, eps, num_experts,
    top_p, top_k."""
    with no_tf32(), torch.no_grad():
        audio = adapter(params["adapter"],
                        whisper_encoder(params["encoder"], feats,
                                        cfg["audio_heads"]),
                        cfg["audio_tokens"])
        dec = params["decoder"]
        x = dec["tok_emb"][ids].float()
        x[:, audio_start:audio_start + audio.shape[1]] = audio
        b, t, d = x.shape
        h, kv = cfg["heads"], cfg["kv_heads"]
        dh = d // h
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        for lp in dec["layers"]:
            a = lp["attn"]
            y = rms(x, lp["ln1"], cfg["eps"])
            q = rope(_lin(y, a["q"]).view(b, t, h, dh).transpose(1, 2),
                     cfg["rope_theta"])
            k = rope(_lin(y, a["k"]).view(b, t, kv, dh).transpose(1, 2),
                     cfg["rope_theta"])
            v = _lin(y, a["v"]).view(b, t, kv, dh).transpose(1, 2)
            k = k.repeat_interleave(h // kv, dim=1)
            v = v.repeat_interleave(h // kv, dim=1)
            s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
            w = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            x = x + _lin((w @ v).transpose(1, 2).reshape(b, t, d), a["o"])
            y = rms(x, lp["ln2"], cfg["eps"])
            x = x + moe(y.reshape(b * t, d), lp, cfg).view(b, t, d)
        return rms(x, dec["norm"], cfg["eps"]) @ dec["head"]["w"].float().T
