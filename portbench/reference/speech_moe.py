"""Plain Uni-MoE-2.0-Omni speech-to-text path in PyTorch, teacher-forced.

The reference the benchmark holds the speech-LM cells against. It
imports nothing of the port and takes nothing the port made: it reads
the benchmark's own weight tree (``archs/grin_qwen2_vl.weights``, the
layout of the port's models/speech_moe.py) and audio, and follows the
model's equations (``tests/plain_speech_moe.py``, the suite's copy,
gives them and is held equal to this one): Whisper's encoder
(``model.Reference.encode``), the adapter (average pooling into
``audio_tokens`` bins, a linear with bias), then the decoder-only
language model (RMSNorm, q/k/v with bias, RoPE, causal grouped-query
attention, o; RMSNorm, shared experts plus the dynamic top-p routed
experts with a null expert; final RMSNorm, untied head).

Computed in f32 with TF32 off (the caller's ``model.no_tf32``), a whole
batch of windows one layer at a time: each dense upcasts its weight
when it is used, so one layer's f32 copies live beside the bf16 weights
at a time. The routed experts run on the rows routed to them: by its
own gate, or by routes given from the program under test, so that a
routing decision that bf16 rounding tips one way and f32 the other is
counted as a flip and does not carry the two paths apart.

``mode``: ``"f32"`` (every weight as given) or ``"fp8"`` (every dense's
weight and input, the router's and the head's included, rounded to
float8 e4m3 per output channel and per row: the control below bf16).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import model

MODES = ("f32", "fp8")


class Reference:
    """The plain model over the benchmark's weight tree, in ``mode``;
    ``arch`` is read for its sizes (the shapes object of the cell's
    architecture file)."""

    def __init__(self, params: dict, arch, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: use one of {MODES}")
        self.p = params
        self.arch = arch
        self.mode = mode
        self.audio = model.Reference(params, arch.audio, mode)

    def dense(self, x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor | None = None) -> torch.Tensor:
        w = w.float()
        if self.mode == "fp8":
            w, x = model.fp8(w), model.fp8(x)
        y = F.linear(x, w)
        return y if b is None else y + b.float()

    def rms(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.arch.rms_norm_eps) * p["scale"].float()

    def swiglu(self, x, gate, up, down):
        return self.dense(F.silu(self.dense(x, gate)) * self.dense(x, up),
                          down)

    @torch.no_grad()
    def audio_embeddings(self, feats: torch.Tensor,
                         block: int = 4) -> torch.Tensor:
        """[B, n_mels, 3000] -> [B, audio_tokens, d]: the encoder (in
        blocks of windows), the adapter's pooling and linear."""
        states = torch.cat([self.audio.encode(feats[i:i + block])
                            for i in range(0, feats.shape[0], block)])
        n, m = states.shape[1], self.arch.audio_tokens
        pooled = torch.stack(
            [states[:, (i * n) // m:-((-(i + 1) * n) // m)].mean(1)
             for i in range(m)], dim=1)
        a = self.p["adapter"]
        return self.dense(pooled, a["w"], a["b"])

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        t, dh = x.shape[2], x.shape[3]
        inv = self.arch.rope_theta ** (
            -torch.arange(0, dh, 2, dtype=torch.float64) / dh)
        ang = torch.arange(t, dtype=torch.float64)[:, None] * inv[None, :]
        ang = torch.cat([ang, ang], dim=-1)
        cos, sin = (f(ang).float().to(x.device) for f in (torch.cos,
                                                          torch.sin))
        half = dh // 2
        return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin

    def kept(self, probs: torch.Tensor) -> torch.Tensor:
        """The entries [T, E + N] each token keeps: the shortest
        descending prefix of ``probs`` whose sum reaches top_p, at most
        top_k entries (ties: the lower index first)."""
        arch = self.arch
        p_sorted, order = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
        kept = torch.zeros_like(probs, dtype=torch.bool)
        total = torch.zeros_like(probs[:, 0])
        for j in range(arch.top_k):
            take = (total < arch.top_p) if j else torch.ones_like(kept[:, 0])
            kept.scatter_(1, order[:, j:j + 1], take[:, None])
            total = total + torch.where(take, p_sorted[:, j], 0.0)
        return kept

    def experts(self, y: torch.Tensor, lp: dict,
                route: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(shared(y) + routed(y), the entries this gate keeps) of tokens
        y [T, d]; ``route`` [T, E + N], where given, are the entries the
        routed sum takes in their place (each weighted by this gate's
        probability)."""
        arch = self.arch
        sh = lp["shared"]
        out = self.swiglu(y, sh["gate"]["w"], sh["up"]["w"], sh["down"]["w"])
        probs = torch.softmax(self.dense(y, lp["router"]["w"]), dim=-1)
        own = self.kept(probs)
        kept = own if route is None else route
        ex = lp["experts"]
        for e in range(arch.num_experts):
            rows = torch.nonzero(kept[:, e])[:, 0]
            if rows.numel():
                out[rows] += probs[rows, e, None] * self.swiglu(
                    y[rows], ex["gate"][e], ex["up"][e], ex["down"][e])
        return out, own

    @torch.no_grad()
    def hidden(self, feats: torch.Tensor, ids: torch.Tensor, start: int,
               routes: torch.Tensor | None = None) -> torch.Tensor:
        """The final-normed hidden states [B, T, d] f32 of ids [B, T]
        over the windows' log-mel ``feats``, the audio at ``start``.
        ``routes`` [L, B * T, E + N], where given, are the entries each
        layer's routed sum takes (another path's choice, so that this one
        is compared with it on the same routes). Each layer's own choice
        is left in ``self.own`` [L, B * T, E + N]."""
        arch = self.arch
        audio = self.audio_embeddings(feats)
        dec = self.p["decoder"]
        x = dec["tok_emb"][ids].float()
        x[:, start:start + audio.shape[1]] = audio
        b, t, d = x.shape
        h, kv = arch.num_attention_heads, arch.num_key_value_heads
        dh = d // h
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        own = []
        for li, lp in enumerate(dec["layers"]):
            a = lp["attn"]
            y = self.rms(x, lp["ln1"])
            q = self.rope(self.dense(y, a["q"]["w"], a["q"]["b"])
                          .view(b, t, h, dh).transpose(1, 2))
            k = self.rope(self.dense(y, a["k"]["w"], a["k"]["b"])
                          .view(b, t, kv, dh).transpose(1, 2))
            v = self.dense(y, a["v"]["w"], a["v"]["b"]).view(
                b, t, kv, dh).transpose(1, 2)
            k = k.repeat_interleave(h // kv, dim=1)
            v = v.repeat_interleave(h // kv, dim=1)
            s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
            w = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            x = x + self.dense(torch.matmul(w, v).transpose(1, 2)
                               .reshape(b, t, d), a["o"]["w"])
            y = self.rms(x, lp["ln2"])
            out, chosen = self.experts(y.reshape(b * t, d), lp,
                                       None if routes is None else routes[li])
            x = x + out.view(b, t, d)
            own.append(chosen)
        self.own = torch.stack(own)
        return self.rms(x, dec["norm"])

    @torch.no_grad()
    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Logits [..., V] f32 of final-normed hidden states."""
        return self.dense(x, self.p["decoder"]["head"]["w"])

    def logits(self, feats: torch.Tensor, ids: torch.Tensor,
               start: int) -> torch.Tensor:
        with model.no_tf32():
            return self.head(self.hidden(feats, ids, start))
