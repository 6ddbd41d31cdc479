"""Plain Whisper in PyTorch: log-mel, encoder, teacher-forced decoder.

The reference the benchmark holds the port against. It imports nothing of
the port and takes nothing the port made: it reads the benchmark's own
weight tree (``weights.make``) and audio, and works out again whatever
the port derives from them. Computed in f32 with TF32 off (the caller
sets ``torch.backends``; ``no_tf32`` does it here), one dense at a time,
following the published model (hf modeling_whisper.py): pre-LN blocks,
exact GELU, Q scaled by head_dim ** -0.5, k_proj without bias, final
LayerNorms, the LM head tied to the token embedding.

``mode`` says how the decoder's numbers are stored, as a serving path
would store them:

* ``"f32"``: every weight as given, K/V in f32 (the default path's
  reference);
* ``"serving"``: the decoder's dense weights int8 per output channel
  (bf16 scales), the cross K/V int4 and the self K/V int8 per position
  over the head dimension (bf16 scales): what ``quantize="serving"``
  derives, recomputed here;
* ``"fp8"``: every dense's weight and input, the LM head's included,
  rounded to float8 e4m3 (per output channel and per row), the control
  below bf16;
* ``"serving-int4"``: as ``"serving"`` with int4 decoder weights and an
  int4 self ring, the control below int8.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

MODES = ("f32", "serving", "fp8", "serving-int4")
FP8_MAX = 448.0


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


# ---------------------------------------------------------------------------
# log-mel (hf feature_extraction_whisper.py)
# ---------------------------------------------------------------------------


def _hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = 3.0 * freq / 200.0
    safe = np.where(freq >= 1000.0, freq, 1000.0)
    return np.where(freq >= 1000.0,
                    15.0 + np.log(safe / 1000.0) * (27.0 / np.log(6.4)), mels)


def _mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    return np.where(mels >= 15.0,
                    1000.0 * np.exp(np.log(6.4) / 27.0 * (mels - 15.0)),
                    200.0 * mels / 3.0)


def mel_bank(n_freq: int, n_mels: int, sr: int = 16000) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular bank [n_freq, n_mels]."""
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(8000.0),
                                   n_mels + 2))
    fft_f = np.linspace(0, sr // 2, n_freq)
    slopes = mel_f[None, :] - fft_f[:, None]
    diff = np.diff(mel_f)
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1],
                                    slopes[:, 2:] / diff[1:]))
    return (fb * (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[None, :]
            ).astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int, n_fft: int = 400,
            hop: int = 160) -> torch.Tensor:
    """[B, 480000] f32 -> [B, n_mels, 3000]: hann(400), centered reflect
    STFT, last frame dropped, power, mel, log10 floored at 1e-10, clipped
    at the window's max - 8, (x + 4) / 4."""
    win = torch.hann_window(n_fft, periodic=True, dtype=torch.float64,
                            device=audio.device)
    spec = torch.stft(audio.double(), n_fft, hop_length=hop, window=win,
                      center=True, pad_mode="reflect",
                      return_complex=True)[..., :-1]
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(mel_bank(n_fft // 2 + 1, n_mels)).to(
        device=audio.device, dtype=torch.float64)
    mel = torch.matmul(fb.T, power)
    log_spec = torch.log10(mel.clamp_min(1e-10))
    log_spec = torch.maximum(log_spec,
                             log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).float()


# ---------------------------------------------------------------------------
# stored-number emulation
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def quant_dequant(x: torch.Tensor, qmax: float) -> torch.Tensor:
    """Symmetric quantization over the last axis with the scale stored in
    bf16: the integer from the f32 scale (half to even), times the bf16
    scale."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q * _bf16(scale)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 over the last axis, scaled so each row's max is 448."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The plain model over the benchmark's weight tree, in ``mode``."""

    def __init__(self, params: dict, arch, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: use one of {MODES}")
        self.p = params
        self.arch = arch
        self.mode = mode
        self.dh = arch.d_model // arch.encoder_attention_heads
        w_bits = {"serving": 127.0, "serving-int4": 7.0}.get(mode)
        self.weight_qmax = w_bits
        self.self_qmax = w_bits
        self.cross_qmax = 7.0 if w_bits else None

    # -- blocks -------------------------------------------------------------

    def dense(self, x: torch.Tensor, p: dict, decoder: bool) -> torch.Tensor:
        w = p["w"].float()
        if self.mode == "fp8":
            w, x = fp8(w), fp8(x)
        elif decoder and self.weight_qmax is not None:
            w = quant_dequant(w, self.weight_qmax)
        y = F.linear(x, w)
        return y + p["b"].float() if "b" in p else y

    @staticmethod
    def ln(x: torch.Tensor, p: dict) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), p["scale"].float(),
                            p["bias"].float(), 1e-5)

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        return x.view(b, t, d // self.dh, self.dh).transpose(1, 2)

    @staticmethod
    def merge(x: torch.Tensor) -> torch.Tensor:
        b, h, t, dh = x.shape
        return x.transpose(1, 2).reshape(b, t, h * dh)

    @staticmethod
    def attend(q, k, v, mask=None):
        s = torch.matmul(q, k.transpose(-1, -2))
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        return torch.matmul(p, v), p

    def mlp(self, x, p, decoder):
        return self.dense(F.gelu(self.dense(x, p["fc1"], decoder)),
                          p["fc2"], decoder)

    # -- model --------------------------------------------------------------

    @torch.no_grad()
    def encode(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, n_mels, 3000] -> [B, 1500, d] f32."""
        enc = self.p["encoder"]
        x = F.gelu(F.conv1d(feats.float(), enc["conv1"]["w"].float(),
                            enc["conv1"]["b"].float(), padding=1))
        x = F.gelu(F.conv1d(x, enc["conv2"]["w"].float(),
                            enc["conv2"]["b"].float(), stride=2, padding=1))
        x = x.transpose(1, 2) + enc["pos"].float()
        scale = self.dh ** -0.5
        for lp in enc["layers"]:
            y = self.ln(x, lp["ln1"])
            a = lp["attn"]
            out, _ = self.attend(self.heads(self.dense(y, a["q"], False)
                                            * scale),
                                 self.heads(self.dense(y, a["k"], False)),
                                 self.heads(self.dense(y, a["v"], False)))
            x = x + self.dense(self.merge(out), a["o"], False)
            x = x + self.mlp(self.ln(x, lp["ln2"]), lp["mlp"], False)
        return self.ln(x, enc["ln_post"])

    @torch.no_grad()
    def decode(self, enc: torch.Tensor, ids: torch.Tensor,
               align_heads: list | None = None):
        """Teacher-forced decoder over ids [B, T] against encoder states
        [B, K, d]: (logits [B, T, V] f32, the alignment heads' cross
        attention [B, A, T, K] f32 or None)."""
        dec = self.p["decoder"]
        dev = enc.device
        ids = ids.to(dev).long()
        t = ids.shape[1]
        x = dec["tok_emb"][ids].float() + dec["pos_emb"][:t].float()
        causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
        scale = self.dh ** -0.5
        by_layer: dict[int, list] = {}
        for a, (layer, head) in enumerate(align_heads or []):
            by_layer.setdefault(layer, []).append((a, head))
        aligned = (torch.zeros((ids.shape[0], len(align_heads), t,
                                enc.shape[1]), device=dev)
                   if align_heads else None)
        for li, lp in enumerate(dec["layers"]):
            y = self.ln(x, lp["ln1"])
            s = lp["self"]
            q = self.heads(self.dense(y, s["q"], True) * scale)
            k = self.heads(self.dense(y, s["k"], True))
            v = self.heads(self.dense(y, s["v"], True))
            if self.self_qmax is not None:
                k, v = (quant_dequant(k, self.self_qmax),
                        quant_dequant(v, self.self_qmax))
            out, _ = self.attend(q, k, v, causal)
            x = x + self.dense(self.merge(out), s["o"], True)
            y = self.ln(x, lp["ln2"])
            c = lp["cross"]
            q = self.heads(self.dense(y, c["q"], True) * scale)
            k = self.heads(self.dense(enc, c["k"], True))
            v = self.heads(self.dense(enc, c["v"], True))
            if self.cross_qmax is not None:
                k, v = (quant_dequant(k, self.cross_qmax),
                        quant_dequant(v, self.cross_qmax))
            out, probs = self.attend(q, k, v)
            for a, head in by_layer.get(li, []):
                aligned[:, a] = probs[:, head]
            x = x + self.dense(self.merge(out), c["o"], True)
            x = x + self.mlp(self.ln(x, lp["ln3"]), lp["mlp"], True)
        x = self.ln(x, dec["ln"])
        emb = dec["tok_emb"].float()
        if self.mode == "fp8":                  # the LM head is a dense too
            x, emb = fp8(x), fp8(emb)
        return torch.matmul(x, emb.T), aligned

