"""Weight-only int8 quantization of the decoder for serving.

Port of crisperwhisper_tpu/models/quantize.py for the port's layout
(linear weights [d_out, d_in], one dict per layer). Decode re-reads every
decoder weight each step, so per-output-channel int8 halves the bytes a
step moves against bf16. Only the decoder's dense weights are quantized;
conv stem, LayerNorms, embeddings and biases stay as they are.

Numerics are the reference's, bit for bit: the int8 values come from the
f32 scale, rounding is half-to-even (``torch.round``, as ``jnp.round``),
and the stored scale is bf16; every consumer multiplies by that bf16
scale (models/whisper.dense, ops/decode_step.py).

Group-wise int4 weights (``bits=4``) are reached only from the
reference's bench and are not ported (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

from typing import Any

import torch

from .whisper import Params

_GROUPS = ("self", "cross", "mlp")


def _quantize_dense(p: Params) -> Params:
    """{"w": [d_out, d_in]} -> {"w_q": int8 [d_out, d_in], "w_scale": bf16
    [d_out]} with one scale per output channel (max over d_in)."""
    w = p["w"].float()
    amax = w.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    out = {"w_q": w_q, "w_scale": scale[:, 0].to(torch.bfloat16)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def fuse_decoder_qkv(params: Params, head_dim: int) -> Params:
    """Fuse each decoder layer's self-attention q/k/v into one "qkv" dense
    of [3d, d], with the 1/sqrt(head_dim) query scale folded into the q
    rows and bias; k has no bias, so its third of the bias is zeros."""
    scale = head_dim ** -0.5
    layers = []
    for lp in params["decoder"]["layers"]:
        sp = lp["self"]
        w = torch.cat([sp["q"]["w"] * scale, sp["k"]["w"], sp["v"]["w"]], 0)
        bq = sp["q"]["b"] * scale
        bk = sp["k"].get("b", torch.zeros_like(bq))
        b = torch.cat([bq, bk, sp["v"]["b"]], 0)
        layers.append({**lp, "self": {"qkv": {"w": w, "b": b},
                                      "o": sp["o"]}})
    return {**params, "decoder": {**params["decoder"], "layers": layers}}


def quantize_decoder_weights(params: Params, bits: int = 8) -> Params:
    """Params with every decoder dense weight quantized to int8 per output
    channel. A new tree: the input is left as it is."""
    if bits != 8:
        raise NotImplementedError("group-wise int4 weights are not ported "
                                  "yet (ROADMAP queue 1, item 10)")
    layers = []
    for lp in params["decoder"]["layers"]:
        lp = dict(lp)
        for group in _GROUPS:
            lp[group] = {name: (_quantize_dense(p)
                                if isinstance(p, dict) and "w" in p else p)
                         for name, p in lp[group].items()}
        layers.append(lp)
    return {**params, "decoder": {**params["decoder"], "layers": layers}}


def dequantize_dense(q: Params) -> torch.Tensor:
    """The f32 weight [d_out, d_in] an int8 dense stands for."""
    return q["w_q"].float() * q["w_scale"].float()[:, None]


def quantization_error(params: Params, quantized: Params) -> dict[str, Any]:
    """Max relative dequantization error per decoder group: for each dense,
    max |w - deq| over all layers divided by max |w| over all layers."""
    orig_layers = params["decoder"]["layers"]
    quant_layers = quantized["decoder"]["layers"]
    report = {}
    for group in _GROUPS:
        errs = []
        for name, p in orig_layers[0][group].items():
            if not (isinstance(p, dict) and "w" in p):
                continue
            w = torch.stack([lp[group][name]["w"].float()
                             for lp in orig_layers])
            deq = torch.stack([dequantize_dense(lp[group][name])
                               for lp in quant_layers])
            errs.append(float((w - deq).abs().max()
                              / (w.abs().max() + 1e-9)))
        report[group] = max(errs) if errs else 0.0
    return report
