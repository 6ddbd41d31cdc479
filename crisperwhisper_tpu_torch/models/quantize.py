"""Weight-only quantization of the decoder: int8 per output channel, or
group-wise int4.

Port of crisperwhisper_tpu/models/quantize.py for the port's layout
(linear weights [d_out, d_in], one dict per layer). Decode re-reads every
decoder weight each step, so per-output-channel int8 halves the bytes a
step moves against bf16, and group-wise int4 halves them again. Only the
decoder's dense weights are quantized; conv stem, LayerNorms, embeddings
and biases stay as they are.

Numerics are the reference's, bit for bit: the integer values come from
the f32 scale, rounding is half-to-even (``torch.round``, as
``jnp.round``), and the stored scale is bf16; every consumer multiplies
by that bf16 scale (models/whisper.dense, ops/decode_step.py).

Group-wise int4 (``bits=4``) stores, per dense, ``w_q4``: uint8 [d_out,
G, gsz/2] and ``w_gscale``: bf16 [d_out, G], with G groups of gsz =
min(128, d_in) input channels. Byte j of a group holds channel j in its
low nibble and channel j + gsz/2 in its high one, each offset by 8 (an
unsigned nibble in [1, 15]): the reference's packing, transposed to the
port's [d_out, d_in] order, so its bytes carry across unchanged. No kernel
reads this layout (kernel 5 takes int8 weights only); models/whisper.dense
unpacks it. It is not the int4 cache layout (models/whisper.pack_int4:
two neighbours a byte, two's complement), hence the ``_weights`` names.
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]

_GROUPS = ("self", "cross", "mlp")
INT4_GROUP = 128                 # input channels per int4 scale group


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


def pack_int4_weights(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes [..., G, gsz] in [-7, 7] -> uint8 [..., G, gsz/2]: byte
    j holds code j + 8 in its low nibble and code j + gsz/2 + 8 in its
    high one."""
    half = codes.shape[-1] // 2
    u = (codes.to(torch.int16) + 8).to(torch.uint8)
    return u[..., :half] | (u[..., half:] << 4)


def unpack_int4_weights(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., G, gsz/2] -> int8 codes [..., G, gsz], the inverse of
    ``pack_int4_weights``."""
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-1)


def _quantize_dense_int4_grouped(p: Params,
                                 group_size: int = INT4_GROUP) -> Params:
    """{"w": [d_out, d_in]} -> {"w_q4": uint8 [d_out, G, gsz/2],
    "w_gscale": bf16 [d_out, G]}: one scale per (output channel, group of
    gsz input channels), max |w| / 7; codes clip(round(w / scale), -7, 7)
    from the f32 scale (reference quantize.py:70-107)."""
    w = p["w"].float()
    d_out, d_in = w.shape
    group_size = min(group_size, d_in)
    if d_in % group_size or group_size % 2:
        raise ValueError(f"int4 weights: d_in {d_in} is not a multiple of "
                         f"an even group size {group_size}")
    wg = w.reshape(d_out, d_in // group_size, group_size)
    scale = torch.clamp_min(wg.abs().amax(dim=-1, keepdim=True), 1e-8) / 7.0
    codes = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8)
    out = {"w_q4": pack_int4_weights(codes),
           "w_gscale": scale[..., 0].to(torch.bfloat16)}
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
    """Params with every decoder dense weight quantized: int8 per output
    channel (``bits=8``) or group-wise int4 (``bits=4``). A new tree: the
    input is left as it is."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: use 8 or 4")
    quant = _quantize_dense if bits == 8 else _quantize_dense_int4_grouped
    layers = []
    for lp in params["decoder"]["layers"]:
        lp = dict(lp)
        for group in _GROUPS:
            lp[group] = {name: (quant(p)
                                if isinstance(p, dict) and "w" in p else p)
                         for name, p in lp[group].items()}
        layers.append(lp)
    return {**params, "decoder": {**params["decoder"], "layers": layers}}


def dequantize_dense(q: Params) -> torch.Tensor:
    """The f32 weight [d_out, d_in] a quantized dense stands for, int8 or
    group-wise int4."""
    if "w_q" in q:
        return q["w_q"].float() * q["w_scale"].float()[:, None]
    codes = unpack_int4_weights(q["w_q4"]).float()        # [d_out, G, gsz]
    deq = codes * q["w_gscale"].float()[..., None]
    return deq.reshape(deq.shape[0], -1)


def quantization_error(params: Params, quantized: Params) -> dict[str, Any]:
    """Max relative dequantization error per decoder group (either
    layout): for each dense, max |w - deq| over all layers divided by max
    |w| over all layers."""
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
