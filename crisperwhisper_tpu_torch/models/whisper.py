"""Whisper encoder-decoder as plain functions over a parameter dict.

Port of crisperwhisper_tpu/models/whisper.py (encoder, float-cache decoder
step, alignment-head capture). Numerics follow the reference model
(hf modeling_whisper.py): Q scaled by head_dim**-0.5 before QKᵀ, k_proj
without bias, pre-LN blocks with LayerNorm in f32, exact (erf) GELU, a
final LayerNorm on both stacks, learned decoder positions, the LM head
tied to the token embedding.

Parameter layout (models/loader.py builds it):
  * linear weights in torch layout [d_out, d_in] (``F.linear``), biases
    [d_out]; LayerNorm scale/bias always f32;
  * conv weights [C_out, C_in, k];
  * per-layer parameters as a list of dicts (``params[stack]["layers"]``),
    walked by a Python loop where the reference scans a stacked axis.

The encoder's unmasked self-attention goes through ops/fused_attention.py
(the CUDA kernel on CUDA tensors). A one-token decoder step reads each
layer's single-query attentions through ops/decode_attention.py (the
stacked-cache kernel, no copy of the cache; its plain twin on the CPU);
blocks of tokens, per-row positions and beams' cross attention, and the
MLPs and LM head, are plain torch ops, as the reference leaves them to
XLA; so is the rest of the quantized step (int8 or group-wise int4
weights, int8/int4 caches). The quantized serving step that runs all
layers in one kernel is ops/decode_step.py.

A tree from parallel/mesh.shard_params holds this rank's tensor-parallel
slices: the attention blocks read their head count from the local
weights, each row-parallel dense all-reduces its partial product over the
"model" group before the bias (``dense``), and the decoder step sums the
alignment heads over that group once, after the layer loop. Any other
tree takes no collective.

The full-sequence functions (``decoder_forward``, ``forward``,
``causal_lm_forward``, ``audio_classification_forward``) run the
teacher-forced decoder over a whole id sequence with a causal mask, for
parity checks, no-speech capture and the auxiliary heads.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .._device import resolve as resolve_device
from ..config import WhisperArch
from ..parallel.mesh import REDUCE, SLICE, model_shard

# the int4 cache packing lives in ops/decode_attention.py, which reads the
# caches without importing this module; unpack_int4 is re-exported
from ..ops.decode_attention import (bind_decode_gemv, cache_values,
                                    pack_int4, unpack_int4)  # noqa: F401
from ..ops.fused_attention import fused_attention
from ..ops.ring_write import ring_plan, write_block_columns_group
from .quantize import unpack_int4_weights

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Primitive blocks
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32 regardless of the activation dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), p["scale"], p["bias"], eps)
    return y.to(x.dtype)


def dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x @ wᵀ (+ b), weights [d_out, d_in]. The int8 layout of
    models/quantize.py ({"w_q": int8 [d_out, d_in], "w_scale": bf16
    [d_out]}) multiplies by the bf16 scale after the product, in x's
    dtype, as the reference's dense does (whisper.py:64-67). The
    group-wise int4 layout ({"w_q4": uint8 [d_out, G, gsz/2], "w_gscale":
    bf16 [d_out, G]}) contracts each group of gsz input channels, then
    folds the group scales into the [..., G, d_out] partials, in x's dtype
    (whisper.py:68-84)."""
    if "w_q" in p:
        y = _reduce(F.linear(x, p["w_q"].to(x.dtype)), p) \
            * p["w_scale"].to(x.dtype)
    elif "w_q4" in p:
        codes = unpack_int4_weights(p["w_q4"]).to(x.dtype)  # [d_out, G, gsz]
        _, g, gsz = codes.shape
        part = torch.einsum("...gi,ogi->...go",
                            x.reshape(*x.shape[:-1], g, gsz), codes)
        y = _reduce(torch.einsum("...go,og->...o", part,
                                 p["w_gscale"].to(x.dtype)), p)
    elif REDUCE in p:
        y = _reduce(F.linear(x, p["w"]), p)
    else:
        return F.linear(x, p["w"], p.get("b"))
    return y + p["b"].to(y.dtype) if "b" in p else y


def _reduce(y: torch.Tensor, p: Params) -> torch.Tensor:
    """The partial product of a row-parallel dense summed over its model
    group (parallel/mesh.shard_params marks such a dense), in place; any
    other dense's product as it is."""
    shard = p.get(REDUCE)
    if shard is not None:
        dist.all_reduce(y, group=shard.group)
    return y


def _out_features(p: Params) -> int:
    """A dense's output width on this rank (its local slice on a mesh)."""
    for key in ("w", "w_q", "w_q4"):
        if key in p:
            return p[key].shape[0]
    raise KeyError("dense without weights")


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)                 # exact erf form, as torch's default


def _split_heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """[B, T, H * Dh] -> contiguous [B, H, T, Dh]. H is read from the
    width: on a mesh a rank holds H / model heads."""
    b, t, d = x.shape
    return x.view(b, t, d // head_dim, head_dim).transpose(1, 2) \
        .contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, Dh] -> [B, T, d]."""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention over [B, H, T, Dh] tensors with q pre-scaled. Scores and
    softmax in f32 (the reference's preferred_element_type=f32);
    probabilities cast to v's dtype for the second product. Returns
    (out in v's dtype, probs f32)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v), probs


def self_attention_block(x: torch.Tensor, p: Params,
                         num_heads: int) -> torch.Tensor:
    """The encoder's unmasked self-attention (whisper.py:155-166), over
    the heads whose q/k/v rows this rank holds."""
    dh = x.shape[-1] // num_heads
    q = _split_heads(dense(x, p["q"]) * dh ** -0.5, dh)
    k = _split_heads(dense(x, p["k"]), dh)
    v = _split_heads(dense(x, p["v"]), dh)
    return dense(_merge_heads(fused_attention(q, k, v)), p["o"])


def mlp_block(x: torch.Tensor, p: Params) -> torch.Tensor:
    return dense(gelu(dense(x, p["fc1"])), p["fc2"])


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Fixed sinusoidal positions (modeling_whisper.py:54)."""
    log_timescale_increment = math.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment *
                            np.arange(channels // 2, dtype=np.float64))
    scaled_time = (np.arange(length, dtype=np.float64)[:, None] *
                   inv_timescales[None, :])
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int) -> torch.Tensor:
    """[B, C_in, T] conv with kernel [C_out, C_in, 3], padding 1."""
    return F.conv1d(x, w, b, stride=stride, padding=1)


def _encoder_layer(x: torch.Tensor, lp: Params,
                   num_heads: int) -> torch.Tensor:
    # pre-LN self-attn + pre-LN MLP (modeling_whisper.py:372-432)
    x = x + self_attention_block(layer_norm(x, lp["ln1"]), lp["attn"],
                                 num_heads)
    return x + mlp_block(layer_norm(x, lp["ln2"]), lp["mlp"])


@torch.inference_mode()
def encode(params: Params, arch: WhisperArch,
           input_features: torch.Tensor) -> torch.Tensor:
    """[B, n_mels, 3000] log-mel -> [B, 1500, d] encoder states
    (WhisperEncoder.forward, modeling_whisper.py:632-730)."""
    enc = params["encoder"]
    if input_features.shape[-1] != 2 * arch.max_source_positions:
        raise ValueError("encoder requires exactly "
                         f"{2 * arch.max_source_positions} mel frames")
    x = input_features.to(enc["conv1"]["w"].dtype)
    x = gelu(_conv1d(x, enc["conv1"]["w"], enc["conv1"]["b"], stride=1))
    x = gelu(_conv1d(x, enc["conv2"]["w"], enc["conv2"]["b"], stride=2))
    x = x.transpose(1, 2) + enc["pos"].to(x.dtype)          # [B, 1500, d]
    for lp in enc["layers"]:
        x = _encoder_layer(x, lp, arch.encoder_attention_heads)
    return layer_norm(x, enc["ln_post"])


# ---------------------------------------------------------------------------
# Decoder with a float or quantized KV cache and alignment-head capture
# ---------------------------------------------------------------------------

INT8, INT4 = "int8", "int4"          # quantized cache kinds
_QMAX = {INT8: 127.0, INT4: 7.0}


@dataclass
class DecoderCache:
    """Decode state, updated in place by the step functions.

    self_k/self_v: [L, B, H, T_max, Dh] — head-dim-last, so the live
    prefix ``[..., :position + 1, :]`` is one strided slice and every
    product reads contiguous rows. cross_k/cross_v: [L, B, H, K_enc, Dh],
    computed once from the encoder states.

    A quantized half (``init_cache(cross_dtype=..., self_dtype=...)``)
    holds int8 values, or int4 values nibble-packed two Dh neighbours to
    a byte (uint8 [..., Dh/2], the even index in the low nibble, each a
    two's-complement nibble in [-7, 7]), with one bf16 scale per position
    over Dh in ``*_scale`` [L, B, H, T]; the scales are None for a float
    half. Torch has no int4 dtype, and one value per byte would cost what
    int8 costs."""
    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: torch.Tensor | None = None
    cross_v_scale: torch.Tensor | None = None
    self_k_scale: torch.Tensor | None = None
    self_v_scale: torch.Tensor | None = None


def _quantize(x: torch.Tensor, qmax: float
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization over the last dim (whisper.py:277-284 of the
    reference): int8 values from the f32 scale, rounded half-to-even, and
    the scale rounded to bf16 for storage."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale[..., 0].to(torch.bfloat16)


def _store(q: torch.Tensor, kind: str) -> torch.Tensor:
    return pack_int4(q) if kind == INT4 else q


def _kind(c: torch.Tensor) -> str:
    return INT4 if c.dtype == torch.uint8 else INT8


@torch.inference_mode()
def init_cache(params: Params, arch: WhisperArch, encoder_out: torch.Tensor,
               dtype: torch.dtype | None = None,
               cache_len: int | None = None,
               cross_dtype: str | None = None,
               self_dtype: str | None = None,
               self_batch: int | None = None) -> DecoderCache:
    """Allocate the self-attention ring (cache_len positions, default
    max_target_positions) and fill the cross-attention K/V.

    cross_dtype ``INT8``/``INT4`` quantizes the cross K/V per position
    over Dh (from the f32 projections); self_dtype likewise makes the
    ring quantized: zeros with bf16 scales, each new column quantized as
    a step writes it. None keeps a half in ``dtype`` (default: the
    encoder states' dtype). self_batch sizes the ring's batch apart from
    the encoder batch: beam search keeps one cross cache per item and one
    ring per beam (self_batch = B * NB; see decode_step's beam_groups)."""
    dec = params["decoder"]
    b, k_len, _ = encoder_out.shape
    dh = arch.head_dim
    # the heads this rank holds (all of them off a mesh)
    h = _out_features(dec["layers"][0]["cross"]["k"]) // dh
    n_layers = arch.decoder_layers
    dtype = dtype or encoder_out.dtype
    cache_len = cache_len or arch.max_target_positions
    dev = encoder_out.device
    for kind in (cross_dtype, self_dtype):
        if kind not in (None, INT8, INT4):
            raise ValueError(f"cache dtype {kind!r}: use None, "
                             f"{INT8!r} or {INT4!r}")

    def empty(kind, rows, t):
        if kind is None:
            return torch.zeros((n_layers, rows, h, t, dh), dtype=dtype,
                               device=dev)
        width = dh // 2 if kind == INT4 else dh
        return torch.zeros((n_layers, rows, h, t, width), device=dev,
                           dtype=torch.uint8 if kind == INT4 else torch.int8)

    def scales(kind, rows, t):
        return None if kind is None else torch.zeros(
            (n_layers, rows, h, t), dtype=torch.bfloat16, device=dev)

    cross_k, cross_v = (empty(cross_dtype, b, k_len),
                        empty(cross_dtype, b, k_len))
    cks, cvs = scales(cross_dtype, b, k_len), scales(cross_dtype, b, k_len)
    for li, lp in enumerate(dec["layers"]):
        for name, dst, sc in (("k", cross_k, cks), ("v", cross_v, cvs)):
            x = _split_heads(dense(encoder_out, lp["cross"][name]), dh)
            if cross_dtype is None:
                dst[li] = x
            else:
                q, s = _quantize(x.float(), _QMAX[cross_dtype])
                dst[li] = _store(q, cross_dtype)
                sc[li] = s
    rows = self_batch or b
    return DecoderCache(self_k=empty(self_dtype, rows, cache_len),
                        self_v=empty(self_dtype, rows, cache_len),
                        cross_k=cross_k, cross_v=cross_v,
                        cross_k_scale=cks, cross_v_scale=cvs,
                        self_k_scale=scales(self_dtype, rows, cache_len),
                        self_v_scale=scales(self_dtype, rows, cache_len))


def alignment_selector(arch: WhisperArch,
                       alignment_heads: tuple[tuple[int, int], ...]
                       ) -> np.ndarray:
    """One-hot [L, H, A] map from (layer, head) cross-attention
    probabilities to the A alignment heads (generation_whisper.py:263)."""
    sel = np.zeros((arch.decoder_layers, arch.decoder_attention_heads,
                    max(len(alignment_heads), 1)), np.float32)
    for a, (layer, head) in enumerate(alignment_heads):
        sel[layer, head, a] = 1.0
    return sel


def _alignment_heads(align_sel: np.ndarray | None, n_layers: int,
                     heads_here: int, first: int, device: torch.device
                     ) -> list[tuple]:
    """Per layer: (alignment slots, the decoder heads they read, the
    one-hot selector f32 [heads_here, slots] and the slots as an int64
    index, both on ``device``; ``([], [], None, None)`` for a layer
    without alignment heads), from the one-hot selector (each alignment
    head has exactly one source). On a mesh a rank holds the
    ``heads_here`` heads from ``first`` on: only their slots are listed,
    by local head index. Kept by the selector's nonzero entries, so the
    device tensors are made at a decode's first step, not at every one;
    callers only read them."""
    if align_sel is None:
        return [([], [], None, None)] * n_layers
    return _alignment_plan(
        tuple(map(tuple, np.argwhere(np.asarray(align_sel)).tolist())),
        n_layers, heads_here, first, device)


@functools.lru_cache(maxsize=32)
def _alignment_plan(entries: tuple, n_layers: int, heads_here: int,
                    first: int, device: torch.device) -> list[tuple]:
    out = []
    for li in range(n_layers):
        mine = [(slot, head - first) for layer, head, slot in entries
                if layer == li and first <= head < first + heads_here]
        if not mine:
            out.append(([], [], None, None))
            continue
        slots, src = [s for s, _ in mine], [hd for _, hd in mine]
        sel = torch.zeros((heads_here, len(mine)), dtype=torch.float32)
        sel[src, range(len(mine))] = 1.0
        out.append((slots, src, sel.to(device),
                    torch.tensor(slots, dtype=torch.long, device=device)))
    return out


def _self_qkv(y: torch.Tensor, sp: Params, head_dim: int, scale: float
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Head-split (q, k, v) of y, q pre-scaled: one product through the
    fused "qkv" entry when present (models/quantize.fuse_decoder_qkv,
    whose q rows carry the scale), else three. A fused entry is replicated
    on a mesh (parallel/mesh.py): the rank keeps its own heads' columns of
    each third of the product."""
    if "qkv" in sp:
        qkv = dense(y, sp["qkv"])
        d = qkv.shape[-1] // 3
        lo, hi = 0, d
        shard = sp["qkv"].get(SLICE)
        if shard is not None:
            lo = shard.index * d // shard.size
            hi = lo + d // shard.size
        return tuple(_split_heads(qkv[..., i * d + lo:i * d + hi], head_dim)
                     for i in range(3))
    return (_split_heads(dense(y, sp["q"]) * scale, head_dim),
            _split_heads(dense(y, sp["k"]), head_dim),
            _split_heads(dense(y, sp["v"]), head_dim))


def quantized_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor,
                        mask: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention over a quantized cache (the reference's
    seq_last_attention with scales, whisper.py:466-491): q [B, H, S, Dh]
    pre-scaled; k/v [B, H, T, Dh] int8 or packed int4; per-position bf16
    scales [B, H, T] folded outside both products. Scores and softmax in
    f32; the scaled probabilities round to q's dtype before P·V. Returns
    (out in q's dtype, probs f32)."""
    kv = cache_values(k).float()
    s = torch.matmul(q.float(), kv.transpose(-1, -2)) \
        * k_scale.float()[:, :, None, :]
    if mask is not None:
        s = s.masked_fill(~mask, -1e9)
    p = torch.softmax(s, dim=-1)
    pv = (p * v_scale.float()[:, :, None, :]).to(q.dtype)
    out = torch.matmul(pv.float(), cache_values(v).float())
    return out.to(q.dtype), p


def _positions(position, s: int, dev: torch.device
               ) -> tuple[torch.Tensor | None, int | torch.Tensor,
                          int | None]:
    """(per-row start positions as a device int32 [B] tensor, or None for a
    scalar position; the lowest start; the end of the live ring prefix).
    A tensor position may lie on the host, where its bounds are read
    without a device sync. A one-token step's 0-d int32 position on
    ``dev`` is not read back: it comes back as the start, with no end
    (the caller checked its bounds)."""
    if isinstance(position, torch.Tensor):
        if position.dim() == 1:
            lo, hi = (int(v) for v in position.aminmax())
            return position.to(device=dev, dtype=torch.int32), lo, hi + s
        if (s == 1 and position.dim() == 0 and position.device == dev
                and position.dtype == torch.int32):
            return None, position, None
    position = int(position)
    return None, position, position + s


def _quantized_block(x: torch.Tensor, kind: str
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """New K or V rows x [B, H, S, Dh] quantized over Dh: (the ring's
    stored values [B, H, S, Dh or Dh/2], bf16 scales [B, H, S])."""
    q, sc = _quantize(x.float(), _QMAX[kind])
    return _store(q, kind), sc


def _self_rings(cache: DecoderCache) -> list[torch.Tensor]:
    """The self-attention rings a block writes: K, V and, for a quantized
    ring, their scale rings."""
    if cache.self_k_scale is None:
        return [cache.self_k, cache.self_v]
    return [cache.self_k, cache.self_v, cache.self_k_scale,
            cache.self_v_scale]


def _write_block(cache: DecoderCache, li: int, position: int,
                 pos_rows: torch.Tensor | None, k_new: torch.Tensor,
                 v_new: torch.Tensor, plan=None) -> None:
    """Write the new K/V rows [B, H, S, Dh] of layer li into the self
    ring (quantized over Dh when it is): at slots [position, position + S)
    for a scalar position, else row b at [pos_rows[b], pos_rows[b] + S)
    through ops/ring_write.py, all tensors in one call (``plan``: the
    rings' launch plan, looked up once a block). A step at a position
    held on the device passes it as ``pos_rows``, a copy for each row."""
    blocks = [k_new, v_new]
    if cache.self_k_scale is not None:
        kind = _kind(cache.self_k)
        (kq, ks), (vq, vs) = (_quantized_block(k_new, kind),
                              _quantized_block(v_new, kind))
        blocks = [kq, vq, ks, vs]
    pairs = list(zip(_self_rings(cache), blocks))
    if pos_rows is not None:
        write_block_columns_group(
            [(ring, blk.to(ring.dtype)) for ring, blk in pairs], li,
            pos_rows, plan)
        return
    end = position + k_new.shape[2]
    for ring, blk in pairs:
        ring[li, :, :, position:end] = blk


def _beam_rows(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, H, S, *] -> [B/NB, H, NB*S, *]: the NB beams of an item as
    extra query rows of the item's cross attention."""
    b, h, s = x.shape[:3]
    return x.reshape(b // groups, groups, h, s, -1).transpose(1, 2) \
        .reshape(b // groups, h, groups * s, -1)


def _unbeam_rows(x: torch.Tensor, groups: int, s: int) -> torch.Tensor:
    """The inverse of ``_beam_rows``: [B/NB, H, NB*S, *] -> [B, H, S, *]."""
    b0, h = x.shape[:2]
    return x.reshape(b0, h, groups, s, -1).transpose(1, 2) \
        .reshape(b0 * groups, h, s, -1)


def step_dtype(params: Params, cache: DecoderCache) -> torch.dtype:
    """A step's activation dtype: the ring's, or the token embedding's
    when the ring is quantized."""
    if cache.self_k_scale is not None:
        return params["decoder"]["tok_emb"].dtype
    return cache.self_k.dtype


@torch.inference_mode()
def _decode_block(params: Params, arch: WhisperArch, tokens: torch.Tensor,
                  position, cache: DecoderCache, align_sel, key_mask,
                  pos_offset, beam_groups: int, clamp_offset: bool):
    """decode_step_multi's body; ``clamp_offset`` clamps the shifted
    learned-position index at 0 (the reference does so in its block step,
    whisper.py:706-715, and not in its one-token step)."""
    dec = params["decoder"]
    dh = arch.head_dim
    b, s = tokens.shape
    self_quant = cache.self_k_scale is not None
    cross_quant = cache.cross_k_scale is not None
    dtype = step_dtype(params, cache)
    dev = tokens.device
    pos_rows, lo, end = _positions(position, s, dev)
    # a position held on the device (``_positions``): the ring write takes
    # it as every row's, and kernel 9 reads it there
    write_rows = pos_rows
    if end is None:
        write_rows = lo.expand(b).contiguous()
    elif end > cache.self_k.shape[3] or lo < 0:
        raise ValueError(f"positions [{lo}, {end}) leave the cache of "
                         f"length {cache.self_k.shape[3]}")
    steps = torch.arange(s, device=dev)
    if pos_rows is None:
        pos_ids = lo + steps                                      # [S]
    else:
        pos_ids = pos_rows.long()[:, None] + steps[None, :]       # [B, S]
    emb_ids = pos_ids
    if pos_offset is not None:
        # the offset moves only the learned-position lookup; ring slots,
        # the causal mask and the writes keep pos_ids
        emb_ids = pos_ids - pos_offset.to(device=dev).long()[:, None]
        if clamp_offset:
            emb_ids = emb_ids.clamp_min(0)
    x = dec["tok_emb"][tokens].to(dtype) \
        + dec["pos_emb"][emb_ids].to(dtype)                      # [B, S, d]
    if key_mask is not None:
        key_mask = key_mask.to(device=dev, dtype=torch.bool)
    # a one-token step reads each layer's single-query attention through
    # kernel 9 (ops/decode_attention.py) against the stacked caches: the
    # self half at a scalar position (the keys after it masked), the cross
    # half with one query an item (beams ride the item's cross attention
    # as extra query rows, so they take the plain path); None where the
    # kernel does not take the caches
    self_gemv = cross_gemv = None
    if s == 1 and pos_rows is None:
        self_gemv = bind_decode_gemv(dtype, cache.self_k, cache.self_v,
                                     cache.self_k_scale, cache.self_v_scale,
                                     key_mask)
    if s == 1 and beam_groups == 1:
        cross_gemv = bind_decode_gemv(dtype, cache.cross_k, cache.cross_v,
                                      cache.cross_k_scale,
                                      cache.cross_v_scale)
    if end is None and self_gemv is None:
        raise ValueError("a position on the device needs kernel 9's self "
                         "attention (decoding/greedy.step_graph_refusal)")
    mask = None
    if pos_rows is not None:
        # query i of row b attends to slots <= position[b] + i
        mask = (torch.arange(end, device=dev)[None, None, None, :]
                <= pos_ids[:, None, :, None])                  # [B, 1, S, T]
    elif s > 1:
        mask = (torch.arange(end, device=dev)[None, :]
                <= pos_ids[:, None])                           # [S, T]
    if key_mask is not None:
        # slots a row may attend to (False on a conditioned prompt's left
        # pads), over the live prefix the step reads
        live = key_mask[:, None, None, :end]
        mask = live if mask is None else mask & live          # [B, 1, S, T]
    scale = arch.head_dim ** -0.5
    n_align = align_sel.shape[-1] if align_sel is not None else 1
    aligned = torch.zeros((b, n_align, s, cache.cross_k.shape[3]),
                          dtype=torch.float32, device=dev)
    shard = model_shard(params)
    local = cache.cross_k.shape[2]
    heads = _alignment_heads(align_sel, arch.decoder_layers, local,
                             0 if shard is None else shard.index * local,
                             dev)
    plan = (ring_plan(_self_rings(cache))
            if write_rows is not None and cache.self_k.is_cuda else None)

    for li, lp in enumerate(dec["layers"]):
        y = layer_norm(x, lp["ln1"])
        q, k_new, v_new = _self_qkv(y, lp["self"], dh, scale)
        _write_block(cache, li, lo, write_rows, k_new, v_new, plan)
        if self_gemv is not None:
            out = self_gemv(q[:, :, 0], li, position=lo)[:, :, None]
        elif self_quant:
            out, _ = quantized_attention(
                q, cache.self_k[li, :, :, :end], cache.self_v[li, :, :, :end],
                cache.self_k_scale[li, :, :, :end],
                cache.self_v_scale[li, :, :, :end], mask)
        else:
            out, _ = attention(q, cache.self_k[li, :, :, :end],
                               cache.self_v[li, :, :, :end], mask)
        x = x + dense(_merge_heads(out.to(x.dtype)), lp["self"]["o"])

        y = layer_norm(x, lp["ln2"])
        qc = _split_heads(dense(y, lp["cross"]["q"]) * scale, dh)
        slots, src, sel, slot_index = heads[li]
        if cross_gemv is not None:
            out = cross_gemv(qc[:, :, 0], li, sel=sel)
            if sel is not None:
                out, rows = out
                aligned.index_copy_(1, slot_index, rows[:, :, None])
            out = out[:, :, None]
        else:
            if beam_groups > 1:
                qc = _beam_rows(qc, beam_groups)
            if cross_quant:
                out, probs = quantized_attention(
                    qc, cache.cross_k[li], cache.cross_v[li],
                    cache.cross_k_scale[li], cache.cross_v_scale[li])
            else:
                out, probs = attention(qc, cache.cross_k[li],
                                       cache.cross_v[li])
            if beam_groups > 1:
                out = _unbeam_rows(out, beam_groups, s)
                probs = _unbeam_rows(probs, beam_groups, s)
            if slots:
                aligned[:, slots] = probs[:, src]
        x = x + dense(_merge_heads(out.to(x.dtype)), lp["cross"]["o"])

        x = x + mlp_block(layer_norm(x, lp["ln3"]), lp["mlp"])

    if shard is not None and align_sel is not None:
        # each slot was written by the one rank that holds its head: the
        # sum over the model group is exact
        dist.all_reduce(aligned, group=shard.group)
    x = layer_norm(x, dec["ln"])
    # weight-tied LM head, accumulated and returned in f32
    logits = torch.matmul(x.float(), dec["tok_emb"].float().T)
    return logits, cache, aligned


def decode_step_multi(params: Params, arch: WhisperArch,
                      tokens: torch.Tensor, position: int | torch.Tensor,
                      cache: DecoderCache,
                      align_sel: np.ndarray | None = None,
                      key_mask: torch.Tensor | None = None,
                      pos_offset: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, DecoderCache, torch.Tensor]:
    """S-token incremental step (block prefill, or the verify block of
    speculative decoding) at positions [position, position + S).
    ``position`` is an int, or an int32 [B] tensor of per-row positions
    (the reference's vector form, whisper.py:653-728): row b's block then
    lands at ring slots [position[b], position[b] + S). Writes the S new
    K/V rows into the self cache (quantized per column over Dh when the
    ring is), attends causally (query i of row b to slots <=
    position[b] + i) over the live prefix only, up to the largest
    position + S (the semantics of the reference's staged_ring_quantum=0:
    its masked slots contribute exact zeros) and captures the alignment
    heads' cross-attention. Activations take the ring's dtype, or the
    token embedding's when the ring is quantized.

    key_mask: bool [B, cache_len], the slots each row may attend to (False
      on the left pads of a conditioned prompt); masked scores are -1e9,
      so a query whose every slot is masked gets a uniform row, as in the
      reference, not NaN.
    pos_offset: int32 [B], subtracted from the positions for the learned
      position lookup only, clamped at 0 (the dynamic condition-on-prev
      mode: real tokens take positions 0..len-1 whatever the padding).

    Returns (logits [B, S, vocab] f32, cache, align_probs [B, A, S, K]
    f32 — zeros when align_sel is None)."""
    return _decode_block(params, arch, tokens, position, cache, align_sel,
                         key_mask, pos_offset, 1, True)


def decode_step(params: Params, arch: WhisperArch, tokens: torch.Tensor,
                position: int | torch.Tensor, cache: DecoderCache,
                align_sel: np.ndarray | None = None,
                key_mask: torch.Tensor | None = None,
                pos_offset: torch.Tensor | None = None,
                beam_groups: int = 1
                ) -> tuple[torch.Tensor, DecoderCache, torch.Tensor]:
    """One incremental decoder step: tokens [B] at ``position`` (an int,
    or an int32 [B] tensor of per-row positions); key_mask and pos_offset
    as in ``decode_step_multi``, except that the shifted position is not
    clamped (callers keep it >= 0, whisper.py:394-403).

    beam_groups: NB > 1 when the B rows are NB consecutive beams per item
      and the cross cache holds one copy per item ([L, B/NB, ...]): the
      beams ride the item's cross attention as extra query rows.

    Returns (logits [B, vocab] f32, cache, align_probs [B, A, K] f32)."""
    logits, cache, aligned = _decode_block(
        params, arch, tokens[:, None], position, cache, align_sel, key_mask,
        pos_offset, beam_groups, False)
    return logits[:, 0], cache, aligned[:, :, 0]


# ---------------------------------------------------------------------------
# Full-sequence (teacher-forced) decoder and the auxiliary heads
# ---------------------------------------------------------------------------


def _decoder_sequence(params: Params, arch: WhisperArch, ids,
                      encoder_out: torch.Tensor | None,
                      dtype: torch.dtype) -> torch.Tensor:
    """The decoder over whole sequences ids [B, T] in ``dtype``, causally
    masked, with cross K/V projected from ``encoder_out`` in every layer
    (no cross sublayer when it is None); the tied LM head in f32."""
    dec = params["decoder"]
    dh = arch.head_dim
    scale = dh ** -0.5
    dev = dec["tok_emb"].device
    ids = torch.as_tensor(ids, device=dev).long()
    t = ids.shape[-1]
    x = dec["tok_emb"][ids].to(dtype) + dec["pos_emb"][:t].to(dtype)
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    for lp in dec["layers"]:
        q, k, v = _self_qkv(layer_norm(x, lp["ln1"]), lp["self"], dh, scale)
        out, _ = attention(q, k, v, causal)
        x = x + dense(_merge_heads(out), lp["self"]["o"])
        if encoder_out is not None:
            y = layer_norm(x, lp["ln2"])
            out, _ = attention(
                _split_heads(dense(y, lp["cross"]["q"]) * scale, dh),
                _split_heads(dense(encoder_out, lp["cross"]["k"]), dh),
                _split_heads(dense(encoder_out, lp["cross"]["v"]), dh))
            x = x + dense(_merge_heads(out), lp["cross"]["o"])
        x = x + mlp_block(layer_norm(x, lp["ln3"]), lp["mlp"])
    x = layer_norm(x, dec["ln"])
    return torch.matmul(x.float(), dec["tok_emb"].to(dtype).float().T)


@torch.inference_mode()
def decoder_forward(params: Params, arch: WhisperArch, decoder_input_ids,
                    encoder_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced full-sequence decoder (reference whisper.py:844):
    ids [B, T] -> logits [B, T, vocab] f32, activations in the encoder
    states' dtype. Plain, fused-q/k/v and quantized weight trees alike."""
    return _decoder_sequence(params, arch, decoder_input_ids, encoder_out,
                             encoder_out.dtype)


def forward(params: Params, arch: WhisperArch, input_features: torch.Tensor,
            decoder_input_ids) -> torch.Tensor:
    """``encode`` then ``decoder_forward``: log-mel [B, n_mels, 3000] and
    ids [B, T] -> logits [B, T, vocab] f32."""
    return decoder_forward(params, arch, decoder_input_ids,
                           encode(params, arch, input_features))


@torch.inference_mode()
def causal_lm_forward(params: Params, arch: WhisperArch, input_ids,
                      encoder_out: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """WhisperForCausalLM's forward (modeling_whisper.py:1359): the decoder
    alone as an LM. With ``encoder_out`` it is ``decoder_forward``; without
    it the cross sublayer is skipped and the activations take the token
    embedding's dtype (reference whisper.py:893-924)."""
    if encoder_out is not None:
        return decoder_forward(params, arch, input_ids, encoder_out)
    return _decoder_sequence(params, arch, input_ids, None,
                             params["decoder"]["tok_emb"].dtype)


@torch.inference_mode()
def audio_classification_forward(params: Params, arch: WhisperArch,
                                 input_features: torch.Tensor,
                                 head: Params) -> torch.Tensor:
    """WhisperForAudioClassification's forward (modeling_whisper.py:1500):
    the encoder, then the projector, the mean over time and the
    classifier, those three in f32 -> logits [B, num_labels] f32.
    ``head`` = {"projector": {w, b}, "classifier": {w, b}}, [d_out, d_in]
    weights (``init_classification_head``,
    loader.classification_head_from_state_dict)."""
    f32 = {name: {k: v.float() for k, v in p.items()}
           for name, p in head.items()}
    states = encode(params, arch, input_features).float()
    pooled = dense(states, f32["projector"]).mean(dim=1)
    return dense(pooled, f32["classifier"])


def init_classification_head(arch: WhisperArch, num_labels: int,
                             generator: torch.Generator,
                             classifier_proj_size: int = 256,
                             dtype: torch.dtype = torch.float32,
                             device: torch.device | str | None = None
                             ) -> Params:
    """A random classification head (weights N(0, 0.02), zero biases) in
    the port's [d_out, d_in] layout, on ``device`` ("cuda" unless the
    caller names one); ``generator`` must live there."""
    dev = resolve_device(device, "init_classification_head")

    def lin(d_in, d_out):
        w = torch.randn((d_out, d_in), generator=generator, device=dev)
        return {"w": (w * 0.02).to(dtype),
                "b": torch.zeros((d_out,), dtype=dtype, device=dev)}

    return {"projector": lin(arch.d_model, classifier_proj_size),
            "classifier": lin(classifier_proj_size, num_labels)}


# ---------------------------------------------------------------------------
# Initialization (random weights for tests and benches)
# ---------------------------------------------------------------------------


def init_params(arch: WhisperArch, generator: torch.Generator,
                device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float32) -> Params:
    """Random weights with the reference's init distributions (whisper.py
    :962-1021): N(0, 0.02) dense/conv/embedding weights, zero biases, unit
    LayerNorms, sinusoid encoder positions. ``generator`` must live on
    ``device``."""
    std = 0.02
    d = arch.d_model

    def normal(*shape):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * std).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def lin(din, dout, bias=True):
        p = {"w": normal(dout, din)}
        if bias:
            p["b"] = zeros(dout)
        return p

    def ln(n):
        return {"scale": torch.ones((n,), dtype=torch.float32, device=device),
                "bias": torch.zeros((n,), dtype=torch.float32,
                                    device=device)}

    def attn_params():
        return {"q": lin(d, d), "k": lin(d, d, bias=False), "v": lin(d, d),
                "o": lin(d, d)}

    return {
        "encoder": {
            "conv1": {"w": normal(d, arch.num_mel_bins, 3), "b": zeros(d)},
            "conv2": {"w": normal(d, d, 3), "b": zeros(d)},
            "pos": torch.from_numpy(sinusoids(arch.max_source_positions, d)
                                    ).to(device=device, dtype=dtype),
            "layers": [{"ln1": ln(d), "attn": attn_params(), "ln2": ln(d),
                        "mlp": {"fc1": lin(d, arch.encoder_ffn_dim),
                                "fc2": lin(arch.encoder_ffn_dim, d)}}
                       for _ in range(arch.encoder_layers)],
            "ln_post": ln(d),
        },
        "decoder": {
            "tok_emb": normal(arch.vocab_size, d),
            "pos_emb": normal(arch.max_target_positions, d),
            "layers": [{"ln1": ln(d), "self": attn_params(), "ln2": ln(d),
                        "cross": attn_params(), "ln3": ln(d),
                        "mlp": {"fc1": lin(d, arch.decoder_ffn_dim),
                                "fc2": lin(arch.decoder_ffn_dim, d)}}
                       for _ in range(arch.decoder_layers)],
            "ln": ln(d),
        },
    }
