"""Whole-step quantized decoder: one kernel per decode step, all layers.

Port of crisperwhisper_tpu/ops/pallas_decode_b1.py for the four modes the
greedy, speculative and beam loops reach: ``decode_step_b1`` (one stream),
``decode_step_rows`` (2-8 distinct streams at one shared position),
``decode_step_b1_multi`` (the speculative verify block: S <= 8 consecutive
tokens of one stream) and ``decode_step_b1_beams`` (2-8 beams of one item
at one shared position: per-beam rings, one shared cross cache). All run
``whole_step``, which launches ``csrc/decode_step.cu`` for CUDA tensors
and runs ``whole_step_plain`` only for CPU tensors.

The gated configuration (``supported``/``supported_rows``/
``supported_multi``/``supported_beams``) is the
reference's: fused-QKV int8 decoder weights (models/quantize.py), an int8
self ring with bf16 per-position scales, an int8 or packed-int4 cross
cache, a scalar position, no key mask, no beam grouping (beams take their
own mode). On top of that
the CUDA kernel's own shape limits (``_kernel_takes``) take the place of
the reference's TPU-only ``_mosaic_aligned``: a shape the kernel does not
take fails the gate, so the decode loops take models/whisper.decode_step
as the reference's gate would; it never fails at the launch.

Numerics of one step (the reference kernel's, pallas_decode_b1.py
:162-556): an f32 residual stream from x0 = tok_emb[tok] + pos_emb[pos];
LayerNorms in f32 with eps 1e-5; each dense as (x · W_int8) * scale +
bias in f32, the cross-q scale and bias times head_dim**-0.5; the fresh
K/V column quantized over Dh from the f32 scale, rounded half-to-even,
its scale stored and used as bf16, written into the ring at ``position``
before the self attention reads slots [0, position] (in the multi mode all
S columns at [position, position + S) before row i reads slots [0,
position + i], as the reference's fresh scores do, pallas_decode_b1.py
:356-378); softmax in f32; P
times the per-position V scale before P·V; exact erf GELU. The alignment
capture takes each alignment head's cross probabilities, rounded to bf16
only when ``align_dtype`` is bf16. The final LayerNorm and the tied LM
head stay outside the kernel (``_lm_head``), as in the reference.

The plain version and the JAX kernel are the same f32 algebra summed in
other orders, so they agree to a few f32 ulps per op, and a fresh column
may differ by one int8 step where a value falls near a rounding boundary
(tests/test_torch_decode_step.py holds the bands).
"""

from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..config import WhisperArch
from ..parallel.mesh import REDUCE

from .. import _build
from ..models.whisper import (DecoderCache, _quantize, cache_values,
                              layer_norm)

MAX_ROWS = 8                     # rows of one step (the reference's cap)
MODES = ("b1", "rows", "multi", "beams")
SMEM_LIMIT = 232448 - 1920       # dynamic shared memory a block may use:
                                 # the card's 232448 less the kernel's static
THREADS = 384                    # threads of a kernel block
SPLIT = 128                      # cross keys of one kernel item (kSplit)
MAX_SPLITS = 16                  # splits of a (row, head): K <= 2048
ATTN_WARPS = 8                   # self-attention row warps a block holds
PHASES = ("LN1+QKV", "self", "o", "LN2+cross-q", "cross", "combine+cross-o",
          "LN3+fc1", "fc2")      # the kernel's phases, one barrier each
_HEAD_DIMS = (16, 32, 64)
_W_NAMES = (("self", "qkv"), ("self", "o"), ("cross", "q"), ("cross", "o"),
            ("mlp", "fc1"), ("mlp", "fc2"))


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------


def _smem_bytes(m: int, arch: WhisperArch, t_ring: int) -> int:
    """Dynamic shared memory of one kernel block (decode_step.cu
    ``smem_bytes``): the largest of the GEMV input rows with, after them,
    the cross combine's (max, sum) per (row, head) or a LayerNorm's gain
    and shift; the self-attention row warps' queries, 64 staged V rows
    and scores; two cross items' queries, scores, V scales, P·V partials
    and V rows (up to M streams of Dh bytes a row)."""
    d, f, h, dh = (arch.d_model, arch.decoder_ffn_dim,
                   arch.decoder_attention_heads, arch.head_dim)
    return max(4 * (m * max(d, f) + max(2 * m * h, 2 * d)),
               4 * ATTN_WARPS * (1088 + -(-t_ring // 4) * 4),
               2 * (4 * (m * (64 + 2 * SPLIT) + 4 * THREADS // 2)
                    + m * SPLIT * dh))


def _kernel_takes(arch: WhisperArch, cache: DecoderCache, m: int) -> bool:
    """The CUDA kernel's shape limits: 16-byte weight rows, a head dim
    its attention loops take, at most MAX_SPLITS splits of the cross keys
    and shared memory within one block."""
    return (arch.head_dim in _HEAD_DIMS
            and cache.cross_k.shape[3] <= SPLIT * MAX_SPLITS
            and arch.d_model == arch.decoder_attention_heads * arch.head_dim
            and arch.d_model % 16 == 0 and arch.decoder_ffn_dim % 16 == 0
            and _smem_bytes(m, arch, cache.self_k.shape[3]) <= SMEM_LIMIT)


def _scalar(position) -> bool:
    return isinstance(position, int) or (
        isinstance(position, torch.Tensor) and position.dim() == 0)


def _quantized(params: Any, cache: DecoderCache) -> bool:
    """Fused int8 weights on one rank: a tree sharded over a mesh
    (parallel/mesh.py) keeps q/k/v unfused, and its row-parallel denses
    sum over ranks, which one launch cannot."""
    lay = params["decoder"]["layers"][0]
    return ("qkv" in lay["self"] and "w_q" in lay["self"]["qkv"]
            and REDUCE not in lay["self"]["o"]
            and "w_q" in lay["mlp"]["fc1"]
            and cache.self_k_scale is not None
            and cache.self_k.dtype == torch.int8
            and cache.cross_k_scale is not None
            and cache.cross_k.dtype in (torch.int8, torch.uint8))


def supported(params: Any, arch: WhisperArch, cache: DecoderCache,
              key_mask, beam_groups: int, position, tokens) -> bool:
    """The batch-1 gate (pallas_decode_b1.py:710-726)."""
    return (tokens.shape[0] == 1 and _scalar(position) and key_mask is None
            and beam_groups == 1 and _quantized(params, cache)
            and _kernel_takes(arch, cache, 1))


def supported_rows(params: Any, arch: WhisperArch, cache: DecoderCache,
                   key_mask, position, tokens) -> bool:
    """The multi-stream gate (pallas_decode_b1.py:957-978): 2..8 distinct
    streams, each with its own ring and cross cache."""
    r = tokens.shape[0]
    return (tokens.dim() == 1 and 1 < r <= MAX_ROWS and _scalar(position)
            and key_mask is None and _quantized(params, cache)
            and cache.self_k.shape[1] == r and cache.cross_k.shape[1] == r
            and _kernel_takes(arch, cache, r))


def supported_multi(params: Any, arch: WhisperArch, cache: DecoderCache,
                    key_mask, position, tokens) -> bool:
    """The verify-block gate: ``supported`` for tokens [1, S] with 1 <= S
    <= MAX_ROWS, the S slots [position, position + S) inside the ring and
    the kernel's shape limits at M = S."""
    if tokens.dim() != 2 or not _scalar(position):
        return False
    s = tokens.shape[1]
    return (supported(params, arch, cache, key_mask, 1, position, tokens)
            and 1 <= s <= MAX_ROWS and cache.self_k.shape[1] == 1
            and cache.cross_k.shape[1] == 1
            and int(position) + s <= cache.self_k.shape[3]
            and _kernel_takes(arch, cache, s))


def supported_beams(params: Any, arch: WhisperArch, cache: DecoderCache,
                    key_mask, position, tokens) -> bool:
    """The beam-rows gate (pallas_decode_b1.py:935-954): 2..8 beams of one
    item at a shared scalar position, each with its own int8 ring, all
    reading one quantized cross cache of batch 1."""
    r = tokens.shape[0]
    return (tokens.dim() == 1 and 1 < r <= MAX_ROWS and _scalar(position)
            and key_mask is None and _quantized(params, cache)
            and cache.self_k.shape[1] == r and cache.cross_k.shape[1] == 1
            and _kernel_takes(arch, cache, r))


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _ln(x: torch.Tensor, p: dict) -> torch.Tensor:
    """LayerNorm on the f32 residual (pallas_decode_b1.py:213-221)."""
    mean = x.mean(-1, keepdim=True)
    zc = x - mean
    var = (zc * zc).mean(-1, keepdim=True)
    return zc * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]


def _gemv(y: torch.Tensor, p: dict, extra: float | None = None
          ) -> torch.Tensor:
    """(y · W_int8ᵀ) * scale + bias, all f32; ``extra`` multiplies both
    scale and bias (the cross-q factor head_dim**-0.5)."""
    acc = y @ p["w_q"].float().T
    s = p["w_scale"].float()
    b = p["b"].float() if "b" in p else torch.zeros_like(s)
    if extra is not None:
        s, b = s * extra, b * extra
    return acc * s + b


def whole_step_plain(params: Any, arch: WhisperArch, x0: torch.Tensor,
                     position: int, cache: DecoderCache,
                     heads: tuple[tuple[int, int] | None, ...],
                     align_bf16: bool = False, multi: bool = False,
                     beams: bool = False, fresh: tuple | None = None,
                     own: list | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algebra in plain PyTorch. x0 [M, d] f32: row m is
    stream m of the rings and cross caches, or with ``multi`` the token at
    position + m of the one stream (rings and cross caches of batch 1),
    or with ``beams`` beam m of one item (ring m, the one cross cache of
    batch 1); ``heads`` names the (layer, head) of each alignment slot
    (None: no source). Writes each layer's fresh K/V columns into the ring at
    ``position`` (M of them with ``multi``) in place and returns (hid [M,
    d] f32 — the residual stream after the last layer, align [M, A, K]
    f32). ``fresh`` = (K, V, K scales, V scales), each [L, M, H(, Dh)]
    with row m's column of layer l at [l, m] (``fresh_columns``), takes the
    place of the step's own quantization of the fresh columns: fed another
    side's columns, the step shows what that side computed from them.
    ``own``, a list, takes the step's own K and V columns of each layer
    in turn, quantized before any feeding: (int8 [M, H, Dh], bf16 scales
    [M, H]) each."""
    m, d = x0.shape
    h, dh = arch.decoder_attention_heads, arch.head_dim
    live = position + (m if multi else 1)
    if multi:             # row i attends to slots <= position + i
        causal = (torch.arange(live, device=x0.device)[None, None, :]
                  <= position
                  + torch.arange(m, device=x0.device)[:, None, None])

    def rows(x, shared=multi):  # [R, ...] per-stream slice -> [M, ...]
        return x.expand(m, *x.shape[1:]) if shared else x

    def cross(x):         # the cross cache is shared by multi and beams
        return rows(x, multi or beams)
    align = torch.zeros((m, len(heads), cache.cross_k.shape[3]),
                        dtype=torch.float32, device=x0.device)
    xr = x0.float()
    for li, lp in enumerate(params["decoder"]["layers"]):
        qkv = _gemv(_ln(xr, lp["ln1"]), lp["self"]["qkv"])
        q, k, v = (qkv[:, i * d:(i + 1) * d].reshape(m, h, dh)
                   for i in range(3))
        for i, (x, ring, scales) in enumerate((
                (k, cache.self_k, cache.self_k_scale),
                (v, cache.self_v, cache.self_v_scale))):
            qv, sc = _quantize(x, 127.0)
            if own is not None:
                own.append((qv, sc))
            if fresh is not None:
                qv, sc = fresh[i][li], fresh[2 + i][li]
            if multi:
                ring[li, 0, :, position:live] = qv.transpose(0, 1)
                scales[li, 0, :, position:live] = sc.T
            else:
                ring[li, :, :, position] = qv
                scales[li, :, :, position] = sc
        sk = torch.einsum("mhd,mhtd->mht", q,
                          rows(cache.self_k[li, :, :, :live]).float()) \
            * rows(cache.self_k_scale[li, :, :, :live]).float()
        if multi:
            sk = sk.masked_fill(~causal, float("-inf"))
        p = torch.softmax(sk, dim=-1) \
            * rows(cache.self_v_scale[li, :, :, :live]).float()
        out = torch.einsum("mht,mhtd->mhd", p,
                           rows(cache.self_v[li, :, :, :live]).float())
        xr = xr + _gemv(out.reshape(m, d), lp["self"]["o"])

        qc = _gemv(_ln(xr, lp["ln2"]), lp["cross"]["q"],
                   extra=dh ** -0.5).reshape(m, h, dh)
        sk = torch.einsum("mhd,mhkd->mhk", qc,
                          cross(cache_values(cache.cross_k[li])).float()) \
            * cross(cache.cross_k_scale[li]).float()
        p = torch.softmax(sk, dim=-1)
        for a, src in enumerate(heads):
            if src is not None and src[0] == li:
                row = p[:, src[1]]
                align[:, a] = (row.to(torch.bfloat16).float() if align_bf16
                               else row)
        pv = p * cross(cache.cross_v_scale[li]).float()
        out = torch.einsum("mhk,mhkd->mhd", pv,
                           cross(cache_values(cache.cross_v[li])).float())
        xr = xr + _gemv(out.reshape(m, d), lp["cross"]["o"])

        hmid = F.gelu(_gemv(_ln(xr, lp["ln3"]), lp["mlp"]["fc1"]))
        xr = xr + _gemv(hmid, lp["mlp"]["fc2"])
    return xr, align


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------


@dataclass
class _Operands:
    """Per-parameter-tree operands of the kernel, built once: the int8
    weight pointers [L * 6] (qkv, o, cross q, cross o, fc1, fc2) and one
    f32 row per layer of scales, biases and LayerNorm parameters."""
    ptrs: torch.Tensor
    vec: torch.Tensor
    owner: weakref.ref


_OPERANDS: dict[int, _Operands] = {}


def _vec_row(lp: dict) -> torch.Tensor:
    """One layer's f32 vector table in the kernel's order (decode_step.cu
    ``Vec``): qkv s/b, o s/b, cross q s/b, cross o s/b, fc2 s/b, ln1-3
    scale/bias (d wide each but qkv's 3d), then fc1 s/b (f wide)."""
    def sb(p):
        s = p["w_scale"].float()
        return [s, p["b"].float() if "b" in p else torch.zeros_like(s)]
    parts = (sb(lp["self"]["qkv"]) + sb(lp["self"]["o"])
             + sb(lp["cross"]["q"]) + sb(lp["cross"]["o"])
             + sb(lp["mlp"]["fc2"])
             + [lp[n][k].float() for n in ("ln1", "ln2", "ln3")
                for k in ("scale", "bias")]
             + sb(lp["mlp"]["fc1"]))
    return torch.cat(parts)


def _operands(params: Any, arch: WhisperArch, device) -> _Operands:
    layers = params["decoder"]["layers"]
    owner = layers[0]["self"]["qkv"]["w_q"]
    key = (id(owner), len(layers))  # a self-draft shares the first layers
    ops = _OPERANDS.get(key)
    if ops is not None and ops.owner() is owner:
        return ops
    d, f = arch.d_model, arch.decoder_ffn_dim
    shapes = ((3 * d, d), (d, d), (d, d), (d, d), (f, d), (d, f))
    ptrs = []
    for lp in layers:
        for (group, name), shape in zip(_W_NAMES, shapes):
            w = lp[group][name]["w_q"]
            if (w.dtype != torch.int8 or tuple(w.shape) != shape
                    or not w.is_contiguous() or w.device != device):
                raise ValueError(f"whole_step: {group}.{name} weights must "
                                 f"be contiguous int8 {list(shape)} on "
                                 f"{device}")
            ptrs.append(w.data_ptr())
    vec = torch.stack([_vec_row(lp) for lp in layers]).to(device)
    for k in [k for k, v in _OPERANDS.items() if v.owner() is None]:
        del _OPERANDS[k]
    ops = _Operands(ptrs=torch.tensor(ptrs, dtype=torch.int64,
                                      device=device),
                    vec=vec.contiguous(), owner=weakref.ref(owner))
    _OPERANDS[key] = ops
    return ops


@functools.lru_cache(maxsize=16)
def _align_table(heads: tuple, device: str) -> torch.Tensor:
    flat = [x for src in heads for x in (src if src is not None
                                         else (-1, -1))]
    return torch.tensor(flat, dtype=torch.int32, device=device)


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           shape: tuple, device) -> None:
    if (x.device != device or x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(f"whole_step: {name} must be a contiguous "
                         f"{dtype} {list(shape)} tensor on {device}, got "
                         f"{x.dtype} {list(x.shape)} on {x.device}"
                         f"{'' if x.is_contiguous() else ' (strided)'}")


def whole_step(params: Any, arch: WhisperArch, x0: torch.Tensor,
               position: int, cache: DecoderCache,
               heads: tuple[tuple[int, int] | None, ...],
               align_bf16: bool = False, multi: bool = False,
               beams: bool = False, stamps: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``whole_step_plain``'s contract. CUDA tensors launch the kernel
    (csrc/decode_step.cu) once, counted in ``launches`` and by mode in
    ``mode_launches``; CPU tensors take the plain version. ``stamps``, an
    int64 [8 L + 1] tensor on the card, takes the kernel's %globaltimer
    at its start and after each of its 8 L grid barriers (``PHASES``
    names a layer's eight)."""
    if x0.device.type == "cpu":
        return whole_step_plain(params, arch, x0, position, cache, heads,
                                align_bf16, multi, beams)
    if x0.device.type != "cuda":
        raise ValueError(f"whole_step: unsupported device {x0.device}")
    dev = x0.device
    n_layers, h, dh = (arch.decoder_layers, arch.decoder_attention_heads,
                       arch.head_dim)
    d, f = arch.d_model, arch.decoder_ffn_dim
    m = x0.shape[0]
    t_ring, k_enc = cache.self_k.shape[3], cache.cross_k.shape[3]
    cross_int4 = cache.cross_k.dtype == torch.uint8
    if not 1 <= m <= MAX_ROWS or not _kernel_takes(arch, cache, m):
        raise ValueError(f"whole_step: unsupported shape (rows {m}, head "
                         f"dim {dh}, d {d}, ffn {f})")
    n_new = m if multi else 1
    if not 0 <= position <= t_ring - n_new:
        raise ValueError(f"whole_step: slots [{position}, {position + n_new})"
                         f" outside the ring of {t_ring}")
    if multi and beams:
        raise ValueError("whole_step: multi and beams are two modes")
    _check("x0", x0, torch.float32, (m, d), dev)
    shared_cross = multi or beams
    ring = (n_layers, 1 if multi else m, h, t_ring)
    cross = (n_layers, 1 if shared_cross else m, h, k_enc)
    for name in ("self_k", "self_v"):
        _check(name, getattr(cache, name), torch.int8, ring + (dh,), dev)
    for name in ("self_k_scale", "self_v_scale"):
        _check(name, getattr(cache, name), torch.bfloat16, ring, dev)
    for name in ("cross_k", "cross_v"):
        _check(name, getattr(cache, name),
               torch.uint8 if cross_int4 else torch.int8,
               cross + (dh // 2 if cross_int4 else dh,), dev)
    for name in ("cross_k_scale", "cross_v_scale"):
        _check(name, getattr(cache, name), torch.bfloat16, cross, dev)
    ops = _operands(params, arch, dev)
    table = _align_table(tuple(heads), str(dev))
    hid = x0.clone()
    align = torch.zeros((m, len(heads), k_enc), dtype=torch.float32,
                        device=dev)
    if stamps is not None:
        _check("stamps", stamps, torch.int64, (8 * n_layers + 1,), dev)
    n_split = -(-k_enc // SPLIT)
    scratch = torch.empty((m * (5 * d + f) + m * h * n_split * (dh + 2),),
                          dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _build.kernels().lib.cw_decode_step(
            ops.ptrs.data_ptr(), ops.vec.data_ptr(), hid.data_ptr(),
            scratch.data_ptr(), cache.self_k.data_ptr(),
            cache.self_v.data_ptr(), cache.self_k_scale.data_ptr(),
            cache.self_v_scale.data_ptr(), cache.cross_k.data_ptr(),
            cache.cross_v.data_ptr(), cache.cross_k_scale.data_ptr(),
            cache.cross_v_scale.data_ptr(), table.data_ptr(),
            align.data_ptr(), m, n_layers, d, f, h, dh, t_ring, position,
            k_enc, len(heads), int(cross_int4), int(align_bf16), int(multi),
            int(shared_cross), dh ** -0.5,
            0 if stamps is None else stamps.data_ptr(), stream)
    _build.check(err, "whole_step")
    whole_step.launches += 1
    whole_step.mode_launches["multi" if multi else "beams" if beams else
                             "b1" if m == 1 else "rows"] += 1
    return hid, align


whole_step.launches = 0
whole_step.mode_launches = dict.fromkeys(MODES, 0)


# ---------------------------------------------------------------------------
# The step functions (the reference's signatures and return shapes)
# ---------------------------------------------------------------------------


def _heads(align_sel: np.ndarray | None) -> tuple:
    """The (layer, head) source of each alignment slot of a one-hot
    [L, H, A] selector; one empty slot without a selector."""
    if align_sel is None:
        return (None,)
    sel = np.asarray(align_sel)
    out = []
    for a in range(sel.shape[-1]):
        src = np.argwhere(sel[:, :, a] != 0)
        out.append((int(src[0, 0]), int(src[0, 1])) if len(src) else None)
    return tuple(out)


def _lm_head(dec: dict, hid: torch.Tensor) -> torch.Tensor:
    """Final LN on hid rounded to the activation dtype, then the tied LM
    head in f32 (pallas_decode_b1.py:827-834): [M, d] -> [M, V]."""
    x = layer_norm(hid.to(dec["tok_emb"].dtype), dec["ln"])
    return torch.matmul(x.float(), dec["tok_emb"].float().T)


def _step(params, arch, tokens, position, cache, align_sel, align_dtype,
          beams=False):
    dec = params["decoder"]
    position = int(position)
    x0 = (dec["tok_emb"][tokens].float()
          + dec["pos_emb"][position][None].float())              # [M, d]
    hid, align = whole_step(params, arch, x0, position, cache,
                            _heads(align_sel),
                            align_bf16=align_dtype == torch.bfloat16,
                            beams=beams)
    return _lm_head(dec, hid), cache, align


@torch.inference_mode()
def decode_step_b1(params: Any, arch: WhisperArch, tokens: torch.Tensor,
                   position: int, cache: DecoderCache,
                   align_sel: np.ndarray | None = None,
                   align_dtype: torch.dtype = torch.float32
                   ) -> tuple[torch.Tensor, DecoderCache, torch.Tensor]:
    """models/whisper.decode_step at batch 1 in the gated configuration
    (``supported``). The ring takes the fresh column in place. Returns
    (logits [1, V] f32, cache, align_probs [1, A, K] f32)."""
    return _step(params, arch, tokens, position, cache, align_sel,
                 align_dtype)


@torch.inference_mode()
def decode_step_rows(params: Any, arch: WhisperArch, tokens: torch.Tensor,
                     position: int, cache: DecoderCache,
                     align_sel: np.ndarray | None = None,
                     align_dtype: torch.dtype = torch.float32
                     ) -> tuple[torch.Tensor, DecoderCache, torch.Tensor]:
    """``decode_step_b1`` under the rows gate (``supported_rows``): 2..8
    distinct streams at one position, per-row rings and cross caches; the
    kernel takes the row count as M. Both modes share ``_step`` (calling
    ``decode_step_b1`` would count a rows step as a b1 step wherever the
    modes are counted). Returns (logits [R, V] f32, cache, align_probs
    [R, A, K] f32)."""
    return _step(params, arch, tokens, position, cache, align_sel,
                 align_dtype)


@torch.inference_mode()
def decode_step_b1_multi(params: Any, arch: WhisperArch,
                         tokens: torch.Tensor, position: int,
                         cache: DecoderCache,
                         align_sel: np.ndarray | None = None,
                         align_dtype: torch.dtype = torch.float32
                         ) -> tuple[torch.Tensor, DecoderCache,
                                    torch.Tensor]:
    """models/whisper.decode_step_multi at batch 1 in the gated
    configuration (``supported_multi``), the speculative verify block
    (pallas_decode_b1.py:882-932): tokens [1, S] at positions [position,
    position + S), causal among themselves; all S fresh K/V columns are
    quantized and written at ring slots [position, position + S). The LM
    head for the S rows stays a matmul outside the kernel. Returns (logits
    [1, S, V] f32, cache, align_probs [1, A, S, K] f32)."""
    dec = params["decoder"]
    position = int(position)
    s = tokens.shape[1]
    x0 = (dec["tok_emb"][tokens[0]].float()
          + dec["pos_emb"][position:position + s].float())      # [S, d]
    hid, align = whole_step(params, arch, x0, position, cache,
                            _heads(align_sel),
                            align_bf16=align_dtype == torch.bfloat16,
                            multi=True)
    return (_lm_head(dec, hid)[None], cache,
            align.transpose(0, 1)[None])


@torch.inference_mode()
def decode_step_b1_beams(params: Any, arch: WhisperArch,
                         tokens: torch.Tensor, position: int,
                         cache: DecoderCache,
                         align_sel: np.ndarray | None = None,
                         align_dtype: torch.dtype = torch.float32
                         ) -> tuple[torch.Tensor, DecoderCache,
                                    torch.Tensor]:
    """models/whisper.decode_step(beam_groups=R) at batch 1 in the gated
    configuration (``supported_beams``; pallas_decode_b1.py:981-994): R
    beams of one item advance at one shared position, each on its own
    ring, all reading the item's one cross cache. The rows mode's step
    with the cross cache shared. Returns (logits [R, V] f32, cache,
    align_probs [R, A, K] f32)."""
    return _step(params, arch, tokens, position, cache, align_sel,
                 align_dtype, beams=True)
