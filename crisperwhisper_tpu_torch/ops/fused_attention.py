"""Encoder self-attention: the hand-written CUDA kernels and their plain twin.

Port of crisperwhisper_tpu/ops/fused_attention.py. ``fused_attention``
launches ``csrc/encoder_attention.cu`` for CUDA tensors and runs
``attention_plain`` only for CPU tensors. Q arrives pre-scaled by
1/sqrt(Dh); the softmax runs in f32 (modeling_whisper.py:311-316).

The source holds two kernels, and ``route`` picks one by dtype and head
dim, before any launch:

- ``"tensor_cores"``: bfloat16 and float16 at head dim 16, 32 or 64 (every
  released Whisper size has 64): wgmma products fed by TMA, P rounded to
  the input's type for the second product as the reference does;
- ``"cuda_cores"``: float32 at head dim 16, 32 or 64, on the f32 CUDA
  cores (tensor cores would mean TF32, outside the reference's 2e-5 f32
  band).

Anything else raises; so does a failed launch. There is no fallback from
one route to the other or to the plain version. ``fused_attention.launches``
counts every launch and ``fused_attention.route_launches`` splits them
by route.
"""

from __future__ import annotations

import torch

from .. import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (16, 32, 64)
ROUTES = ("tensor_cores", "cuda_cores")


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call of this dtype and head dim launches:
    16-bit types take the tensor cores, float32 the CUDA cores. Raises
    TypeError for another dtype and ValueError for another head dim."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_attention: {dtype} is not taken; the "
                        "kernels take float32, bfloat16 or float16")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"fused_attention: head dim {head_dim} not in "
                         f"{_HEAD_DIMS}")
    return "cuda_cores" if dtype == torch.float32 else "tensor_cores"


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ) v over [..., H, T, Dh]: scores in f32 from the inputs
    (the reference's preferred_element_type=f32), probabilities cast to
    v's dtype for the second product, as models/whisper.attention does."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> str:
    """Raise on what the kernels do not take; return the route."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"fused_attention: {name} on {x.device}, "
                             f"q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"fused_attention: {name} is {x.dtype}, q is "
                            f"{q.dtype}; all three must be alike")
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"fused_attention: {name} must be a contiguous "
                             f"[B, H, T, Dh] tensor, got {tuple(x.shape)}")
        if x.data_ptr() % 16:
            raise ValueError(f"fused_attention: {name} is not 16-byte "
                             "aligned")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"fused_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[2] == 0 or k.shape[2] == 0 or b * h > 65535:
        raise ValueError(f"fused_attention: unsupported q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    return route(q.dtype, d)


def fused_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ) v for the encoder's unmasked self-attention.

    q: [B, H, Tq, Dh] pre-scaled; k, v: [B, H, Tk, Dh]. Returns q's shape
    and dtype. CPU tensors take ``attention_plain``; CUDA tensors launch
    the kernel of their ``route`` or raise."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    path = _check_cuda_inputs(q, k, v)
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    lib = _build.kernels().lib
    entry = lib.cw_encoder_attention_tc if path == "tensor_cores" \
        else lib.cw_encoder_attention
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b * h, tq, k.shape[2], d, _DTYPE_CODES[q.dtype], stream)
    _build.check(err, f"encoder attention ({path})")
    fused_attention.launches += 1
    fused_attention.route_launches[path] += 1
    return out


fused_attention.launches = 0
fused_attention.route_launches = dict.fromkeys(ROUTES, 0)
