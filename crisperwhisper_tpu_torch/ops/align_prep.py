"""Alignment prep: the hand-written Triton kernel and its plain twin.

Port of crisperwhisper_tpu/ops/pallas_align.py (fused_align_prep):
[B, A, T, K] alignment-head probabilities -> [B, T, K] f32 DTW cost =
the negated head mean of the frame-axis median (any odd width) of the
token-axis z-norm.

Unlike the TPU kernel, this one takes a per-row ``n_frames``: frames >=
n_frames are zeroed before the statistics and the median reflects at
n_frames - 1 (ops/alignment.py does the same), so full and cropped rows
share one call. ``align_prep`` launches the Triton kernel
(ops/_align_prep_triton.py, imported only when it launches) for CUDA
tensors and runs ``align_prep_plain`` only for CPU tensors.
"""

from __future__ import annotations

import torch

from .alignment import median_filter, znorm_tokens


def align_prep_plain(weights: torch.Tensor, n_tokens: torch.Tensor,
                     n_frames: torch.Tensor, width: int = 7) -> torch.Tensor:
    """The plain chain: zero frames >= n_frames, z-norm over the first
    n_tokens rows, median over frames reflecting at n_frames - 1, negated
    mean over heads."""
    b, a, t, m = weights.shape
    dev = weights.device
    n_tokens = n_tokens.to(device=dev, dtype=torch.long)
    n_frames = n_frames.to(device=dev, dtype=torch.long)
    frame_mask = torch.arange(m, device=dev)[None, :] < n_frames[:, None]
    token_mask = torch.arange(t, device=dev)[None, :] < n_tokens[:, None]
    w = torch.where(frame_mask[:, None, None, :], weights.float(), 0.0)
    z = znorm_tokens(w, token_mask[:, None, :].expand(b, a, t))
    z = median_filter(z, width, n_frames.view(b, 1, 1))
    return -z.mean(dim=1)


def align_prep(weights: torch.Tensor, n_tokens: torch.Tensor,
               n_frames: torch.Tensor, width: int = 7) -> torch.Tensor:
    """[B, A, T, K] f32 + n_tokens, n_frames [B] int32 -> [B, T, K] f32."""
    if weights.device.type == "cpu":
        return align_prep_plain(weights, n_tokens, n_frames, width)
    if weights.device.type != "cuda":
        raise ValueError(f"align_prep: unsupported device {weights.device}")
    if weights.dtype != torch.float32 or weights.dim() != 4 \
            or not weights.is_contiguous():
        raise ValueError("align_prep: weights must be a contiguous float32 "
                         f"[B, A, T, K] tensor, got {weights.dtype} "
                         f"{tuple(weights.shape)}")
    b, a, t, k = weights.shape
    for name, x in (("n_tokens", n_tokens), ("n_frames", n_frames)):
        if x.device != weights.device or x.dtype != torch.int32 \
                or x.shape != (b,) or not x.is_contiguous():
            raise ValueError(f"align_prep: {name} must be a contiguous int32 "
                             f"[{b}] tensor on {weights.device}")
    if width <= 0 or width % 2 != 1:
        raise ValueError("`width` should be an odd positive number")
    if min(b, a, t, k) == 0 or k <= width // 2:
        raise ValueError(f"align_prep: unsupported shape "
                         f"{tuple(weights.shape)}")
    from . import _align_prep_triton

    out = torch.empty((b, t, k), dtype=torch.float32, device=weights.device)
    mean = torch.empty((b, a, k), dtype=torch.float32, device=weights.device)
    den = torch.empty_like(mean)
    with torch.cuda.device(weights.device):
        _align_prep_triton.launch(weights, n_tokens, n_frames, mean, den, out,
                                  width)
    align_prep.launches += 1
    return out


align_prep.launches = 0
