"""Alignment prep: the hand-written CUDA kernel and its plain twin.

Port of crisperwhisper_tpu/ops/pallas_align.py (fused_align_prep):
[B, A, T, K] alignment-head probabilities -> [B, T, K] f32 DTW cost =
the negated head mean of the frame-axis median (any odd width) of the
token-axis z-norm.

Unlike the TPU kernel, this one takes a per-row ``n_frames``: frames >=
n_frames are zeroed before the statistics and the median reflects at
n_frames - 1 (ops/alignment.py does the same), so full and cropped rows
share one call. ``align_prep`` launches ``csrc/align_prep.cu`` (one
launch a call) for CUDA tensors and runs ``align_prep_plain`` only for CPU
tensors. The two agree within ``testing.PREP_BAND`` on the live cells
(token < n_tokens, frame < n_frames), the only cells the DTW reads; the
kernel writes 0 everywhere else.
"""

from __future__ import annotations

import torch

from .. import _build
from .alignment import median_filter, znorm_tokens

# mirrors of csrc/align_prep.cu's constants (a CPU test parses the source)
TILE = 32                # output frames a block
THREADS = 1024           # 32 warps a block
ROWS_PER_THREAD = 16     # token rows a thread at most
MAX_TOKENS = THREADS // 32 * ROWS_PER_THREAD   # 512
SMEM_LIMIT = 232448      # the H100's 227 KB of shared memory a block


def smem_bytes(t: int, width: int) -> int:
    """Dynamic shared memory of one block (csrc/align_prep.cu
    ``prep_smem``): two strips of T rows."""
    sw = (TILE + 2 * (width // 2) + 6 + 3) // 4 * 4
    return 2 * t * sw * 4


def plan(t: int, k: int, width: int) -> int:
    """Dynamic shared memory of one block for T token rows, K frames and
    an odd median ``width``; raises a ValueError for a shape the kernel
    does not take."""
    if width <= 0 or width % 2 != 1:
        raise ValueError("`width` should be an odd positive number")
    if min(t, k) <= 0 or k <= width // 2 or t > MAX_TOKENS:
        raise ValueError(f"align_prep: unsupported shape: {t} token rows "
                         f"(at most {MAX_TOKENS}), {k} frames, width "
                         f"{width}")
    need = smem_bytes(t, width)
    if need > SMEM_LIMIT:
        raise ValueError(f"align_prep: {t} token rows at width {width} need "
                         f"{need} bytes of shared memory, over the limit of "
                         f"{SMEM_LIMIT}")
    return need


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
    if min(b, a) == 0:
        raise ValueError(f"align_prep: unsupported shape "
                         f"{tuple(weights.shape)}")
    plan(t, k, width)
    out = torch.empty((b, t, k), dtype=torch.float32, device=weights.device)
    _build.launcher("cw_align_prep")(
        weights.get_device(), weights.data_ptr(), n_tokens.data_ptr(),
        n_frames.data_ptr(), out.data_ptr(), b, a, t, k, width)
    align_prep.launches += 1
    return out


align_prep.launches = 0
