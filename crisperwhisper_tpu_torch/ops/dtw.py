"""DTW jump times: the hand-written CUDA kernel and its plain twin.

Port of crisperwhisper_tpu/ops/pallas_dtw.py (pallas_dtw_jump_times).
``dtw`` launches ``csrc/dtw.cu`` (one block per batch item, a wavefront
over the live rectangle with its 2-bit trace in shared memory) for CUDA
tensors and runs ``ops.alignment.dtw_jump_times`` only for CPU tensors.
The two agree exactly: same recurrence, same tie-break, one f32 add per
cell. Neither reads a cell outside [0, n_tokens] x [0, n_frames].
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .alignment import dtw_jump_times

# mirrors of csrc/dtw.cu's constants (a CPU test parses the source)
RING_CHUNKS = 3          # chunks of `step` columns in a row's cost ring
STEPS = (16, 8)          # diagonals a step, the longer preferred
QUEUE_STEPS = 4          # hand-off ring a warp boundary, in steps
MAX_WARPS = 16           # one token row a lane: N <= 512
SMEM_LIMIT = 232448      # the H100's 227 KB of shared memory a block


def smem_bytes(n: int, m: int, warps: int, step: int) -> int:
    """Dynamic shared memory of one block (csrc/dtw.cu ``dtw_smem``)."""
    return (warps * 32 * RING_CHUNKS * step * 4 + n * ((m + 15) // 16) * 4
            + (warps - 1) * QUEUE_STEPS * step * 4 + warps * 2 * 4)


def plan(n: int, m: int) -> tuple[int, int]:
    """(warps a block, diagonals a step) for N token rows and M frames: a
    warp per 32 rows, one row a lane, and the longest step whose ring fits
    (measured fastest on the H100); raises a ValueError for a shape the
    kernel does not take."""
    warps = math.ceil(n / 32)
    if warps > MAX_WARPS:
        raise ValueError(f"dtw: {n} token rows exceed the kernel's "
                         f"{32 * MAX_WARPS}")
    for step in STEPS:
        if smem_bytes(n, m, warps, step) <= SMEM_LIMIT:
            return warps, step
    raise ValueError(f"dtw: [{n}, {m}] needs "
                     f"{smem_bytes(n, m, warps, STEPS[-1])} bytes of "
                     f"shared memory for its trace and rings, over the "
                     f"limit of {SMEM_LIMIT}")


def dtw(matrix: torch.Tensor, n_tokens: torch.Tensor,
        n_frames: torch.Tensor, stamps: torch.Tensor | None = None
        ) -> torch.Tensor:
    """matrix [B, N, M] f32 cost, n_tokens/n_frames [B] int32 -> int32
    [B, N] first-arrival frame per token row (tail rows padded with the
    last valid value). ``stamps``: an int64 [B, 3] CUDA tensor that
    receives each block's globaltimer at its start, when its walk ends and
    when its backtrace ends (``testing.dtw_phases``)."""
    if matrix.device.type == "cpu":
        return dtw_jump_times(matrix, n_tokens, n_frames)
    if matrix.device.type != "cuda":
        raise ValueError(f"dtw: unsupported device {matrix.device}")
    if matrix.dtype != torch.float32 or matrix.dim() != 3 \
            or not matrix.is_contiguous():
        raise ValueError("dtw: matrix must be a contiguous float32 "
                         f"[B, N, M] tensor, got {matrix.dtype} "
                         f"{tuple(matrix.shape)}")
    b, n, m = matrix.shape
    for name, x in (("n_tokens", n_tokens), ("n_frames", n_frames)):
        if x.device != matrix.device or x.dtype != torch.int32 \
                or x.shape != (b,) or not x.is_contiguous():
            raise ValueError(f"dtw: {name} must be a contiguous int32 [{b}] "
                             f"tensor on {matrix.device}")
    if stamps is not None and (stamps.device != matrix.device
                               or stamps.dtype != torch.int64
                               or stamps.shape != (b, 3)
                               or not stamps.is_contiguous()):
        raise ValueError(f"dtw: stamps must be a contiguous int64 [{b}, 3] "
                         f"tensor on {matrix.device}")
    if b == 0 or n == 0 or m == 0:
        raise ValueError(f"dtw: unsupported shape {tuple(matrix.shape)}")
    warps, step = plan(n, m)
    out = torch.empty((b, n), dtype=torch.int32, device=matrix.device)
    _build.launcher("cw_dtw")(
        matrix.get_device(), matrix.data_ptr(), n_tokens.data_ptr(),
        n_frames.data_ptr(), out.data_ptr(),
        None if stamps is None else stamps.data_ptr(), b, n, m, warps, step)
    dtw.launches += 1
    return out


dtw.launches = 0
