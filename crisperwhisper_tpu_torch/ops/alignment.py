"""Token-to-time alignment: z-norm, median filter, DTW (plain chain).

Port of crisperwhisper_tpu/ops/alignment.py. The functions here are the
plain PyTorch versions: the CPU path of the pipeline and the reference the
kernels are held against. ``attention_to_jump_times`` sends every row
through the two kernel wrappers (ops/align_prep.py, ops/dtw.py), which take
these plain versions for CPU tensors and launch the kernels for CUDA ones.

Parity contracts (hf generation_whisper.py): median filter :46-64
(reflect-padded sliding median over frames), z-norm :344-349 (per head
and frame over tokens, biased std), DTW :67-118 (diagonal only on strict
<, else up only on strict <, else left).
"""

from __future__ import annotations

import torch


def median_filter(x: torch.Tensor, width: int,
                  length: torch.Tensor | int | None = None) -> torch.Tensor:
    """Sliding median along the last axis with reflect padding.

    length: true length M' <= M, an int or an integer tensor that
    broadcasts against ``x.shape[:-1]`` (one length per row). Reflection
    happens at M' - 1, and columns >= M' pass through untouched (the
    reference crops to num_frames//2 before filtering)."""
    if width <= 0 or width % 2 != 1:
        raise ValueError("`width` should be an odd positive number")
    m = x.shape[-1]
    pad = width // 2
    if m <= pad:
        return x
    j = torch.arange(m, device=x.device)
    if length is None:
        n = torch.tensor(m, device=x.device)
    else:
        n = torch.as_tensor(length, device=x.device)[..., None]
    taps = []
    for off in range(-pad, pad + 1):
        idx = j + off
        idx = torch.where(idx < 0, -idx, idx)                  # reflect at 0
        idx = torch.where(idx >= n, 2 * n - 2 - idx, idx)      # at n - 1
        idx = idx.clamp(0, m - 1)
        idx = torch.broadcast_to(idx, (*x.shape[:-1], m))
        taps.append(torch.gather(x, -1, idx))
    med = torch.stack(taps, dim=-1).sort(dim=-1).values[..., pad]
    if length is not None:
        med = torch.where(j < n, med, x)
    return med


def znorm_tokens(weights: torch.Tensor,
                 token_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Normalize over the token axis (-2), std unbiased=False. token_mask
    [..., T] marks real tokens; other rows do not enter the statistics."""
    if token_mask is None:
        mean = weights.mean(dim=-2, keepdim=True)
        std = weights.std(dim=-2, keepdim=True, correction=0)
    else:
        mask = token_mask[..., :, None].to(weights.dtype)
        count = mask.sum(dim=-2, keepdim=True).clamp_min(1.0)
        mean = (weights * mask).sum(dim=-2, keepdim=True) / count
        var = ((weights - mean).square() * mask).sum(dim=-2,
                                                     keepdim=True) / count
        std = var.sqrt()
    return (weights - mean) / std.clamp_min(1e-10)


def _diagonal_traces(mat: torch.Tensor) -> torch.Tensor:
    """The DP over a batch of [N, M] f32 costs, walked along the
    anti-diagonals with the whole batch and every row at once (each cell
    one f32 add): int8 [B, N + M - 1, N + 1], where [:, d - 2, i] is the
    trace code of cell (i, d - i) (0 diagonal, 1 up, 2 left)."""
    b, n, m = mat.shape
    dev = mat.device
    inf = torch.tensor(float("inf"), device=dev)
    rows = torch.arange(n + 1, device=dev)
    cost_d2 = torch.full((b, n + 1), float("inf"), device=dev)
    cost_d2[:, 0] = 0.0                                  # diagonal 0
    cost_d1 = torch.full((b, n + 1), float("inf"), device=dev)
    inf_col = torch.full((b, 1), float("inf"), device=dev)
    traces = torch.empty((b, n + m - 1, n + 1), dtype=torch.int8, device=dev)
    for d in range(2, n + m + 1):
        c0 = torch.cat([inf_col, cost_d2[:, :-1]], dim=1)
        c1 = torch.cat([inf_col, cost_d1[:, :-1]], dim=1)
        c2 = cost_d1
        take0 = (c0 < c1) & (c0 < c2)
        take1 = (c1 < c0) & (c1 < c2)
        c = torch.where(take0, c0, torch.where(take1, c1, c2))
        t = torch.where(take0, 0, torch.where(take1, 1, 2))
        j = d - rows
        valid = (rows >= 1) & (j >= 1) & (j <= m)
        mval = mat[:, (rows - 1).clamp(0, n - 1), (j - 1).clamp(0, m - 1)]
        new = torch.where(valid, mval + c, inf)
        traces[:, d - 2] = t.to(torch.int8)
        cost_d2, cost_d1 = cost_d1, new
    return traces


def dtw_trace(matrix: torch.Tensor) -> torch.Tensor:
    """DP over one [N, M] cost matrix (the negated smoothed attention) ->
    its int8 trace [N + 1, M + 1]: 0 diagonal, 1 up (token - 1), 2 left
    (time - 1), with the tie-break of generation_whisper.py:82-90; row 0
    is 2 and column 0 is 1 (the boundary rules of the backtrace, :96-97),
    as the reference's dtw_trace (alignment.py:109-173) gives it."""
    n, m = matrix.shape
    traces = _diagonal_traces(matrix[None].float())[0]
    i = torch.arange(n + 1, device=matrix.device)[:, None]
    j = torch.arange(m + 1, device=matrix.device)[None, :]
    trace = traces[(i + j - 2).clamp(0, n + m - 2), i.expand(n + 1, m + 1)]
    trace[0, :] = 2
    trace[:, 0] = 1
    return trace


def dtw_jump_times(matrix: torch.Tensor, n_tokens: torch.Tensor,
                   n_frames: torch.Tensor) -> torch.Tensor:
    """Batched DTW + backtrace -> first-arrival frame per token row.

    matrix: [B, N, M] f32 cost (negated attention). n_tokens, n_frames:
    [B] integer tensors. Returns int32 [B, N]; rows >= n_tokens hold the
    last valid value. What lies outside the live rectangle [0, n_tokens] x
    [0, n_frames] never reaches the result: every cell inside depends only
    on cells above and to its left, and the backtrace starts at (n_tokens,
    n_frames). The trace comes from ``_diagonal_traces``."""
    b, n, m = matrix.shape
    dev = matrix.device
    traces = _diagonal_traces(matrix.float())

    nt = n_tokens.to(device=dev, dtype=torch.long).clamp(0, n)
    nf = n_frames.to(device=dev, dtype=torch.long).clamp(0, m)
    i, j = nt.clone(), nf.clone()
    out = torch.zeros((b, n), dtype=torch.long, device=dev)
    bidx = torch.arange(b, device=dev)
    for _ in range(n + m):
        done = (i <= 0) & (j <= 0)
        t = traces[bidx, (i + j - 2).clamp(0, n + m - 2), i].long()
        t = torch.where(i == 0, 2, torch.where(j == 0, 1, t))
        write = ~done & (i >= 1)
        slot = (i - 1).clamp_min(0)
        out[bidx, slot] = torch.where(write, (j - 1).clamp_min(0),
                                      out[bidx, slot])
        i = torch.where(done, i, i - ((t == 0) | (t == 1)).long())
        j = torch.where(done, j, j - ((t == 0) | (t == 2)).long())
    last = out[bidx, (nt - 1).clamp_min(0)]
    out = torch.where(torch.arange(n, device=dev)[None, :] < nt[:, None],
                      out, last[:, None])
    return out.to(torch.int32)


def attention_to_jump_times(weights: torch.Tensor, median_width: int,
                            n_tokens: torch.Tensor,
                            n_frames: torch.Tensor) -> torch.Tensor:
    """[B, A, T, M] alignment-head probabilities -> int32 [B, T] first-
    arrival frame per generated token (generation_whisper.py:344-383).

    n_tokens: [B] generated-token counts; n_frames: [B] true encoder frames
    (num_frames // 2, cropped rows included). Every row, full or cropped,
    takes one align-prep call and one DTW call; the DTW reads only the
    live cells of the prep's output, so nothing is masked between them."""
    from .align_prep import align_prep
    from .dtw import dtw

    n_tokens = n_tokens.to(device=weights.device, dtype=torch.int32)
    n_frames = n_frames.to(device=weights.device, dtype=torch.int32)
    return dtw(align_prep(weights, n_tokens, n_frames, median_width),
               n_tokens, n_frames)
