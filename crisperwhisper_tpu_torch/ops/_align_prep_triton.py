"""Triton kernels of ops/align_prep.py (imported only when they launch).

Replaces the TPU kernel crisperwhisper_tpu/ops/pallas_align.py
(fused_align_prep -> _kernel), which did the z-norm, the median of width
W and the head mean for one (item, head) block in VMEM, full-width rows
only.

What bounds it on the H100: memory. The input is [B, 15, T, 1500] f32
(35 MB at B = 4, T = 96); the arithmetic is a few compares per element.

Design, two passes:
  1. ``_stats_kernel``, per (item, head, 128-frame tile): mean and
     max(std, 1e-10) over the first n_tokens rows (biased, two-pass
     variance), with frames >= n_frames read as 0.
  2. ``_prep_kernel``, per (item, token tile, 128-frame tile): a loop
     over heads that loads the W reflected-shift columns (reflect at 0 and
     at n_frames - 1, per row, as the plain chain does for any n_frames)
     as one [tokens, frames, taps] tile with their statistics, normalizes
     them, sorts the taps of each frame (``tl.sort``, padding taps last;
     the median is an input, so it equals the plain chain's sort) and sums
     the middle tap over heads; the output is the negated mean. W is a
     compile-time constant (any odd width; the token tile shrinks as W
     grows, to bound registers). The W taps hit the same cache lines, so
     device memory sees the input about once per pass.
sqrt and divide are the IEEE-rounded forms (Triton's defaults are
approximate), so the result stays within 1e-5 of the plain chain.
"""

from __future__ import annotations

import triton
import triton.language as tl

_STATS_BLOCK_T = 32
_BLOCK_T = 8
_BLOCK_K = 128


@triton.jit
def _stats_kernel(w_ptr, nt_ptr, nf_ptr, mean_ptr, den_ptr, A, T, K,
                  BLOCK_T: tl.constexpr, BLOCK_K: tl.constexpr):
    pid_ba = tl.program_id(0)                       # item * A + head
    pid_k = tl.program_id(1)
    b = pid_ba // A
    nt = tl.minimum(tl.load(nt_ptr + b), T)
    nf = tl.load(nf_ptr + b)
    offs_k = pid_k * BLOCK_K + tl.arange(0, BLOCK_K)
    col_ok = (offs_k < K) & (offs_k < nf)
    base = w_ptr + pid_ba.to(tl.int64) * T * K
    count = tl.maximum(nt, 1).to(tl.float32)

    total = tl.zeros([BLOCK_K], dtype=tl.float32)
    for t0 in range(0, T, BLOCK_T):
        offs_t = t0 + tl.arange(0, BLOCK_T)
        ok = (offs_t[:, None] < nt) & col_ok[None, :]
        x = tl.load(base + offs_t[:, None] * K + offs_k[None, :], mask=ok,
                    other=0.0)
        total += tl.sum(x, axis=0)
    mean = tl.div_rn(total, count)

    sq = tl.zeros([BLOCK_K], dtype=tl.float32)
    for t0 in range(0, T, BLOCK_T):
        offs_t = t0 + tl.arange(0, BLOCK_T)
        ok = (offs_t[:, None] < nt) & col_ok[None, :]
        x = tl.load(base + offs_t[:, None] * K + offs_k[None, :], mask=ok,
                    other=0.0)
        dev = tl.where(ok, x - mean[None, :], 0.0)
        sq += tl.sum(dev * dev, axis=0)
    den = tl.maximum(tl.sqrt_rn(tl.div_rn(sq, count)), 1e-10)

    out = pid_ba.to(tl.int64) * K + offs_k
    tl.store(mean_ptr + out, mean, mask=offs_k < K)
    tl.store(den_ptr + out, den, mask=offs_k < K)


@triton.jit
def _reflect(idx, nf, K):
    idx = tl.where(idx < 0, -idx, idx)                 # reflect at 0
    idx = tl.where(idx >= nf, 2 * nf - 2 - idx, idx)   # reflect at nf - 1
    return tl.minimum(tl.maximum(idx, 0), K - 1)


@triton.jit
def _prep_kernel(w_ptr, nf_ptr, mean_ptr, den_ptr, out_ptr, A, T, K,
                 WIDTH: tl.constexpr, TAPS: tl.constexpr,
                 BLOCK_T: tl.constexpr, BLOCK_K: tl.constexpr):
    b = tl.program_id(0)
    pid_t = tl.program_id(1)
    pid_k = tl.program_id(2)
    nf = tl.load(nf_ptr + b)
    offs_t = pid_t * BLOCK_T + tl.arange(0, BLOCK_T)
    offs_k = pid_k * BLOCK_K + tl.arange(0, BLOCK_K)
    ok = (offs_t[:, None] < T) & (offs_k[None, :] < K)
    # tap w of frame k reads frame reflect(k + w - WIDTH // 2); taps >=
    # WIDTH (TAPS is WIDTH rounded up to a power of two) are padding
    offs_w = tl.arange(0, TAPS)
    tap = offs_w[None, None, :]
    live = tap < WIDTH
    idx = _reflect(offs_k[:, None] + offs_w[None, :] - WIDTH // 2, nf, K)
    ok3 = ok[:, :, None] & live

    acc = tl.zeros([BLOCK_T, BLOCK_K], dtype=tl.float32)
    for a in range(A):
        ba = (b * A + a).to(tl.int64)
        x = tl.load(w_ptr + ba * T * K + offs_t[:, None, None] * K
                    + idx[None, :, :], mask=ok3, other=0.0)
        mu = tl.load(mean_ptr + ba * K + idx)
        sd = tl.load(den_ptr + ba * K + idx)
        z = tl.div_rn(x - mu[None, :, :], sd[None, :, :])
        # the median: sort each frame's taps (padding taps as +inf, last)
        # and take tap WIDTH // 2 (an input, as the plain chain's sort)
        z = tl.sort(tl.where(live, z, float("inf")), dim=2)
        acc += tl.sum(tl.where(tap == WIDTH // 2, z, 0.0), axis=2)
    # frames >= n_frames are all-zero columns: z == 0 there
    res = tl.where(offs_k[None, :] < nf, acc, 0.0)
    res = -tl.div_rn(res, tl.zeros_like(res) + A)
    out = (b.to(tl.int64) * T + offs_t[:, None]) * K + offs_k[None, :]
    tl.store(out_ptr + out, res, mask=ok)


def launch(weights, n_tokens, n_frames, mean, den, out, width: int) -> None:
    """Run both passes on the current stream. weights [B, A, T, K] f32;
    n_tokens, n_frames [B] int32; mean, den [B, A, K] and out [B, T, K]
    f32, allocated by the caller; ``width`` the odd median width."""
    b, a, t, k = weights.shape
    taps = triton.next_power_of_2(max(width, 2))
    block_t = max(1, min(_BLOCK_T, 64 // taps))
    _stats_kernel[(b * a, triton.cdiv(k, _BLOCK_K))](
        weights, n_tokens, n_frames, mean, den, a, t, k,
        BLOCK_T=_STATS_BLOCK_T, BLOCK_K=_BLOCK_K, num_warps=4)
    _prep_kernel[(b, triton.cdiv(t, block_t), triton.cdiv(k, _BLOCK_K))](
        weights, n_frames, mean, den, out, a, t, k, WIDTH=width, TAPS=taps,
        BLOCK_T=block_t, BLOCK_K=_BLOCK_K, num_warps=4)
