"""The yardstick's arithmetic: peaks of the card, and the operations and
bytes that the model and its kernels need, counted from shapes.

Copied from the port's smoke run (``chip_smoke.py``: ``_bound``,
``_step_work`` and kernel 1's work in phase 2) so that a change to the
program cannot move it. Everything here is a pure function of shapes.

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense
rates: 989 TFLOP/s bf16/f16 on the tensor cores, 67 TFLOP/s f32 outside
them, 3.35 TB/s of HBM.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"bf16": 989e12, "f16": 989e12, "f32": 67e12}


def bound_s(n_bytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(least seconds the card needs for this work, what binds it): the
    bytes over the memory rate, or the operations over the peak rate of
    their type, whichever takes longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS_PER_S[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def encoder_attention_work(batch: int, heads: int, frames: int,
                           head_dim: int) -> tuple[float, float]:
    """(bytes, operations) of one bf16 call of the encoder's attention
    (kernel 1) over [batch, heads, frames, head_dim]: q, k, v read and the
    output written once each; QK^T and PV at two operations a
    multiply-add."""
    numel = batch * heads * frames * head_dim
    return 4 * numel * 2, 4 * numel * frames


def step_work(arch, rows: int, live: int,
              n_align: int) -> tuple[float, float]:
    """(bytes, operations) of one whole quantized decoder step (kernel 5)
    over ``rows`` rows with ``live`` ring slots attended (position + 1):
    every int8 weight and f32 vector row once, the cross caches and their
    bf16 scales, the live ring prefix read and the fresh column written
    (values and a bf16 scale a slot), x0 in, hid and alignment rows out;
    two operations per weight and row, and per attended key and value
    element. The count of ``chip_smoke._step_work``, from shapes."""
    d, f, n_layers = arch.d_model, arch.decoder_ffn_dim, arch.decoder_layers
    h, dh, k = arch.decoder_attention_heads, arch.head_dim, \
        arch.max_source_positions
    weights = n_layers * (6 * d * d + 2 * d * f)          # int8: a byte each
    vec = n_layers * (20 * d + 2 * f) * 4
    cross_bytes = 2 * n_layers * rows * h * k * (dh // 2 + 2)   # int4
    slots = n_layers * rows * h
    col = dh + 2                                                  # int8
    ring_bytes = 2 * slots * (live * col + col)
    io = 2 * rows * d * 4 + rows * n_align * k * 4
    ops = 2 * weights * rows + 4 * n_layers * rows * d * (live + k)
    return weights + vec + cross_bytes + ring_bytes + io, ops


def encoder_flops(arch) -> float:
    """Model operations of one 30 s window through the encoder: the conv
    stem (3000 frames in, 1500 out), then per layer the four attention
    projections and the MLP on every frame, and QK^T and PV."""
    d, f, t = arch.d_model, arch.encoder_ffn_dim, arch.max_source_positions
    stem = 2 * 3 * arch.num_mel_bins * d * 2 * t + 2 * 3 * d * d * t
    layer = 2 * (4 * d * d + 2 * d * f) * t + 4 * t * t * d
    return stem + arch.encoder_layers * layer


def cross_kv_flops(arch) -> float:
    """Model operations of the cross K/V projections, once a window."""
    d, t = arch.d_model, arch.max_source_positions
    return arch.decoder_layers * 2 * 2 * d * d * t


def decoder_token_flops(arch, position: int) -> float:
    """Model operations of one decoder position (self q/k/v/o, cross q/o,
    the MLP; self attention over position + 1 slots and cross attention
    over the encoder frames) and the tied LM head."""
    d, f = arch.d_model, arch.decoder_ffn_dim
    per_layer = 2 * (6 * d * d + 2 * d * f) \
        + 4 * d * (position + 1 + arch.max_source_positions)
    return arch.decoder_layers * per_layer + 2 * d * arch.vocab_size


def window_flops(arch, prompt_len: int, new_tokens: int) -> float:
    """Model operations of one window: encoder, cross K/V, and every
    decoder position from the prompt to the last token fed (the prompt
    and all new tokens but the last)."""
    positions = prompt_len + max(new_tokens, 1) - 1
    return (encoder_flops(arch) + cross_kv_flops(arch)
            + math.fsum(decoder_token_flops(arch, p)
                        for p in range(positions)))
