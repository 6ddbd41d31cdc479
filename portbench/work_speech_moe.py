"""The yardstick's arithmetic for the speech-LM cells (Uni-MoE-2.0-Omni's
speech-to-text path): the model's operations a window, and the bytes and
operations of the grouped expert kernel from the routed rows.

Pure functions of shapes and of the routing counts the program records
(``routing_prefill`` / ``routing_steps`` of its ``cw.decode`` records,
models/speech_moe.RoutingRecord.counts: per layer the rows of each routed and
null expert, the tokens keeping one and two entries, and the launches in
which each routed expert had rows). The peaks are ``work.py``'s.
"""

from __future__ import annotations

import math

from portbench.work import (HBM_BYTES_PER_S, PEAK_FLOPS_PER_S,  # noqa: F401
                            bound_s, encoder_flops)

BF16 = 2                         # bytes of a served weight or activation


def audio_flops(arch) -> float:
    """One 30 s window through the Whisper encoder and the adapter's
    linear."""
    return (encoder_flops(arch.audio)
            + 2 * arch.audio_tokens * arch.audio.d_model * arch.hidden_size)


def layer_flops(arch, position: int) -> float:
    """One position through one layer: q/k/v/o, attention over position +
    1 keys, the router, the shared experts and top_k routed experts (the
    cap: dynamic routing keeps one or two, sometimes none)."""
    d, kv = arch.hidden_size, arch.num_key_value_heads * arch.head_dim
    proj = 2 * (2 * d * d + 2 * d * kv)
    attn = 4 * d * (position + 1)
    router = 2 * d * (arch.num_experts + arch.null_experts)
    shared = 2 * 3 * d * arch.shared_experts * arch.shared_dim
    routed = arch.top_k * 2 * 3 * d * arch.expert_dim
    return proj + attn + router + shared + routed


def window_flops(arch, prompt_len: int, new_tokens: int) -> float:
    """Model operations of one window: the audio tower and adapter, every
    position from the prompt to the last token fed through every layer,
    and the head at each one-token step (the prefill computes no
    logits)."""
    positions = prompt_len + max(new_tokens, 1) - 1
    lm = arch.num_hidden_layers * math.fsum(
        layer_flops(arch, p) for p in range(positions))
    head = max(new_tokens, 1) * 2 * arch.hidden_size * arch.vocab_size
    return audio_flops(arch) + lm + head


def expert_work(arch, rows: float, active: float) -> tuple[float, float]:
    """(bytes, operations) of the grouped expert kernel's two launches
    over ``rows`` (token, routed expert) rows, ``active`` being the
    experts that received rows: each such expert's gate, up and down
    matrices read once; each row's input read, its silu(gate) * up
    written and read back, and its f32 output added; two operations a
    multiply-add of the three products."""
    d, f = arch.hidden_size, arch.expert_dim
    weights = active * 3 * d * f * BF16
    io = rows * (d * BF16 + 2 * f * BF16 + d * 4)
    return weights + io, 2 * 3 * d * f * rows


def routing_bound_s(arch, counts: list) -> float:
    """Least seconds of the expert launches one layer-by-layer count
    [L][2 E + N + 2] describes (``RoutingRecord.counts``): per layer, the rows
    and active experts summed over its launches, bound by the larger of
    bytes and operations (a lower bound of the sum of each launch's
    own)."""
    e, n = arch.num_experts, arch.null_experts
    total = 0.0
    for row in counts:
        rows = sum(row[:e])
        active = sum(row[e + n + 2:e + n + 2 + e])
        total += bound_s(*expert_work(arch, rows, active), "bf16")[0]
    return total
