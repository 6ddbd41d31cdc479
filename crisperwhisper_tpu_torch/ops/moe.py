"""A mixture-of-experts MLP's routing and its routed experts.

``route`` reads the dynamic top-p routing of Uni-MoE-2.0-Omni's MLPs
(models/speech_moe.py): per token, in f32, the softmax of the gate over
the routed experts and the null experts (which output zero), sorted in
descending order (ties: the lower index first); kept is the shortest
prefix whose sum reaches ``top_p``, at most ``top_k`` entries. A kept
routed expert adds its output times its probability, with no
renormalisation; a kept null expert adds nothing and computes nothing.

``expert_pairs`` lays the kept (token, routed expert) pairs out in
expert order on the device, with no wait for the host, and
``routed_experts`` computes them: on a CUDA tensor by the grouped
expert kernel (``csrc/moe.cu``, two launches a call), on the CPU by its
plain twin, with the same arithmetic: gate and up products in f32,
silu(gate) * up rounded to the activation type, the down product in f32
times the routing weight, summed into an f32 output. The null experts'
rows never reach either.

The kernel replaces no TPU kernel: the JAX package has no mixture of
experts. At decode (tens of rows an expert) each launch streams the
weights of the experts that received rows, so it is bound by bytes:
every block reads its weight tiles once for all of an expert's rows
(step tiles, 64 rows). At prefill (thousands of rows) the same kernels
run 128-row tiles and are bound by operations (block tiles).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import _build


@dataclass
class Routing:
    """A token batch's routing: ``probs`` [T, E + N] f32 (E routed
    experts, then N null ones), ``kept`` [T, E + N] bool; ``expert`` and
    ``weight`` [T, top_k], each token's entries in descending order with
    the routed expert's index and probability where it is kept, else the
    index E and weight 0."""
    probs: torch.Tensor
    kept: torch.Tensor
    expert: torch.Tensor
    weight: torch.Tensor


def route(y: torch.Tensor, w_gate: torch.Tensor, num_experts: int,
          top_p: float, top_k: int,
          kept_out: torch.Tensor | None = None) -> Routing:
    """The routing of the tokens ``y`` [T, d] by the gate ``w_gate``
    [E + N, d] (see the module's docstring); ``kept`` is written into
    ``kept_out`` (bool [T, E + N]) where one is given."""
    probs = torch.softmax(F.linear(y.float(), w_gate.float()), dim=-1)
    p_sorted, order = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
    before = F.pad(torch.cumsum(p_sorted[:, :-1], dim=-1), (1, 0))
    rank = torch.arange(probs.shape[-1], device=probs.device)
    keep_sorted = (before < top_p) & (rank < top_k)
    kept = (torch.zeros_like(keep_sorted) if kept_out is None
            else kept_out.zero_()).scatter_(-1, order, keep_sorted)
    first = order[:, :top_k]
    routed = keep_sorted[:, :top_k] & (first < num_experts)
    return Routing(probs, kept,
                   torch.where(routed, first, num_experts),
                   torch.where(routed, p_sorted[:, :top_k], 0.0))


def expert_pairs(r: Routing, num_experts: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(token int32 [T * top_k], weight f32 [T * top_k], offsets int32
    [E + 1]): the kept pairs sorted by expert, expert e's at
    [offsets[e], offsets[e + 1]), then the unused slots (null experts,
    entries not kept) from offsets[E] on. On the device, no host wait."""
    top_k = r.expert.shape[1]
    key = r.expert.reshape(-1)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(num_experts + 1, dtype=torch.int32,
                         device=key.device).scatter_add_(
        0, key, torch.ones_like(key, dtype=torch.int32))
    offsets = F.pad(torch.cumsum(counts[:num_experts], 0, dtype=torch.int32),
                    (1, 0))
    return ((order // top_k).to(torch.int32), r.weight.reshape(-1)[order],
            offsets)


def _plain(x: torch.Tensor, token: torch.Tensor, weight: torch.Tensor,
           offsets: torch.Tensor, experts: dict) -> torch.Tensor:
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    bounds = offsets.tolist()
    for e in range(len(bounds) - 1):
        rows = token[bounds[e]:bounds[e + 1]].long()
        if rows.numel() == 0:
            continue
        xe = x[rows].float()
        g = xe @ experts["gate"][e].float().T
        u = xe @ experts["up"][e].float().T
        h = (F.silu(g) * u).to(x.dtype).float()
        d = h @ experts["down"][e].float().T
        out.index_add_(0, rows, d * weight[bounds[e]:bounds[e + 1], None])
    return out


def routed_experts(x: torch.Tensor, r: Routing, experts: dict,
                   num_experts: int) -> torch.Tensor:
    """f32 [T, d]: each token's kept routed experts' SwiGLU outputs
    times their probabilities, summed. ``experts`` holds ``gate`` and
    ``up`` [E, f, d] and ``down`` [E, d, f]. CUDA tensors go through the
    grouped kernel (bf16), CPU tensors through its plain twin."""
    token, weight, offsets = expert_pairs(r, num_experts)
    if not x.is_cuda:
        return _plain(x, token, weight, offsets, experts)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    grouped_swiglu(x.contiguous(), token, weight, offsets, experts["gate"],
                   experts["up"], experts["down"], out)
    return out


# decode steps (at most STEP_ROWS tokens) take the kernel's step tiles,
# larger blocks its block tiles; the width and expert width are
# multiples of ALIGN
STEP_ROWS = 64
ALIGN = 128


def grouped_swiglu(x: torch.Tensor, token: torch.Tensor,
                   weight: torch.Tensor, offsets: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, out: torch.Tensor) -> None:
    """Add each pair's weighted SwiGLU output into ``out`` [T, d] f32
    (zeros on entry) with the grouped expert kernel: x [T, d] contiguous
    bf16 on the card; token int32, weight f32 [P]; offsets [E + 1]
    int32 (``expert_pairs``); w_gate, w_up [E, f, d]; w_down [E, d, f]."""
    n_exp, f, d = w_gate.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the grouped expert kernel takes bf16, not "
                        f"{x.dtype}")
    for name, t in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{name}: contiguous {x.dtype} expected")
    if (w_up.shape != w_gate.shape or w_down.shape != (n_exp, d, f)
            or x.shape[1] != d or out.shape != x.shape
            or out.dtype != torch.float32):
        raise ValueError("expert weights, rows and output disagree in shape")
    if d % ALIGN or f % ALIGN:
        raise ValueError(f"the grouped expert kernel needs widths that are "
                         f"multiples of {ALIGN}, not d={d}, f={f}")
    if offsets.dtype != torch.int32 or token.dtype != torch.int32:
        raise TypeError("token and offsets are int32")
    pairs = token.shape[0]
    plan = int(x.shape[0] > STEP_ROWS)
    h = torch.empty((pairs, f), dtype=x.dtype, device=x.device)
    index = x.device.index
    _build.launcher("cw_moe_gate_up")(
        index, x.data_ptr(), token.data_ptr(), offsets.data_ptr(),
        w_gate.data_ptr(), w_up.data_ptr(), h.data_ptr(), pairs, d, f, n_exp,
        plan)
    _build.launcher("cw_moe_down")(
        index, h.data_ptr(), token.data_ptr(), weight.data_ptr(),
        offsets.data_ptr(), w_down.data_ptr(), out.data_ptr(), pairs, d, f,
        n_exp, plan)
    grouped_swiglu.launches += 2


grouped_swiglu.launches = 0
