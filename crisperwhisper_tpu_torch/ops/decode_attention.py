"""Single-query decode attention over a quantized cache: the hand-written
CUDA kernel of the three experiment kernels, and their plain twins.

Ports of experiments/decode_attention_v1.py (``cross_attention_int8``),
experiments/decode_attention_v2.py (``cross_attention_int8_v2``) and
experiments/decode_gemv_v3.py (``decode_gemv_attention``). The three are
one function with different rounding points (csrc/decode_attention.cu):

  * ``cross_attention_int8``: q used in its own dtype, the scaled
    probabilities rounded to bf16 before P.V; returns (out [B, H, 1, D] in
    q's dtype, probs [B, H, K] f32);
  * ``cross_attention_int8_v2``: the same with q rounded to bf16 first;
  * ``decode_gemv_attention``: one layer of a stacked cache, the products
    and the P.V operand in q's dtype, optional scales, causal ``position``
    mask (an int, or a 0-d int32 tensor that the kernel reads on the
    device), ``key_mask`` and alignment selector ``sel``; returns out
    [B, H, D] f32 (and the aligned rows [B, A, T] f32 with ``sel``).

The kernel splits each (row, head)'s keys across a cluster of blocks
whose size ``plan`` picks from rows x heads and the card's SM count; each
wrapper launches it through ``_build.launcher``.

``decode_gemv_attention`` takes the port's cache layout, not the TPU's
sequence-last [L, B, H, Dh, T]: the caches that ``models.whisper.
init_cache`` builds, [L, B, H, T, Dh] in int8, bf16 or f32, or packed int4
[L, B, H, T, Dh / 2] uint8, with bf16 scales [L, B, H, T]. The kernel
indexes the layer inside the stacked cache, which is never sliced or
copied. Masked scores are -1e9, so a row whose keys are all masked is
uniform over T, as in the reference.

Each wrapper launches the kernel for CUDA tensors (or raises) and runs its
plain twin, written on ``cache_values`` with the same rounding points,
only for CPU tensors. The head dim is 64 (every Whisper size).

``bind_decode_gemv`` is the decoder step's path to the v3 entry
(models/whisper.py, every one-token step): the checks and the plan that
hold for a step's stacked caches are made once, and each layer's call is
a launch (on the CPU, the plain twin at any head dim). A position held on
the device leaves the launch's arguments the same at every step, so the
greedy loop captures the step once as a CUDA graph and replays it
(decoding/greedy.py). This module
imports nothing of models/, which imports it; the quantized cache's int4
packing lives here for that reason.
"""

from __future__ import annotations

import functools

import torch

from .. import _build

HEAD_DIM = 64
MAX_KEYS = 8192                       # the kernel's limit (kMaxKeys)
NEG_INF = -1e9                        # the reference's mask fill
_CACHE_KINDS = {torch.int8: 0, torch.uint8: 1, torch.bfloat16: 2,
                torch.float32: 3}     # uint8: packed int4
_Q_DTYPES = (torch.float32, torch.bfloat16)
_ROW_BYTES = {torch.int8: 64, torch.uint8: 32, torch.bfloat16: 128,
              torch.float32: 256}     # bytes of a cache row
# mirrors of csrc/decode_attention.cu's constants (a CPU test parses them)
THREADS = 128
MAX_CLUSTER = 8
SLOTS = 4                             # K (and V) pieces in flight a block
HEAD_BYTES = 16 * SLOTS + 256         # an mbarrier a slot, then q
SMEM_LIMIT = 232448                   # the H100's 227 KB a block
# the plan's aims: at least FILL blocks an SM in the grid, a block's whole
# slice within SMEM_BUDGET (four blocks an SM) where the cluster can grow,
# and within STREAM_BUDGET (two blocks an SM) before it streams. A block's
# exchanges after its data has landed leave the SM's loads idle unless
# other blocks are loading, so four blocks an SM beat two, while a larger
# cluster than needed only adds exchanges: the two aims pick the fastest
# cluster size of a sweep of 2, 4 and 8 at chip_smoke's shapes (PERF.md),
# where phase 8 (c)'s rows tie at 4 and 8
FILL = 8
SMEM_BUDGET = 56 * 1024
STREAM_BUDGET = 112 * 1024


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 [..., 2n] in [-7, 7] -> uint8 [..., n]: element 2i in the low
    nibble, 2i + 1 in the high one."""
    w = q.to(torch.int16)
    return ((w[..., 0::2] & 0xF) | ((w[..., 1::2] & 0xF) << 4)) \
        .to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., n] -> int8 [..., 2n], inverse of ``pack_int4``."""
    b = p.to(torch.int16)
    lo = ((b & 0xF) ^ 8) - 8                 # sign-extend the nibbles
    hi = ((b >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).flatten(-2).to(torch.int8)


def cache_values(c: torch.Tensor) -> torch.Tensor:
    """The integer values of a quantized cache slice (int8, unpacked)."""
    return unpack_int4(c) if c.dtype == torch.uint8 else c


def _round16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(per: int, piece: int, row: int, n_align: int = 0) -> int:
    """Dynamic shared memory of one block (csrc/decode_attention.cu
    ``smem_bytes``): the mbarriers and q, SLOTS K and SLOTS V slots of
    ``piece`` rows of ``row`` bytes; for ``per`` keys the f32 scores, the
    16-byte-aligned spans of the bf16 K and V scales and of the mask bytes;
    the warps' P.V partials; the head's sel columns and weights."""
    return (HEAD_BYTES + 2 * SLOTS * piece * row + 4 * _round16(per)
            + 2 * _round16(2 * per + 15) + _round16(per + 15)
            + 4 * (THREADS // 32) * HEAD_DIM
            + 8 * ((n_align + 3) & ~3))


@functools.lru_cache(maxsize=256)
def plan(pairs: int, keys: int, row: int, sms: int) -> tuple[int, int]:
    """(cluster, piece) for ``pairs`` (row, head) pairs of ``keys`` keys
    of ``row`` bytes on a card of ``sms`` SMs: the smallest cluster of 2,
    4 or 8 blocks that puts FILL blocks on every SM and keeps a block's
    whole slice of K and V within SMEM_BUDGET; each block loads its slice
    in SLOTS pieces of ``piece`` keys. Where even a cluster of 8 leaves a
    slice over STREAM_BUDGET, the slice streams through the slots in the
    largest pieces that fit."""
    def quarter(c):
        per = -(-keys // c)
        return per, -(-per // SLOTS)
    cluster = 2
    per, piece = quarter(cluster)
    while cluster < MAX_CLUSTER and (
            pairs * cluster < FILL * sms
            or smem_bytes(per, piece, row) > SMEM_BUDGET):
        cluster *= 2
        per, piece = quarter(cluster)
    if smem_bytes(per, piece, row) <= STREAM_BUDGET:
        return cluster, piece
    return cluster, (STREAM_BUDGET - smem_bytes(per, 0, row)) // (
        2 * SLOTS * row)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_for(q: torch.Tensor, pairs: int, keys: int,
              cache: torch.dtype) -> tuple[int, int]:
    return plan(pairs, keys, _ROW_BYTES[cache], _sm_count(q.get_device()))


def _operand(c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cache values in the operand dtype, widened to f32 for the product."""
    if c.dtype in (torch.int8, torch.uint8):
        c = cache_values(c)
    return c.to(dtype).float()


def cross_attention_int8_plain(q: torch.Tensor, k_q: torch.Tensor,
                               k_s: torch.Tensor, v_q: torch.Tensor,
                               v_s: torch.Tensor, q_bf16: bool = False
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of ``cross_attention_int8`` (``q_bf16=False``) and
    ``cross_attention_int8_v2`` (``q_bf16=True``)."""
    qf = (q.to(torch.bfloat16) if q_bf16 else q).float()
    s = torch.matmul(qf, cache_values(k_q).float().transpose(-1, -2)) \
        * k_s.float()[..., 0][:, :, None, :]
    p = torch.softmax(s, dim=-1)                          # [B, H, 1, K]
    pv = (p * v_s.float()[..., 0][:, :, None, :]).to(torch.bfloat16)
    out = torch.matmul(pv.float(), cache_values(v_q).float())
    return out.to(q.dtype), p[:, :, 0, :]


def _check_cross(q, k_q, k_s, v_q, v_s) -> tuple[torch.Tensor, ...]:
    qs, ks = q.shape, k_q.shape
    ok = (len(qs) == 4 and qs[2] == 1 and qs[3] == HEAD_DIM
          and q.dtype in _Q_DTYPES and len(ks) == 4 and ks[:2] == qs[:2]
          and ks[3] == HEAD_DIM and 0 < ks[2] <= MAX_KEYS
          and k_q.dtype == torch.int8 and v_q.dtype == torch.int8
          and v_q.shape == ks and k_s.dtype == torch.bfloat16
          and v_s.dtype == torch.bfloat16 and k_s.shape == ks[:3] + (1,)
          and v_s.shape == k_s.shape)
    if not ok:
        raise ValueError(
            "cross_attention_int8: expected q [B, H, 1, 64] f32/bf16, int8 "
            f"K/V [B, H, K <= {MAX_KEYS}, 64] and bf16 scales [B, H, K, 1]; "
            f"got q {q.dtype} {list(q.shape)}, K {k_q.dtype} "
            f"{list(k_q.shape)}, scales {k_s.dtype} {list(k_s.shape)}")
    return _on_card(q, k_q, k_s, v_q, v_s)


def _on_card(*tensors: torch.Tensor | None) -> tuple[torch.Tensor | None,
                                                     ...]:
    """The tensors as the kernel reads them: each on the first one's card,
    contiguous and starting on 16 bytes (the kernel bulk-copies q and the
    caches into shared memory in 16-byte granules). A tensor that is not
    gets a contiguous copy, cloned once more where its data does not start
    on 16 bytes: a pass over that tensor. Raises when a tensor lies on
    another device."""
    device = tensors[0].device
    out = []
    for x in tensors:
        if x is not None:
            if x.device != device:
                raise ValueError("decode attention: every tensor must be "
                                 f"on {device}, got one on {x.device}")
            x = x.contiguous()
            if x.data_ptr() % 16:
                x = x.clone()
        out.append(x)
    return tuple(out)


def _launch_cross(entry: str, q, k_q, k_s, v_q, v_s
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    q, k_q, k_s, v_q, v_s = _check_cross(q, k_q, k_s, v_q, v_s)
    b, h, _, _ = q.shape
    t = k_q.shape[2]
    out = torch.empty_like(q)
    probs = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _build.launcher(entry)(
        q.get_device(), q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(),
        v_q.data_ptr(), v_s.data_ptr(), out.data_ptr(), probs.data_ptr(), b,
        h, t, int(q.dtype == torch.bfloat16),
        *_plan_for(q, b * h, t, torch.int8))
    return out, probs


def _device(q: torch.Tensor, name: str) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return q.device.type


def cross_attention_int8(q: torch.Tensor, k_q: torch.Tensor,
                         k_s: torch.Tensor, v_q: torch.Tensor,
                         v_s: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B, H, 1, D] (pre-scaled) over int8 K/V [B, H, K, D] with scales
    [B, H, K, 1] -> (out [B, H, 1, D] in q's dtype, probs [B, H, K] f32);
    q enters the product in its own dtype. On the card, a tensor that is
    not contiguous or does not start on 16 bytes is copied first (a pass
    over it), and the kernel runs on the copy."""
    if _device(q, "cross_attention_int8") == "cpu":
        return cross_attention_int8_plain(q, k_q, k_s, v_q, v_s)
    res = _launch_cross("cw_cross_attention_int8", q, k_q, k_s, v_q, v_s)
    cross_attention_int8.launches += 1
    return res


cross_attention_int8.launches = 0


def cross_attention_int8_v2(q: torch.Tensor, k_q: torch.Tensor,
                            k_s: torch.Tensor, v_q: torch.Tensor,
                            v_s: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``cross_attention_int8`` with q rounded to bf16 before the product
    (the reference's v2); inputs on the card are copied as there."""
    if _device(q, "cross_attention_int8_v2") == "cpu":
        return cross_attention_int8_plain(q, k_q, k_s, v_q, v_s,
                                          q_bf16=True)
    res = _launch_cross("cw_cross_attention_int8_v2", q, k_q, k_s, v_q, v_s)
    cross_attention_int8_v2.launches += 1
    return res


cross_attention_int8_v2.launches = 0


def decode_gemv_plain(q: torch.Tensor, k_stack: torch.Tensor,
                      v_stack: torch.Tensor, layer: int,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None,
                      position: int | None = None,
                      key_mask: torch.Tensor | None = None,
                      sel: torch.Tensor | None = None):
    """The plain twin of ``decode_gemv_attention``."""
    layer = int(layer)
    op = q.dtype
    k, v = _operand(k_stack[layer], op), _operand(v_stack[layer], op)
    s = torch.matmul(q.float()[:, :, None, :], k.transpose(-1, -2))[:, :, 0]
    if k_scale is not None:
        s = s * k_scale[layer].float()
    t = s.shape[-1]
    if position is not None:
        at = position if isinstance(position, torch.Tensor) \
            else int(position)
        s = s.masked_fill(torch.arange(t, device=s.device) > at, NEG_INF)
    if key_mask is not None:
        s = s.masked_fill(key_mask[:, None, :] == 0, NEG_INF)
    p = torch.softmax(s, dim=-1)                          # [B, H, T]
    pv = p * v_scale[layer].float() if v_scale is not None else p
    out = torch.matmul(pv.to(op).float()[:, :, None, :], v)[:, :, 0]
    if sel is None:
        return out
    return out, torch.einsum("ha,bht->bat", sel.float(), p)


def decode_gemv_attention(q: torch.Tensor, k_stack: torch.Tensor,
                          v_stack: torch.Tensor, layer: int,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None,
                          position: int | None = None,
                          key_mask: torch.Tensor | None = None,
                          sel: torch.Tensor | None = None):
    """Single-query attention of decoder layer ``layer`` against the
    stacked cache.

    q [B, H, D] f32/bf16, pre-scaled; k_stack/v_stack [L, B, H, T, D]
    int8/bf16/f32 or packed int4 [L, B, H, T, D / 2] uint8; k_scale /
    v_scale optional bf16 [L, B, H, T] (both or neither); ``position``
    masks the keys after it: an int, or a 0-d int32 tensor on q's device,
    which the kernel reads there; ``key_mask`` [B, T] (bool or bytes, 0 =
    masked); ``sel`` [H, A] head weights, one-hot in use (aligned row a
    is sum_h sel[h, a] * probs[h], as in the reference). Returns out [B,
    H, D] f32, or (out, aligned [B, A, T] f32) with ``sel``. On the card,
    a tensor that is not contiguous or does not start on 16 bytes (a
    whole stacked cache included) is copied first, a pass over it, and the
    kernel runs on the copy."""
    if _device(q, "decode_gemv_attention") == "cpu":
        return decode_gemv_plain(q, k_stack, v_stack, layer, k_scale,
                                 v_scale, position, key_mask, sel)
    layer = int(layer)
    if k_stack.dim() != 5 or q.dim() != 3:
        raise ValueError(f"decode_gemv_attention: expected q [B, H, D] and "
                         f"caches [L, B, H, T, *], got {list(q.shape)} and "
                         f"{list(k_stack.shape)}")
    n_layers, b, h, t, width = k_stack.shape
    want = HEAD_DIM // 2 if k_stack.dtype == torch.uint8 else HEAD_DIM
    if (q.dtype not in _Q_DTYPES or tuple(q.shape) != (b, h, HEAD_DIM)
            or k_stack.dtype not in _CACHE_KINDS or width != want
            or v_stack.dtype != k_stack.dtype
            or v_stack.shape != k_stack.shape
            or not 0 <= layer < n_layers or not 0 < t <= MAX_KEYS):
        raise ValueError(
            f"decode_gemv_attention: unsupported q {q.dtype} "
            f"{list(q.shape)} / cache {k_stack.dtype} {list(k_stack.shape)} "
            f"at layer {layer}")
    if (k_scale is None) != (v_scale is None) or any(
            s is not None and (s.dtype != torch.bfloat16
                               or tuple(s.shape) != (n_layers, b, h, t))
            for s in (k_scale, v_scale)):
        raise ValueError("decode_gemv_attention: k_scale and v_scale must "
                         f"both be bf16 [{n_layers}, {b}, {h}, {t}] or both "
                         "None")
    if key_mask is not None:
        if tuple(key_mask.shape) != (b, t):
            raise ValueError(f"decode_gemv_attention: key_mask must be "
                             f"[{b}, {t}], got {list(key_mask.shape)}")
        if key_mask.element_size() != 1:
            key_mask = key_mask != 0
    n_align = 0
    if sel is not None:
        if sel.dim() != 2 or sel.shape[0] != h:
            raise ValueError(f"decode_gemv_attention: sel must be [{h}, A], "
                             f"got {list(sel.shape)}")
        sel = sel.float().contiguous()
        n_align = sel.shape[1]
    q, k_stack, v_stack, k_scale, v_scale, key_mask, sel = _on_card(
        q, k_stack, v_stack, k_scale, v_scale, key_mask, sel)
    return _card_attend(q.dtype, k_stack, v_stack, k_scale, v_scale,
                        key_mask)(q, layer, position, sel)


decode_gemv_attention.launches = 0


def _card_attend(q_dtype: torch.dtype, k_stack: torch.Tensor,
                 v_stack: torch.Tensor, k_scale: torch.Tensor | None,
                 v_scale: torch.Tensor | None,
                 key_mask: torch.Tensor | None):
    """The v3 entry bound to stacked caches (and scales, key mask) that
    are checked and laid out as the kernel reads them (``_on_card``):
    ``attend(q, layer, position, sel)`` launches it for one layer. A call
    checks only its q (dtype, shape, layout), its position and ``sel``,
    and counts in ``decode_gemv_attention.launches`` (a call under a CUDA
    graph's capture counts the launch it records once; the replays run it
    uncounted, as a device trace shows). A position tensor goes to the
    kernel as a pointer, read on the device."""
    n_layers, b, h, t, _ = k_stack.shape
    dev = k_stack.device
    index = k_stack.get_device()
    launch = _build.launcher("cw_decode_gemv_attention")
    cluster, piece = plan(b * h, t, _ROW_BYTES[k_stack.dtype],
                          _sm_count(index))
    # the tensors stay referenced here for as long as ``attend`` lives (a
    # copy that _on_card made would otherwise be freed under the kernel)
    held = (k_stack, v_stack, k_scale, v_scale, key_mask)
    caches = tuple(None if x is None else x.data_ptr() for x in held)
    q_shape = torch.Size((b, h, HEAD_DIM))
    kind, q_bf16 = _CACHE_KINDS[k_stack.dtype], int(q_dtype == torch.bfloat16)

    def attend(q: torch.Tensor, layer: int, position: int | None = None,
               sel: torch.Tensor | None = None):
        if (q.dtype != q_dtype or q.shape != q_shape or q.device != dev
                or not q.is_contiguous() or q.data_ptr() % 16):
            raise ValueError(f"decode_gemv_attention: q must be contiguous "
                             f"{q_dtype} {list(q_shape)} on {dev}, got "
                             f"{q.dtype} {list(q.shape)} on {q.device}")
        out = torch.empty(q_shape, dtype=torch.float32, device=dev)
        aligned, n_align = None, 0
        if sel is not None:
            if (sel.dtype != torch.float32 or sel.dim() != 2
                    or sel.shape[0] != h or sel.device != dev
                    or not sel.is_contiguous()):
                raise ValueError(f"decode_gemv_attention: sel must be "
                                 f"contiguous f32 [{h}, A] on {dev}")
            n_align = sel.shape[1]
            aligned = torch.empty((b, n_align, t), dtype=torch.float32,
                                  device=dev)
        at = None
        if isinstance(position, torch.Tensor):
            if (position.dtype != torch.int32 or position.dim() != 0
                    or position.device != dev):
                raise ValueError(f"decode_gemv_attention: a position "
                                 f"tensor must be 0-d int32 on {dev}, got "
                                 f"{position.dtype} {list(position.shape)}"
                                 f" on {position.device}")
            at, position = position.data_ptr(), None
        launch(index, q.data_ptr(), *caches,
               None if sel is None else sel.data_ptr(), out.data_ptr(),
               None if aligned is None else aligned.data_ptr(), at, kind,
               n_layers, b, h, t, int(layer),
               0 if position is None else max(min(int(position), t), -1),
               int(position is not None), n_align, q_bf16, cluster, piece)
        decode_gemv_attention.launches += 1
        return out if sel is None else (out, aligned)
    attend.held = held
    return attend


def bind_decode_gemv(q_dtype: torch.dtype, k_stack: torch.Tensor,
                     v_stack: torch.Tensor,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     key_mask: torch.Tensor | None = None):
    """``decode_gemv_attention`` bound to one pair of stacked caches for
    the layers of a decode step, or None where it does not take them with
    the rounding points of models/whisper's ``attention`` and
    ``quantized_attention``: q f32 or bf16; a float cache in q's dtype,
    or an int8 / packed int4 one with its scales; at most MAX_KEYS keys;
    ``key_mask`` None or [B, T]; on the card a head dim of 64 (the plain
    twin takes any).

    Returns ``attend(q, layer, position=None, sel=None)``, q [B, H, Dh]
    contiguous in ``q_dtype``, position an int or a 0-d int32 tensor on
    the caches' device (read there, so a captured launch follows it), sel
    f32 [H, A] contiguous on the caches' device: out [B, H, Dh] f32, or
    (out, aligned [B, A, T] f32) with sel.
    The caches are checked and, where they are not laid out as the kernel
    reads them, copied once here, not at every layer."""
    quantized = k_stack.dtype in (torch.int8, torch.uint8)
    n_layers, b, h, t, width = k_stack.shape
    on_card = k_stack.device.type == "cuda"
    scales_fit = all(
        (s is not None and s.dtype == torch.bfloat16
         and s.shape == k_stack.shape[:4]) if quantized else s is None
        for s in (k_scale, v_scale))
    if (q_dtype not in _Q_DTYPES
            or k_stack.device.type not in ("cpu", "cuda")
            or not (quantized or k_stack.dtype == q_dtype)
            or v_stack.dtype != k_stack.dtype
            or v_stack.shape != k_stack.shape or not scales_fit
            or not 0 < t <= MAX_KEYS
            or (key_mask is not None and tuple(key_mask.shape) != (b, t))
            or (on_card and width != (HEAD_DIM // 2 if k_stack.dtype
                                      == torch.uint8 else HEAD_DIM))):
        return None
    if not on_card:
        def attend(q, layer, position=None, sel=None):
            return decode_gemv_plain(q, k_stack, v_stack, layer, k_scale,
                                     v_scale, position, key_mask, sel)
        return attend
    if key_mask is not None and key_mask.element_size() != 1:
        key_mask = key_mask != 0
    return _card_attend(q_dtype, *_on_card(k_stack, v_stack, k_scale,
                                           v_scale, key_mask))
