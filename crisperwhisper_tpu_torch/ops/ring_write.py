"""Per-row block writes into the self-attention rings (batched speculation).

Port of crisperwhisper_tpu/ops/ring_scatter.py. Batched assisted decoding
advances every row at its own cache position, so the verify block (and the
draft chain at batch > 1) writes S contiguous columns per row at per-row
slots: ring[li, b, :, pos[b]:pos[b] + S] = blk[b] for every row b. The
reference offers three bit-identical strategies behind CW_RING_SCATTER
(ring_scatter.py:15-31); the port has one: on CUDA tensors one launch of
``csrc/ring_write.cu`` per layer covers every (ring, block) pair and every
row, and on CPU tensors the plain version loops over the rows.

Layouts are the port's (models/whisper.DecoderCache): rings [L, B, H, T,
*tail] and blocks [B, H, S, *tail] in the ring's dtype, where tail is
(Dh,) for K/V values (bf16, f32, int8, or packed int4 as uint8 Dh/2) and
() for the bf16 scales [L, B, H, T]. A column is therefore a contiguous
run of tail bytes, and row b's S columns of one head are one contiguous
run in the ring and in the block. The contract is the reference's: the
slots [pos[b], pos[b] + S) are in bounds (callers size the caches
t_total + S, decoding/assisted.py) and rows do not overlap.
"""

from __future__ import annotations

import torch

from .. import _build

MAX_PAIRS = 4                    # K, V and their two scale rings


def _check_pair(ring: torch.Tensor, blk: torch.Tensor, li: int,
                n_rows: int) -> None:
    if (ring.dim() < 4 or blk.dim() != ring.dim() - 1
            or blk.shape[0] != ring.shape[1] or blk.shape[0] != n_rows
            or blk.shape[1] != ring.shape[2]
            or tuple(blk.shape[3:]) != tuple(ring.shape[4:])
            or blk.dtype != ring.dtype or not 0 <= li < ring.shape[0]):
        raise ValueError(
            f"ring_write: block {blk.dtype} {list(blk.shape)} does not fit "
            f"ring {ring.dtype} {list(ring.shape)} at layer {li}")


def write_block_columns_plain(pairs, li: int, positions: torch.Tensor
                              ) -> None:
    """The plain version: a per-row loop of slice assignments."""
    for b, p in enumerate(positions.tolist()):
        for ring, blk in pairs:
            ring[li, b, :, p:p + blk.shape[2]] = blk[b]


def _vector_bytes(col: int, *tensors: torch.Tensor) -> int:
    """The widest store (16, 8, 4, 2 or 1 bytes) that divides a column
    and every base address."""
    w = 16
    while w > 1 and (col % w or any(t.data_ptr() % w for t in tensors)):
        w //= 2
    return w


def write_block_columns_group(pairs, li: int, positions: torch.Tensor
                              ) -> None:
    """Write every (ring [L, B, H, T, *tail], blk [B, H, S, *tail]) pair at
    ring[li, b, :, positions[b]:positions[b] + S] for every row b, in
    place. ``positions`` is int [B] on the rings' device. CUDA tensors
    launch csrc/ring_write.cu once for all pairs; CPU tensors take
    ``write_block_columns_plain``."""
    pairs = [(ring, blk.contiguous()) for ring, blk in pairs]
    ring0, blk0 = pairs[0]
    n_rows, s = blk0.shape[0], blk0.shape[2]
    if not 1 <= len(pairs) <= MAX_PAIRS:
        raise ValueError(f"ring_write: {len(pairs)} pairs (1 to "
                         f"{MAX_PAIRS})")
    for ring, blk in pairs:
        _check_pair(ring, blk, li, n_rows)
        if (blk.shape[2] != s or ring.shape[:3] != ring0.shape[:3]
                or ring.shape[3] != ring0.shape[3]
                or ring.device != ring0.device):
            raise ValueError("ring_write: pairs differ in rows, heads, "
                             "ring length, block length or device")
    if positions.shape != (n_rows,):
        raise ValueError(f"ring_write: positions {list(positions.shape)} "
                         f"for {n_rows} rows")
    dev = ring0.device
    if dev.type == "cpu":
        write_block_columns_plain(pairs, li, positions)
        return
    if dev.type != "cuda":
        raise ValueError(f"ring_write: unsupported device {dev}")
    if not all(ring.is_contiguous() for ring, _ in pairs):
        raise ValueError("ring_write: rings must be contiguous")
    pos = positions.to(device=dev, dtype=torch.int32).contiguous()
    heads, t_ring = ring0.shape[2], ring0.shape[3]
    rings, blks, cols, widths = [], [], [], []
    for ring, blk in pairs:
        col = ring[0, 0, 0, 0].numel() * ring.element_size()
        rings.append(ring.data_ptr())
        blks.append(blk.data_ptr())
        cols.append(col)
        widths.append(_vector_bytes(col, ring, blk))
    pad = MAX_PAIRS - len(pairs)
    rings += [0] * pad
    blks += [0] * pad
    cols += [0] * pad
    widths += [1] * pad
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _build.kernels().lib.cw_ring_write(
            *rings, *blks, *cols, *widths, len(pairs), pos.data_ptr(),
            n_rows, heads, t_ring, s, li, stream)
    _build.check(err, "ring_write")
    write_block_columns_group.launches += 1


write_block_columns_group.launches = 0
