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

The kernel takes a few microseconds on the card, so its host path is
lean. What is fixed for a set of rings (addresses, column bytes, widest
stores, rows, heads, ring length) is a ``RingPlan``, checked and packed
for the C entry once per set (``ring_plan``, cached by the rings' key); a
call checks only what can change (the blocks, the layer, the positions)
and launches through ``_build.launcher``, counted in
``write_block_columns_group.launches`` (a call under a CUDA graph's
capture counts the launch it records once, not its replays).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

MAX_PAIRS = 4                    # K, V and their two scale rings
MAX_PLANS = 16                   # ring sets whose plans are kept


class PlanStruct(ctypes.Structure):
    """csrc/ring_write.cu's ``RingPlan``, field for field."""
    _fields_ = [("ring", ctypes.c_void_p * MAX_PAIRS),
                ("col", ctypes.c_int * MAX_PAIRS),
                ("n_pairs", ctypes.c_int),
                ("layers", ctypes.c_int),
                ("rows", ctypes.c_int),
                ("heads", ctypes.c_int),
                ("t_ring", ctypes.c_int)]


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


def _check_pairs(pairs, li: int, positions: torch.Tensor) -> None:
    """Every check of a call, each with its own message."""
    if not 1 <= len(pairs) <= MAX_PAIRS:
        raise ValueError(f"ring_write: {len(pairs)} pairs (1 to "
                         f"{MAX_PAIRS})")
    ring0, blk0 = pairs[0]
    n_rows = blk0.shape[0]
    s = blk0.shape[2] if blk0.dim() > 2 else None
    for ring, blk in pairs:
        _check_pair(ring, blk, li, n_rows)
        if (blk.shape[2] != s or ring.shape[:4] != ring0.shape[:4]
                or ring.device != ring0.device):
            raise _pairs_differ()
    if positions.shape != (n_rows,):
        raise ValueError(f"ring_write: positions {list(positions.shape)} "
                         f"for {n_rows} rows")


def _pairs_differ() -> ValueError:
    return ValueError("ring_write: pairs differ in rows, heads, ring "
                      "length, block length or device")


def write_block_columns_plain(pairs, li: int, positions: torch.Tensor
                              ) -> None:
    """The plain version: a per-row loop of slice assignments."""
    for b, p in enumerate(positions.tolist()):
        for ring, blk in pairs:
            ring[li, b, :, p:p + blk.shape[2]] = blk[b]


def store_width(col: int, *addresses: int) -> int:
    """The widest store (16, 8, 4, 2 or 1 bytes) that divides a column
    and every address."""
    w = 16
    while w > 1 and (col % w or any(a % w for a in addresses)):
        w //= 2
    return w


class RingPlan:
    """What stays fixed for one set of rings [L, B, H, T, *tail] on one
    device: each ring's address, column bytes and widest store, and the
    ring geometry, packed once into ``struct`` for the C entry. Immutable;
    a call's own values (blocks, widths, positions) never go into it, so
    threads may share it."""

    __slots__ = ("device", "layers", "rows", "heads", "t_ring", "dtypes",
                 "tails", "cols", "widths", "width_code", "pos_shape",
                 "rings", "pad", "struct", "address", "_shapes")

    def __init__(self, key) -> None:
        if not 1 <= len(key) <= MAX_PAIRS:
            raise ValueError(f"ring_write: {len(key)} pairs (1 to "
                             f"{MAX_PAIRS})")
        _, shape0, _, _, dev = key[0]
        for _, shape, _, contiguous, device in key:
            if len(shape) < 4 or shape[:4] != shape0[:4] or device != dev:
                raise _pairs_differ()
            if not contiguous:
                raise ValueError("ring_write: rings must be contiguous")
        self.device = dev
        self.layers, self.rows, self.heads, self.t_ring = shape0[:4]
        self.dtypes = tuple(dtype for _, _, dtype, _, _ in key)
        self.tails = tuple(tuple(shape[4:]) for _, shape, _, _, _ in key)
        self.cols = tuple(
            functools.reduce(int.__mul__, tail, 1) * dtype.itemsize
            for tail, dtype in zip(self.tails, self.dtypes))
        self.widths = tuple(store_width(col, ptr)
                            for col, (ptr, *_) in zip(self.cols, key))
        self.width_code = _width_code(self.widths)
        self.pos_shape = torch.Size((self.rows,))
        self.rings = [ptr for ptr, *_ in key]           # their addresses
        self.pad = (None,) * (MAX_PAIRS - len(key))   # absent blocks
        self.struct = PlanStruct(
            (ctypes.c_void_p * MAX_PAIRS)(*self.rings, *self.pad),
            (ctypes.c_int * MAX_PAIRS)(*self.cols,
                                       *[0] * len(self.pad)),
            len(key), self.layers, self.rows, self.heads, self.t_ring)
        self.address = ctypes.addressof(self.struct)
        self._shapes: dict[int, tuple[torch.Size, ...]] = {}

    def block_shapes(self, s: int) -> tuple[torch.Size, ...]:
        """The block shapes [B, H, s, *tail] that fit the rings."""
        shapes = self._shapes.get(s)
        if shapes is None:
            shapes = tuple(torch.Size((self.rows, self.heads, s) + tail)
                           for tail in self.tails)
            self._shapes[s] = shapes
        return shapes

    def call(self, blks, li: int, positions: torch.Tensor
             ) -> tuple[list[int], int, int] | None:
        """(the blocks' addresses, S, the packed store widths) of a call
        whose blocks (shape, dtype, device), layer and positions' shape
        fit the plan; else None."""
        shape0 = blks[0].shape
        if (len(shape0) != 3 + len(self.tails[0])
                or not 0 <= li < self.layers
                or positions.shape != self.pos_shape):
            return None
        s = shape0[2]
        ptrs, low = [], 0
        for blk, shape, dtype in zip(blks, self.block_shapes(s),
                                     self.dtypes):
            if (blk.shape != shape or blk.dtype is not dtype
                    or blk.get_device() != self.device):
                return None
            ptr = blk.data_ptr()
            ptrs.append(ptr)
            low |= ptr
        return ptrs, s, (self.width_code if not low % 16
                         else self.call_widths(ptrs))

    def call_widths(self, addresses) -> int:
        """The packed store widths of one call (``width_code``): the
        plan's, each lowered to the alignment of its block's address."""
        return _width_code([store_width(w, a)
                            for w, a in zip(self.widths, addresses)])


def _width_code(widths) -> int:
    """Byte j holds pair j's store width (csrc/ring_write.cu's
    ``widths``); absent pairs take 1."""
    widths = list(widths) + [1] * (MAX_PAIRS - len(widths))
    return sum(w << (8 * j) for j, w in enumerate(widths))


def ring_plan(rings) -> RingPlan:
    """The plan of these rings, built at the first call for their key
    (each ring's address, shape, dtype, contiguity and device; a
    contiguous ring's strides follow from its shape) and kept for the
    last ``MAX_PLANS`` keys. A plan is a function of its key alone and
    holds no tensor, so a freed ring whose address an identical ring
    reuses gets an identical plan, and a replaced ring a new one."""
    return _plan(tuple([(r.data_ptr(), r.shape, r.dtype, r.is_contiguous(),
                         r.get_device()) for r in rings]))


@functools.lru_cache(maxsize=MAX_PLANS)
def _plan(key) -> RingPlan:
    return RingPlan(key)


def write_block_columns_group(pairs, li: int, positions: torch.Tensor,
                              plan: RingPlan | None = None) -> None:
    """Write every (ring [L, B, H, T, *tail], blk [B, H, S, *tail]) pair at
    ring[li, b, :, positions[b]:positions[b] + S] for every row b, in
    place. ``positions`` is int [B]; device int32 positions (what
    models/whisper.py passes) are taken as they are. CUDA tensors launch
    csrc/ring_write.cu once for all pairs; CPU tensors take
    ``write_block_columns_plain``. ``plan`` is ``ring_plan`` of these
    rings, for a caller that writes them many times (models/whisper.py
    looks it up once a decode block, not once a layer); without it, or
    when its addresses are not these rings', the call looks it up."""
    ring0 = pairs[0][0]
    if not ring0.is_cuda:
        _check_pairs(pairs, li, positions)
        if ring0.device.type != "cpu":
            raise ValueError(f"ring_write: unsupported device "
                             f"{ring0.device}")
        write_block_columns_plain([(ring, blk.contiguous())
                                   for ring, blk in pairs], li, positions)
        return
    if plan is None or [ring.data_ptr() for ring, _ in pairs] != plan.rings:
        try:
            plan = ring_plan([ring for ring, _ in pairs])
        except ValueError:
            _check_pairs(pairs, li, positions)   # a call's error comes first
            raise
    blks = [blk if blk.is_contiguous() else blk.contiguous()
            for _, blk in pairs]
    call = plan.call(blks, li, positions)
    if call is None:
        _check_pairs(pairs, li, positions)
        raise ValueError(f"ring_write: blocks must lie on the rings' "
                         f"device {ring0.device}")
    ptrs, s, widths = call
    if (positions.dtype is not torch.int32 or not positions.is_contiguous()
            or positions.get_device() != plan.device):
        positions = positions.to(device=ring0.device, dtype=torch.int32
                                 ).contiguous()
    _build.launcher("cw_ring_write")(plan.device, plan.address, *ptrs,
                                     *plan.pad, positions.data_ptr(), s, li,
                                     widths)
    write_block_columns_group.launches += 1


write_block_columns_group.launches = 0
