"""PyTorch port: per-row ring writes (ops/ring_write.py) against the JAX
package's write strategies (ops/ring_scatter.py, the Pallas DMA kernel in
interpret mode), and the decoder step at per-row positions
(models/whisper.decode_step_multi / decode_step) against the JAX
functions.

The JAX rings are [L, B, H, Dh, T] with blocks [B, H, Dh, S]; the port's
are [L, B, H, T, Dh] with blocks [B, H, S, Dh] (int4 nibble-packed over
Dh). The same values go into both, and the written rings must be equal
bit for bit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from helpers import rand_mel
from torch_port_fixtures import one_torch_thread  # noqa: F401 (autouse)
from torch_port_fixtures import to_torch

L, H, DH, T = 3, 4, 16, 24


def _draw(rng, kind, shape):
    """Values of a ring or block of ``kind`` as (numpy, JAX dtype)."""
    if kind == "bf16":
        return rng.standard_normal(shape).astype(np.float32), jnp.bfloat16
    if kind == "f32":
        return rng.standard_normal(shape).astype(np.float32), jnp.float32
    qmax = 7 if kind == "int4" else 127
    return (rng.integers(-qmax, qmax + 1, shape).astype(np.int8),
            jnp.int4 if kind == "int4" else jnp.int8)


def _port_values(x: np.ndarray, kind: str) -> torch.Tensor:
    """A JAX-dtype numpy array in the port's layout (Dh last)."""
    from crisperwhisper_tpu_torch.models.whisper import pack_int4
    t = to_torch(x)
    if kind == "int4":
        return pack_int4(t)
    return t


@pytest.mark.parametrize("s,b", [(1, 3), (5, 1), (5, 3)])
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8", "int4"])
def test_plain_write_matches_jax_modes(kind, s, b):
    """The plain version writes the bytes of the JAX "scatter" and "dma"
    strategies (quantized rings with their bf16 scale rings, one grouped
    call; int4 compared unpacked), bit for bit."""
    from crisperwhisper_tpu.ops.ring_scatter import write_block_columns_group \
        as jwrite
    from crisperwhisper_tpu_torch.models.whisper import unpack_int4
    from crisperwhisper_tpu_torch.ops.ring_write import \
        write_block_columns_group
    rng = np.random.default_rng([["bf16", "f32", "int8", "int4"].index(kind),
                                 s, b])
    ring_np, jdt = _draw(rng, kind, (L, b, H, T, DH))
    blk_np, _ = _draw(rng, kind, (b, H, s, DH))
    pos = rng.integers(0, T - s + 1, (b,)).astype(np.int32)
    li = 1
    jpairs = [(jnp.asarray(ring_np, jdt).swapaxes(-1, -2),
               jnp.asarray(blk_np, jdt).swapaxes(-1, -2))]
    quant = kind in ("int8", "int4")
    if quant:
        sr = rng.standard_normal((2, L, b, H, T)).astype(np.float32)
        sb = rng.standard_normal((2, b, H, s)).astype(np.float32)
        jpairs += [(jnp.asarray(sr[i], jnp.bfloat16),
                    jnp.asarray(sb[i], jnp.bfloat16)) for i in range(2)]
    pairs = [(_port_values(np.asarray(r).swapaxes(-1, -2), kind)
              .contiguous(),
              _port_values(np.asarray(k).swapaxes(-1, -2), kind))
             for r, k in jpairs[:1]]
    pairs += [(to_torch(r), to_torch(k)) for r, k in jpairs[1:]]
    ring0 = pairs[0][0].clone()
    write_block_columns_group(pairs, li, torch.from_numpy(pos))
    for mode in ("scatter", "dma"):
        ref = jwrite(jpairs, jnp.int32(li), jnp.asarray(pos), mode=mode)
        got_ring = pairs[0][0]
        if kind == "int4":
            got_ring = unpack_int4(got_ring)
        want = np.asarray(ref[0]).swapaxes(-1, -2)
        if kind == "bf16":
            np.testing.assert_array_equal(
                got_ring.view(torch.int16).numpy(),
                np.asarray(want).view(np.int16))
        else:
            np.testing.assert_array_equal(got_ring.numpy(),
                                          want.astype(got_ring.numpy().dtype))
        for (r, _), w in zip(pairs[1:], ref[1:]):
            np.testing.assert_array_equal(r.view(torch.int16).numpy(),
                                          np.asarray(w).view(np.int16))
    # the plain reference: only row b's slots [pos[b], pos[b] + S) moved
    moved = (pairs[0][0] != ring0).any(-1)[li]                # [B, H, T]
    for row in range(b):
        outside = torch.ones(T, dtype=torch.bool)
        outside[pos[row]:pos[row] + s] = False
        assert not moved[row][:, outside].any()


def test_write_checks_shapes():
    from crisperwhisper_tpu_torch.ops.ring_write import \
        write_block_columns_group
    ring = torch.zeros((L, 2, H, T, DH))
    blk = torch.zeros((2, H, 3, DH))
    with pytest.raises(ValueError):
        write_block_columns_group([(ring, blk[:1])], 0, torch.zeros(2))
    with pytest.raises(ValueError):
        write_block_columns_group([(ring, blk.double())], 0, torch.zeros(2))
    with pytest.raises(ValueError):
        write_block_columns_group([(ring, blk)], L, torch.zeros(2))
    assert write_block_columns_group.launches == 0     # CPU: plain version


# ---------------------------------------------------------------------------
# The launch plan of a set of rings (the CUDA path's host side)
# ---------------------------------------------------------------------------


def _per_call_widths(col, *tensors):
    """The store width that the wrapper computed at every call before it
    kept a plan: the widest of 16, 8, 4, 2, 1 bytes that divides the
    column and every base address."""
    w = 16
    while w > 1 and (col % w or any(t.data_ptr() % w for t in tensors)):
        w //= 2
    return w


def _at_offset(shape, dtype, offset):
    """A contiguous tensor of ``shape`` whose data starts ``offset``
    elements into its storage (0: the allocator's own alignment)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


def _rings(kind, layers, rows, heads, t, dh, offset=0):
    """The rings of one self cache as models/whisper.init_cache lays them
    out: K and V [L, B, H, T, Dh] (packed int4: Dh/2 bytes), and for
    int8 and int4 their bf16 scale rings [L, B, H, T]."""
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32,
             "int8": torch.int8, "int4": torch.uint8}[kind]
    tail = dh // 2 if kind == "int4" else dh
    rings = [_at_offset((layers, rows, heads, t, tail), dtype, offset)
             for _ in range(2)]
    if kind in ("int8", "int4"):
        rings += [_at_offset((layers, rows, heads, t), torch.bfloat16,
                             offset) for _ in range(2)]
    return rings


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("heads,dh", [(4, 16), (20, 64)],
                         ids=["tiny", "large-v3"])
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8", "int4"])
def test_plan_holds_the_per_call_bytes_and_widths(kind, heads, dh, offset):
    """At TINY and large-v3 widths, a plan's column bytes and store widths
    are what the wrapper computed at every call before (a column's bytes
    from ``ring[0, 0, 0, 0]``, the widest store dividing it and the
    addresses), also for rings one element off the allocator's alignment;
    its packed struct holds the rings' addresses and geometry."""
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    rings = _rings(kind, 3, 2, heads, 11, dh, offset)
    plan = rw.ring_plan(rings)
    cols = [r[0, 0, 0, 0].numel() * r.element_size() for r in rings]
    assert list(plan.cols) == cols
    assert list(plan.widths) == [_per_call_widths(c, r)
                                 for c, r in zip(cols, rings)]
    if offset == 0:             # the allocator aligns to at least 16 bytes
        assert plan.widths == tuple(min(16, c) for c in cols)
    blks = [torch.zeros((2, heads, 5) + tuple(r.shape[4:]), dtype=r.dtype)
            for r in rings]
    _, _, widths = plan.call(blks, 0, torch.zeros(2, dtype=torch.int32))
    assert widths == sum(
        _per_call_widths(c, r, b) << (8 * j)
        for j, (c, r, b) in enumerate(zip(cols, rings, blks))) + sum(
        1 << (8 * j) for j in range(len(rings), rw.MAX_PAIRS))
    st = plan.struct
    assert list(st.ring)[:len(rings)] == [r.data_ptr() for r in rings]
    assert list(st.ring)[len(rings):] == [None] * (4 - len(rings))
    assert list(st.col) == cols + [0] * (4 - len(rings))
    assert (st.n_pairs, st.layers, st.rows, st.heads, st.t_ring) == (
        len(rings), 3, 2, heads, 11)


def test_plan_is_kept_per_key_and_a_replaced_ring_gets_its_own():
    """The same rings get the same plan object; a ring replaced by a clone
    gets a new plan with the clone's address, and the old set's plan is
    still the cached one. The cache keeps at most MAX_PLANS keys."""
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    rings = _rings("int8", 2, 3, 4, 9, 16)
    plan = rw.ring_plan(rings)
    assert rw.ring_plan(list(rings)) is plan
    clone = rings[1].clone()
    other = rw.ring_plan([rings[0], clone, *rings[2:]])
    assert other is not plan
    assert other.struct.ring[1] == clone.data_ptr() != plan.struct.ring[1]
    assert other.struct.ring[0] == plan.struct.ring[0]
    assert rw.ring_plan(rings) is plan
    for _ in range(rw.MAX_PLANS + 2):
        rw.ring_plan(_rings("bf16", 1, 1, 2, 4, 8))
    assert rw._plan.cache_info().currsize <= rw.MAX_PLANS


def test_misaligned_block_lowers_the_width_for_that_call_only():
    """A block viewed one element off a 16-byte boundary lowers its own
    pair's store width for the call that passes it; the plan, and the
    next call with aligned blocks, keep the widest."""
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    rings = _rings("int8", 2, 3, 4, 9, 16)
    plan = rw.ring_plan(rings)
    assert plan.widths == (16, 16, 2, 2)
    aligned = [torch.zeros((3, 4, 2) + tuple(r.shape[4:]), dtype=r.dtype)
               for r in rings]
    skew = list(aligned)
    skew[1] = _at_offset(aligned[1].shape, torch.int8, 1)
    skew[2] = _at_offset(aligned[2].shape, torch.bfloat16, 1)
    assert skew[1].data_ptr() % 2 == 1 and skew[2].data_ptr() % 4 == 2
    pos = torch.zeros(3, dtype=torch.int32)
    _, _, widths = plan.call(skew, 0, pos)
    assert [(widths >> (8 * j)) & 0xFF for j in range(4)] == [16, 1, 2, 2]
    assert plan.widths == (16, 16, 2, 2)
    assert plan.call(aligned, 0, pos)[2] == plan.width_code \
        == 16 | 16 << 8 | 2 << 16 | 2 << 24


def test_call_checks_only_blocks_layers_and_positions_against_the_plan():
    """What a call checks against its plan (``RingPlan.call``): each
    block's shape, dtype and device, the layer, and the positions' shape;
    the blocks' addresses and S when all fit."""
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    rings = _rings("int4", 2, 3, 4, 9, 16)
    plan = rw.ring_plan(rings)
    blks = [torch.zeros((3, 4, 2) + tuple(r.shape[4:]), dtype=r.dtype)
            for r in rings]
    pos = torch.zeros(3, dtype=torch.int32)
    want = [b.data_ptr() for b in blks]
    assert plan.call(blks, 1, pos)[:2] == (want, 2)
    assert plan.call(blks, 1, pos.long())[:2] == (want, 2)   # converted
    assert plan.call(blks, 2, pos) is None
    assert plan.call(blks, -1, pos) is None
    assert plan.call(blks, 0, pos[:2]) is None
    for j, bad in ((0, blks[0][:, :, :1]), (1, blks[1].to(torch.int8)),
                   (2, blks[2][:2]), (3, blks[3][..., None])):
        assert plan.call(blks[:j] + [bad] + blks[j + 1:], 0, pos) is None, j


def test_plan_refuses_rings_the_kernel_does_not_take():
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    rings = _rings("bf16", 2, 3, 4, 9, 16)
    with pytest.raises(ValueError, match="rings must be contiguous"):
        rw.ring_plan([rings[0], torch.zeros((2, 3, 4, 9, 32),
                                            dtype=torch.bfloat16)[..., ::2]])
    with pytest.raises(ValueError, match="pairs differ"):
        rw.ring_plan([rings[0], rings[1][:, :2]])
    with pytest.raises(ValueError, match=r"5 pairs \(1 to 4\)"):
        rw.ring_plan(rings * 2 + rings[:1])


def test_plan_struct_matches_the_kernel_source():
    """``PlanStruct`` mirrors csrc/ring_write.cu's ``RingPlan`` field for
    field (name, C type, array length), since nothing here compiles the
    source; and the entry takes the plan, four blocks, the positions, S,
    the layer, the widths and the stream."""
    import ctypes
    import re
    from pathlib import Path
    from crisperwhisper_tpu_torch.ops import ring_write as rw
    src = (Path(rw.__file__).parents[1] / "csrc" / "ring_write.cu"
           ).read_text()
    consts = {n: int(v) for n, v in re.findall(
        r"^constexpr int (k\w+) = (\d+);", src, re.M)}
    assert consts["kMaxPairs"] == rw.MAX_PAIRS
    body = re.search(r"^struct RingPlan \{(.*?)^\};", src, re.M | re.S)[1]
    c_types = {"char*": ctypes.c_void_p, "int": ctypes.c_int}
    fields = []
    for ctype, name, n in re.findall(
            r"^\s*(char\*|int)\s+(\w+)(?:\[(\w+)\])?;", body, re.M):
        t = c_types[ctype]
        fields.append((name, t * consts[n] if n else t))
    assert len(fields) == len(re.findall(r";", body))
    got = [(name, t) for name, t in rw.PlanStruct._fields_]
    assert [n for n, _ in got] == [n for n, _ in fields]
    for (_, want), (_, have) in zip(fields, got):
        assert getattr(have, "_type_", have) is getattr(want, "_type_",
                                                        want)
        assert getattr(have, "_length_", 1) == getattr(want, "_length_", 1)
    entry = re.search(r'extern "C" int cw_ring_write\((.*?)\)', src,
                      re.S)[1]
    params = [" ".join(a.split()) for a in entry.split(",")]
    assert params == ["const RingPlan* plan", "const void* blk0",
                      "const void* blk1", "const void* blk2",
                      "const void* blk3", "const void* pos", "int s",
                      "int layer", "int widths", "void* stream"]


# ---------------------------------------------------------------------------
# The decoder step at per-row positions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    """TINY f32 weights in both packages and encoder states for 3 rows
    (computed by the port, handed to both)."""
    from crisperwhisper_tpu.models import init_params
    from crisperwhisper_tpu_torch.models.loader import params_from_jax
    from crisperwhisper_tpu_torch.models.whisper import encode
    from helpers import tiny_arch
    arch = tiny_arch()
    jp = jax.device_get(init_params(arch, jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, arch)
    enc = encode(tp, arch, torch.from_numpy(rand_mel(batch=3, seed=2))
                 ).numpy()
    return arch, jp, tp, enc


def _caches(arch, jp, tp, enc, quant):
    from crisperwhisper_tpu.models import init_cache as jinit
    from crisperwhisper_tpu_torch.models.whisper import init_cache
    kw = dict(cache_len=24)
    jc = jinit(jp, arch, jnp.asarray(enc), cross_dtype=jnp.int8 if quant
               else None, self_dtype=jnp.int8 if quant else None, **kw)
    pc = init_cache(tp, arch, torch.from_numpy(enc),
                    cross_dtype="int8" if quant else None,
                    self_dtype="int8" if quant else None, **kw)
    return jc, pc


def _assert_rings(jc, pc, quant):
    """Written rings equal: the same slots written (nonzero values, or
    nonzero scales of a quantized ring), float values to f32 rounding,
    int8 values within one step (a value on a rounding boundary), scales
    within one bf16 step."""
    for name in ("self_k", "self_v"):
        want = np.asarray(getattr(jc, name), np.float32).swapaxes(-1, -2)
        got = getattr(pc, name).float().numpy()
        if not quant:
            np.testing.assert_array_equal(got != 0, want != 0)
        np.testing.assert_allclose(got, want, atol=1.0 if quant else 2e-5,
                                   rtol=0)
    if quant:
        for name in ("self_k_scale", "self_v_scale"):
            got = getattr(pc, name).float().numpy()
            want = np.asarray(getattr(jc, name), np.float32)
            np.testing.assert_array_equal(got != 0, want != 0)
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("mode,quant", [("scatter", False), ("dma", True)])
def test_vector_positions_match_jax(tiny_pair, monkeypatch, mode, quant):
    """decode_step_multi (a 4-token block) and then decode_step (one
    token) at per-row positions, float and int8 caches: logits within
    2e-4, alignment rows within 2e-5 (tests/test_model.py bands), rings
    written at the same slots to the same values; the JAX side under each
    of its write strategies (CW_RING_SCATTER)."""
    from crisperwhisper_tpu.models import alignment_selector
    from crisperwhisper_tpu.models import decode_step as jstep
    from crisperwhisper_tpu.models import decode_step_multi as jmulti
    from crisperwhisper_tpu_torch.models.whisper import (decode_step,
                                                         decode_step_multi)
    monkeypatch.setenv("CW_RING_SCATTER", mode)
    arch, jp, tp, enc = tiny_pair
    jc, pc = _caches(arch, jp, tp, enc, quant)
    sel = alignment_selector(arch, ((0, 1), (1, 2)))
    rng = np.random.default_rng(1)
    block = rng.integers(2, 40, (3, 4)).astype(np.int32)
    pos = np.asarray([5, 2, 9], np.int32)
    la, jc, aa = jmulti(jp, arch, jnp.asarray(block), jnp.asarray(pos), jc,
                        align_sel=jnp.asarray(sel))
    lb, pc, ab = decode_step_multi(tp, arch, torch.from_numpy(block),
                                   torch.from_numpy(pos), pc, align_sel=sel)
    np.testing.assert_allclose(lb.numpy(), np.asarray(la), atol=2e-4)
    np.testing.assert_allclose(ab.numpy(), np.asarray(aa), atol=2e-5)
    _assert_rings(jc, pc, quant)
    toks = np.asarray([11, 12, 13], np.int32)
    nxt = pos + 4
    la, jc, aa = jstep(jp, arch, jnp.asarray(toks), jnp.asarray(nxt), jc,
                       align_sel=jnp.asarray(sel))
    lb, pc, ab = decode_step(tp, arch, torch.from_numpy(toks),
                             torch.from_numpy(nxt), pc, align_sel=sel)
    np.testing.assert_allclose(lb.numpy(), np.asarray(la), atol=2e-4)
    np.testing.assert_allclose(ab.numpy(), np.asarray(aa), atol=2e-5)
    _assert_rings(jc, pc, quant)


def test_vector_positions_equal_per_row_scalar_steps(tiny_pair):
    """Row b of a per-row-position step equals the same row decoded alone
    at its scalar position (the live prefix and mask are per row)."""
    from crisperwhisper_tpu_torch.models.whisper import (decode_step_multi,
                                                         init_cache)
    arch, _, tp, enc = tiny_pair
    block = torch.tensor([[3, 4, 5], [6, 7, 8], [9, 10, 11]])
    pos = torch.tensor([4, 0, 7], dtype=torch.int32)
    cache = init_cache(tp, arch, torch.from_numpy(enc), cache_len=16)
    lv, _, _ = decode_step_multi(tp, arch, block, pos, cache)
    for row in range(3):
        one = init_cache(tp, arch, torch.from_numpy(enc[row:row + 1]),
                         cache_len=16)
        with torch.inference_mode():                  # same ring content
            one.self_k[:, 0] = cache.self_k[:, row]
            one.self_v[:, 0] = cache.self_v[:, row]
        lr, _, _ = decode_step_multi(tp, arch, block[row:row + 1],
                                     int(pos[row]), one)
        torch.testing.assert_close(lv[row], lr[0], atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        decode_step_multi(tp, arch, block, torch.tensor([4, 0, 14]), cache)
